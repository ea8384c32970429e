// Hopper (sm_90a) kernel of the full-graph GAT aggregation: each destination
// row's edge softmax over its in-edges and its self-loop, per head, and the
// weighted sum of the source rows, in one pass over the row's edges.
// Built by nvcc into a shared library with a plain C interface and loaded
// through ctypes (falcon_ttdforgnns_torch/ops/_build.py); the Python
// wrapper and its plain version live in ops/attention.py.
//
// No TPU kernel is replaced: the JAX package has no neighbour-sampled GAT,
// and its full-graph GAT leaves the edge softmax to XLA's scatters.  The
// port's GATConv (nn/layers.py) takes it as a scatter max, an exp, a
// scatter sum over (E, H) f32 and then headed_spmm's (chunk, H, C) f32
// message slabs through atomics: 3-5x the compulsory row gathers at
// ogbn-products.
//
// csr_gat_bf16 (models/gat_ns.py forward_full_graph, one call a layer):
//   x (n_x, H * Cp) bf16, el (n_x, H) f32, er (N, H) f32, src (E,) int64
//   grouped by destination row, indptr (N + 1,) int64 ->
//   out (N, H * Cp) bf16 (the heads side by side), or with `mean` the head
//   mean (N, Cp) bf16.  For row v and head h, over its self-loop (source v,
//   first) and its in-edges e = indptr[v] .. indptr[v + 1] - 1 in order
//   (source u = src[e]):
//     s = leaky_relu(el[u, h] + er[v, h], 0.2),
//     alpha = exp(s - max s) / sum exp(s - max s),
//     out[v, h] = sum alpha x[u, h]  (f32, rounded to bf16 once).
//   A row without in-edges gets its self-loop alone: out[v, h] = x[v, h].
//   The softmax is online: a running max m, a running sum and a running
//   weighted sum in f32, both rescaled by exp(m - s) when an edge raises
//   the max, so each source row is read once.  Each row sums in its own
//   order, so the result is not bit-identical to the plain version (its
//   scatters add the edges in another grouping).
// csr_gat_f32: the same over f32 x and out.
//
// Bound on H100: operations.  A layer reads x's rows once each (2 N D bytes
// in bf16, D = H * Cp), el and er (8 N H), src (8 E) and indptr
// (8 (N + 1)) and writes the result (2 N D, or 2 N Cp with the mean); it
// does 2 (E + N) D multiply-adds in f32.  At ogbn-products (2,449,029 rows,
// 122,449,596 edges, H = 4) and C = 128: 6.1 GB, 1.82 ms at 3.35 TB/s,
// against 127.9 GFLOP, 1.91 ms at 67 TFLOP/s; the last layer (C = 47):
// 0.70 ms of operations.  The gathers read one 1 KB row per edge (125 GB a
// hidden layer, 46 GB the last), random rows of a 2.5 GB table that no L2
// holds, so the practical floor is that traffic at the rate the CSR means
// reach (~2.9 TB/s, ~43 ms a hidden layer).
// Design: one warp per destination row, rows striding over a grid of the
// blocks that stay resident (the occupancy query).  A row of D values is
// G = D / V groups of 16 bytes (V = 8 bf16 or 4 f32 values); lane l holds
// groups l, l + 32, ... (NCH of them), each inside one head since
// Cp % V == 0, so a gathered row is one coalesced sweep of the warp.  The
// lanes of a head repeat its softmax scalars; an edge's el[u, h] are
// H adjacent floats, one 16-byte sector the warp's loads share.  A lane
// loads kAhead edges' src, el and rows before it folds any in, so kAhead
// gathers a lane stay in flight (random reads bound by HBM latency need
// bytes in flight), then folds them in edge order.  With `mean` each
// warp writes its normalised heads to shared memory and sums them there.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_info.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;
constexpr float kSlope = 0.2f;  // leaky_relu's negative slope on the scores

// 16 bytes of T as floats, and back.
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void load(const uint4& raw, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    uint4 raw;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return raw;
  }
  __device__ __forceinline__ static __nv_bfloat16 one(float f) { return __float2bfloat16_rn(f); }
};

template <>
struct Pack<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const uint4& raw, float* f) {
    const float* p = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = p[i];
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    uint4 raw;
    float* p = reinterpret_cast<float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = f[i];
    return raw;
  }
  __device__ __forceinline__ static float one(float f) { return f; }
};

__device__ __forceinline__ float leaky(float t) { return t > 0.f ? t : kSlope * t; }

// Fold one source row's group into a head's running softmax: the max m,
// the sum of exp(s - m) and the weighted sum acc, all in f32.
template <int V>
__device__ __forceinline__ void fold(float& m, float& sum, float* acc, float s,
                                     const float* xv) {
  if (s > m) {
    const float c = expf(m - s);
    sum = sum * c + 1.f;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = acc[i] * c + xv[i];
    m = s;
  } else {
    const float p = expf(s - m);
    sum += p;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += p * xv[i];
  }
}

// One warp per row; lane l holds groups l + 32 k, k < NCH, of the row's
// G = H * Cp / V groups.
template <typename T, int NCH, bool MEAN>
__device__ __forceinline__ void gat_rows(const uint4* __restrict__ x,
                                         const float* __restrict__ el,
                                         const float* __restrict__ er,
                                         const long long* __restrict__ src,
                                         const long long* __restrict__ indptr, long long n,
                                         int heads, int cp, T* __restrict__ out) {
  constexpr int V = Pack<T>::V;
  extern __shared__ float smem[];  // MEAN: a warp's normalised heads, H * Cp floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = heads * cp / V;
  int head[NCH];
  bool live[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int g = lane + 32 * k;
    live[k] = g < groups;
    head[k] = live[k] ? g * V / cp : 0;
  }
  for (long long v = (long long)blockIdx.x * kWarps + warp; v < n;
       v += (long long)gridDim.x * kWarps) {
    float er_v[NCH], m[NCH], sum[NCH], acc[NCH][V];
    // the self-loop opens each head's softmax: m = s, sum = 1, acc = x[v]
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      er_v[k] = live[k] ? er[v * heads + head[k]] : 0.f;
      m[k] = leaky((live[k] ? el[v * heads + head[k]] : 0.f) + er_v[k]);
      sum[k] = 1.f;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (live[k]) raw = x[v * groups + lane + 32 * k];
      Pack<T>::load(raw, acc[k]);
    }
    const long long hi = indptr[v + 1];
    long long e = indptr[v];
    for (; e + kAhead <= hi; e += kAhead) {
      uint4 raw[kAhead][NCH];
      float s[kAhead][NCH];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const long long u = src[e + j];
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          raw[j][k] = live[k] ? x[u * groups + lane + 32 * k] : make_uint4(0, 0, 0, 0);
          s[j][k] = live[k] ? el[u * heads + head[k]] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          float xv[V];
          Pack<T>::load(raw[j][k], xv);
          fold<V>(m[k], sum[k], acc[k], leaky(s[j][k] + er_v[k]), xv);
        }
      }
    }
    for (; e < hi; ++e) {
      const long long u = src[e];
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if (!live[k]) continue;
        float xv[V];
        Pack<T>::load(x[u * groups + lane + 32 * k], xv);
        fold<V>(m[k], sum[k], acc[k], leaky(el[u * heads + head[k]] + er_v[k]), xv);
      }
    }
    if (!MEAN) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if (!live[k]) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[k][i] = acc[k][i] / sum[k];
        reinterpret_cast<uint4*>(out)[v * groups + lane + 32 * k] = Pack<T>::store(acc[k]);
      }
    } else {
      float* buf = smem + warp * heads * cp;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if (!live[k]) continue;
        const int g = lane + 32 * k;
#pragma unroll
        for (int i = 0; i < V; ++i) buf[g * V + i] = acc[k][i] / sum[k];
      }
      __syncwarp();
      const float hd = static_cast<float>(heads);
      for (int c = lane; c < cp; c += 32) {
        float t = 0.f;
        for (int h = 0; h < heads; ++h) t += buf[h * cp + c];
        out[v * cp + c] = Pack<T>::one(t / hd);
      }
      __syncwarp();
    }
  }
}

// The kernels the profiler names: csr_gat_bf16_rows<NCH, MEAN> and
// csr_gat_f32_rows<NCH, MEAN>.
template <int NCH, bool MEAN>
__global__ void __launch_bounds__(kThreads) csr_gat_bf16_rows(
    const uint4* __restrict__ x, const float* __restrict__ el, const float* __restrict__ er,
    const long long* __restrict__ src, const long long* __restrict__ indptr, long long n,
    int heads, int cp, __nv_bfloat16* __restrict__ out) {
  gat_rows<__nv_bfloat16, NCH, MEAN>(x, el, er, src, indptr, n, heads, cp, out);
}

template <int NCH, bool MEAN>
__global__ void __launch_bounds__(kThreads) csr_gat_f32_rows(
    const uint4* __restrict__ x, const float* __restrict__ el, const float* __restrict__ er,
    const long long* __restrict__ src, const long long* __restrict__ indptr, long long n,
    int heads, int cp, float* __restrict__ out) {
  gat_rows<float, NCH, MEAN>(x, el, er, src, indptr, n, heads, cp, out);
}

// Blocks of kThreads for `rows` rows, a warp each, whose warps stride over
// the rows: as many as stay resident at once on the card with `smem` bytes
// of shared memory a block (the occupancy query, asked once a kernel and
// size; 2 an SM where it cannot say), no more than the rows need.
template <auto kernel>
int grid_resident(long long rows, int smem) {
  static int per_sm = 0, asked = -1;
  if (asked != smem) {
    int b = 0;
    per_sm = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads, smem) ==
                     cudaSuccess && b > 0 ? b : 2;
    asked = smem;
  }
  const long long need = (rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(per_sm) * sm_count();
  return static_cast<int>(need < cap ? need : cap);
}

// The launch of kernel K<nch, MEAN> (nch = 1, 2 or 4 groups a lane).
template <typename T, template <int, bool> class K, bool MEAN>
int launch(int nch, const void* x, const void* el, const void* er, const void* src,
           const void* indptr, long long n, int heads, int cp, int smem, void* out,
           cudaStream_t st) {
  const auto kernel = nch == 1 ? K<1, MEAN>::fn : nch == 2 ? K<2, MEAN>::fn : K<4, MEAN>::fn;
  const int grid = nch == 1   ? grid_resident<K<1, MEAN>::fn>(n, smem)
                   : nch == 2 ? grid_resident<K<2, MEAN>::fn>(n, smem)
                              : grid_resident<K<4, MEAN>::fn>(n, smem);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint4*>(x), static_cast<const float*>(el),
      static_cast<const float*>(er), static_cast<const long long*>(src),
      static_cast<const long long*>(indptr), n, heads, cp, static_cast<T*>(out));
  return cudaGetLastError();
}

// The launcher of one element type: checks the layout it takes, then picks
// the instantiation of the lanes' group count and the head mean.
template <typename T, template <int, bool> class K>
int csr_gat(const void* x, const void* el, const void* er, const void* src, const void* indptr,
            long long n, int heads, int cp, int mean, void* out, void* stream) {
  constexpr int V = Pack<T>::V;
  if (n < 0 || heads <= 0 || cp <= 0 || cp % V != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  const int groups = heads * cp / V;
  if (groups > 128) return cudaErrorInvalidValue;  // NCH <= 4
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = groups <= 32 ? 1 : groups <= 64 ? 2 : 4;
  if (!mean) return launch<T, K, false>(nch, x, el, er, src, indptr, n, heads, cp, 0, out, st);
  const int smem = kWarps * heads * cp * static_cast<int>(sizeof(float));
  return launch<T, K, true>(nch, x, el, er, src, indptr, n, heads, cp, smem, out, st);
}

template <int NCH, bool MEAN>
struct Bf16Rows {
  static constexpr auto fn = csr_gat_bf16_rows<NCH, MEAN>;
};

template <int NCH, bool MEAN>
struct F32Rows {
  static constexpr auto fn = csr_gat_f32_rows<NCH, MEAN>;
};

}  // namespace

extern "C" {

const char* attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n_x, heads * cp) bf16 contiguous and 16-byte aligned, el (n_x, heads)
// f32, er (n, heads) f32, src (E,) int64 in row order, indptr (n + 1,) int64
// -> out (n, heads * cp) bf16, or (n, cp) with `mean`; cp % 8 == 0.  The
// caller checks that src and indptr index inside x and src, and n <= n_x.
int csr_gat_bf16(const void* x, const void* el, const void* er, const void* src,
                 const void* indptr, long long n, int heads, int cp, int mean, void* out,
                 void* stream) {
  return csr_gat<__nv_bfloat16, Bf16Rows>(x, el, er, src, indptr, n, heads, cp, mean, out,
                                          stream);
}

// The same over f32 x and out; cp % 4 == 0.
int csr_gat_f32(const void* x, const void* el, const void* er, const void* src,
                const void* indptr, long long n, int heads, int cp, int mean, void* out,
                void* stream) {
  return csr_gat<float, F32Rows>(x, el, er, src, indptr, n, heads, cp, mean, out, stream);
}

}  // extern "C"
