// Hopper (sm_90a) kernels of the means: the SAGE conv tower's bf16 fan-out
// mean and its backward, and the full-graph means over each row's in-edges,
// bf16 and f32, and the bf16 mean of a narrow product summed in f32.
// Built by nvcc into a shared library with a plain C interface and loaded
// through ctypes (falcon_ttdforgnns_torch/ops/_build.py); the Python
// wrappers live in ops/tower.py and ops/segment.py next to their plain
// versions.
//
// No TPU kernel is replaced: the JAX package takes these means as XLA
// reductions, and XLA rounds every partial sum of a bf16 reduction to bf16.
// PyTorch's bf16 mean and index_add_ accumulate in f32 and round once,
// which differs in about half the outputs; these kernels give the
// reference's bits in one launch each.  The f32 full-graph mean has no
// such rounding to keep: its kernel reads each row's in-edges where they
// lie instead of materialising the chunked scatter's messages.
//
// fanout_mean_bf16 (jnp.mean(axis=2, dtype=bfloat16) in models/sage.py):
//   x (rows, f, d) bf16 -> out (rows, d) bf16,
//   acc = x[:, 0]; acc = rn_bf16(acc + x[:, j]) for j = 1..f-1 (the sum of
//   two bf16 values is exact in f32 up to the one rounding, as in XLA's
//   upcast add); out = rn_bf16(acc / f) with IEEE f32 division; the
//   sampled tower's XLA reduction sums the f slices left to right, and
//   a loop of torch adds would take f launches a level (44 a flagship
//   step over its six means).
// fanout_mean_bf16_bwd: g (rows, d) bf16 -> dx (rows, f, d) bf16,
//   dx[:, j] = rn_bf16(g / f), the gradient of sum / f.
// Bound on H100: bytes (each input read once, each output written once,
//   1 add a read value); the flagship's largest level reads (1024 * 150,
//   5, 100) bf16, 153.6 MB, 0.046 ms at 3.35 TB/s; its six means a step
//   move 325 MB, 0.097 ms.  Design: one thread per
//   (row, 2c, 2c + 1) pair of the (rows, d) side where d is even (bf16x2
//   loads and stores, 4 bytes a lane, so a warp covers 128 contiguous
//   bytes of one slice per j; the f slices of a row lie d apart), else one
//   thread per value; the thread walks the f slices (summing them forward,
//   writing them backward); a 1-D grid strides over the pairs.
//
// segment_mean_bf16 (ops/segment.py:spmm_mean of the JAX package under
//   bf16, the full-graph mean of evaluate and layer-wise inference: XLA's
//   segment_sum adds each row's messages in edge order, a bf16 rounding
//   after every add, then divides by the in-degree cast to bf16):
//   h (n_h, d) bf16, src (E,) int64 grouped by destination row, indptr
//   (N + 1,) int64, deg (N,) f32 -> out (N, d) bf16,
//   acc = +0; acc = rn_bf16(acc + h[src[e]]) for e = indptr[v] ..
//   indptr[v + 1] - 1; out[v] = rn_bf16(acc / max(rn_bf16(deg[v]), 1)).
//   It reads the rows of h where the edges point, so no (E, d) messages
//   exist.  Bound on H100: bytes, h, the output, src, indptr and deg once
//   each: at ogbn-products (2,449,029 rows, 122,449,596 edges) and d = 256
//   about 3.5 GB, 1.05 ms at 3.35 TB/s; the gathers read each h row once
//   per out-edge (63 GB at d = 256), mostly from L2 and HBM.  Design: the
//   fan-out mean's, one thread per (row, column pair) on a 1-D grid, so
//   the threads of one row read one gathered h row coalesced (the row's
//   src[e] a broadcast); each thread walks its row's edges in order.
//
// csr_mean_f32 (ops/segment.py:spmm_mean of an f32 h that needs no
//   gradient: layer 1 of a bf16 evaluate, where the lookup's rows are f32,
//   and every layer of an f32 one; the JAX package's f32 spmm_mean, an XLA
//   gather and scatter-add):
//   h (n_h, d) f32, src (E,) int64 grouped by destination row, indptr
//   (N + 1,) int64, deg (N,) f32 -> out (N, d) f32,
//   acc = +0; acc = acc + h[src[e]] for e = indptr[v] .. indptr[v + 1] - 1
//   in that order; out[v] = acc / max(deg[v], 1) (IEEE division: the
//   build has no fast math).  The sum of the chunked index_add_ it
//   replaces, each row's in edge order where the atomic scatter has none,
//   so it equals an index_add_ on the CPU bit for bit.  The two full-graph
//   means round differently, so each dtype has its kernel, not one kernel
//   with a mode.
// Bound on H100: bytes, h and the output (4 n d each), src (8 E), indptr
//   (8 (N + 1)) and deg (4 N) once each: at ogbn-products and d = 100
//   about 2.97 GB, 0.886 ms at 3.35 TB/s.  The gathers read one 400 B h
//   row per edge, 49 GB of random rows in a 980 MB table that no L2 holds,
//   so the practical floor is that traffic at the rate segment_mean_bf16
//   reaches (~2.8 TB/s, ~17.5 ms).  Design: one thread per (row, 16-byte
//   column group) on a 1-D grid where d % 4 == 0 and h and out are 16-byte
//   aligned (d = 100 is 25 float4 groups, so the lanes of one row read a
//   gathered 400 B row in one coalesced sweep, and every lane of a warp is
//   busy: a row's groups run on into the next row's), else one thread per
//   value.  The threads of a row read the same src[e], one transaction a
//   warp.  A thread loads the h rows of kAhead edges before it adds any, so
//   each thread keeps kAhead independent gathers in flight (random reads
//   bound by HBM latency need bytes in flight), then adds them in edge
//   order.  The grid is as many blocks as stay resident (the occupancy
//   query), each striding over the work, so no second wave of blocks
//   starts late.
//
// csr_mean_bf16 (FullGraph.projected_mean of a bf16 p: the mean of a
//   narrowing SAGE conv's neighbour product, which the evaluate takes after
//   the product, not before it; no reference op: the JAX package takes the
//   mean first, in bf16):
//   p (n_p, d) bf16, d % 8 == 0, src (E,) int64 grouped by destination
//   row, indptr (N + 1,) int64, deg (N,) f32 -> out (N, d) bf16,
//   acc = +0; acc = acc + f32(p[src[e]]) in f32 for e = indptr[v] ..
//   indptr[v + 1] - 1 in that order; out[v] = rn_bf16(acc / max(deg[v], 1))
//   (IEEE division).  The bf16 mean of segment_mean_bf16 rounds after every
//   add, which on rows of mixed signs (a product's) loses what a sum of
//   ~50 terms keeps in f32, so this sum rounds once, at the end.
// Bound on H100: bytes, p and the output (2 n d each), src (8 E), indptr
//   (8 (N + 1)) and deg (4 N) once each: at ogbn-products and d = 48 (47
//   classes padded) about 1.49 GB, 0.445 ms at 3.35 TB/s.  The gathers read
//   one 96 B row per edge, 11.8 GB of random rows in a 235 MB table, on top
//   of the 0.98 GB of src.  Design: csr_mean_f32's, for 16-byte groups of
//   8 bf16: one thread per (row, group) on a 1-D grid (d = 48 is 6 groups,
//   so a warp covers 5 1/3 rows and every lane is busy), 8 gathers in
//   flight a thread before it adds, a row's last ones predicated so that
//   its tail keeps them in flight too, a resident grid striding over the
//   work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_info.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads) fanout_mean_pairs(
    const __nv_bfloat162* __restrict__ x, long long pairs, int half_d, int f,
    __nv_bfloat162* __restrict__ out) {
  const float fd = static_cast<float>(f);
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < pairs;
       o += (long long)gridDim.x * kThreads) {
    const long long row = o / half_d;
    const int c = static_cast<int>(o - row * half_d);
    const __nv_bfloat162* p = x + row * f * half_d + c;
    float2 acc = __bfloat1622float2(p[0]);
    for (int j = 1; j < f; ++j) {
      const float2 v = __bfloat1622float2(p[(long long)j * half_d]);
      acc.x = round_bf16(acc.x + v.x);
      acc.y = round_bf16(acc.y + v.y);
    }
    out[o] = __floats2bfloat162_rn(acc.x / fd, acc.y / fd);
  }
}

__global__ void __launch_bounds__(kThreads) fanout_mean_scalar(
    const __nv_bfloat16* __restrict__ x, long long n_out, int d, int f,
    __nv_bfloat16* __restrict__ out) {
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < n_out;
       o += (long long)gridDim.x * kThreads) {
    const long long row = o / d;
    const int c = static_cast<int>(o - row * d);
    const __nv_bfloat16* p = x + row * f * d + c;
    float acc = __bfloat162float(p[0]);
    for (int j = 1; j < f; ++j) acc = round_bf16(acc + __bfloat162float(p[(long long)j * d]));
    out[o] = __float2bfloat16_rn(acc / static_cast<float>(f));
  }
}

// dx (rows, f, d) from g (rows, d): a thread per value (or bf16x2 pair,
// where d is even) of g, which it reads once and writes to its f slices,
// each slice's writes coalesced across the warp.
__global__ void __launch_bounds__(kThreads) fanout_mean_bwd_pairs(
    const __nv_bfloat162* __restrict__ g, long long pairs, int half_d, int f,
    __nv_bfloat162* __restrict__ dx) {
  const float fd = static_cast<float>(f);
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < pairs;
       o += (long long)gridDim.x * kThreads) {
    const long long row = o / half_d;
    const int c = static_cast<int>(o - row * half_d);
    const float2 v = __bfloat1622float2(g[o]);
    const __nv_bfloat162 q = __floats2bfloat162_rn(v.x / fd, v.y / fd);
    __nv_bfloat162* p = dx + row * f * half_d + c;
    for (int j = 0; j < f; ++j) p[(long long)j * half_d] = q;
  }
}

__global__ void __launch_bounds__(kThreads) fanout_mean_bwd_scalar(
    const __nv_bfloat16* __restrict__ g, long long n_in, int d, int f,
    __nv_bfloat16* __restrict__ dx) {
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < n_in;
       o += (long long)gridDim.x * kThreads) {
    const long long row = o / d;
    const int c = static_cast<int>(o - row * d);
    const __nv_bfloat16 q = __float2bfloat16_rn(__bfloat162float(g[o]) / static_cast<float>(f));
    __nv_bfloat16* p = dx + row * f * d + c;
    for (int j = 0; j < f; ++j) p[(long long)j * d] = q;
  }
}

// out (N, d) from h, walking each row's in-edges: a thread per (row, column
// pair) where d is even, else per value.
__global__ void __launch_bounds__(kThreads) segment_mean_pairs(
    const __nv_bfloat162* __restrict__ h, const long long* __restrict__ src,
    const long long* __restrict__ indptr, const float* __restrict__ deg, long long pairs,
    int half_d, __nv_bfloat162* __restrict__ out) {
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < pairs;
       o += (long long)gridDim.x * kThreads) {
    const long long v = o / half_d;
    const int c = static_cast<int>(o - v * half_d);
    const long long hi = indptr[v + 1];
    float2 acc = make_float2(0.f, 0.f);
    for (long long e = indptr[v]; e < hi; ++e) {
      const float2 x = __bfloat1622float2(h[src[e] * half_d + c]);
      acc.x = round_bf16(acc.x + x.x);
      acc.y = round_bf16(acc.y + x.y);
    }
    const float den = fmaxf(round_bf16(deg[v]), 1.f);
    out[o] = __floats2bfloat162_rn(acc.x / den, acc.y / den);
  }
}

__global__ void __launch_bounds__(kThreads) segment_mean_scalar(
    const __nv_bfloat16* __restrict__ h, const long long* __restrict__ src,
    const long long* __restrict__ indptr, const float* __restrict__ deg, long long n_out,
    int d, __nv_bfloat16* __restrict__ out) {
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < n_out;
       o += (long long)gridDim.x * kThreads) {
    const long long v = o / d;
    const int c = static_cast<int>(o - v * d);
    const long long hi = indptr[v + 1];
    float acc = 0.f;
    for (long long e = indptr[v]; e < hi; ++e)
      acc = round_bf16(acc + __bfloat162float(h[src[e] * d + c]));
    out[o] = __float2bfloat16_rn(acc / fmaxf(round_bf16(deg[v]), 1.f));
  }
}

// out (N, d) from f32 h, walking each row's in-edges kAhead at a time: a
// thread per (row, float4 group) with V = float4 (q = d / 4 groups a row),
// else per value with V = float (q = d).
constexpr int kAhead = 4;

__device__ __forceinline__ void add_in(float& acc, float x) { acc = acc + x; }

__device__ __forceinline__ void add_in(float4& acc, const float4& x) {
  acc.x = acc.x + x.x;
  acc.y = acc.y + x.y;
  acc.z = acc.z + x.z;
  acc.w = acc.w + x.w;
}

__device__ __forceinline__ float div_by(float acc, float den) { return acc / den; }

__device__ __forceinline__ float4 div_by(const float4& acc, float den) {
  return make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
}

template <typename V>
__global__ void __launch_bounds__(kThreads) csr_mean_f32_rows(
    const V* __restrict__ h, const long long* __restrict__ src,
    const long long* __restrict__ indptr, const float* __restrict__ deg, long long n_out,
    int q, V* __restrict__ out) {
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < n_out;
       o += (long long)gridDim.x * kThreads) {
    const long long v = o / q;
    const int c = static_cast<int>(o - v * q);
    const long long hi = indptr[v + 1];
    long long e = indptr[v];
    V acc{};  // +0 in every lane
    for (; e + kAhead <= hi; e += kAhead) {
      V x[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) x[k] = h[src[e + k] * q + c];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) add_in(acc, x[k]);
    }
    for (; e < hi; ++e) add_in(acc, h[src[e] * q + c]);
    out[o] = div_by(acc, fmaxf(deg[v], 1.f));
  }
}

// out (N, 8 q) bf16 from bf16 p, walking each row's in-edges kAheadNarrow
// at a time, the last loads of a row predicated: a thread per (row, 16-byte
// group of 8 values), summing in f32.  Edges in flight a thread, timed at
// ogbn-products and d = 48 on an H100 80GB HBM3 at 700 W: 4 6.71 ms, 8
// 6.44, 16 7.75 (6.48 with 8 and a row's tail one edge at a time).
constexpr int kAheadNarrow = 8;

__device__ __forceinline__ void add_in(float (&acc)[8], const uint4& x) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(v[k]);
    acc[2 * k] = acc[2 * k] + f.x;
    acc[2 * k + 1] = acc[2 * k + 1] + f.y;
  }
}

__global__ void __launch_bounds__(kThreads) csr_mean_bf16_rows(
    const uint4* __restrict__ p, const long long* __restrict__ src,
    const long long* __restrict__ indptr, const float* __restrict__ deg, long long n_out,
    int q, uint4* __restrict__ out) {
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < n_out;
       o += (long long)gridDim.x * kThreads) {
    const long long v = o / q;
    const int c = static_cast<int>(o - v * q);
    const long long hi = indptr[v + 1];
    long long e = indptr[v];
    float acc[8] = {};  // +0 in every lane
    for (; e < hi; e += kAheadNarrow) {
      uint4 x[kAheadNarrow];
#pragma unroll
      for (int k = 0; k < kAheadNarrow; ++k)
        if (e + k < hi) x[k] = p[src[e + k] * q + c];
#pragma unroll
      for (int k = 0; k < kAheadNarrow; ++k)
        if (e + k < hi) add_in(acc, x[k]);
    }
    const float den = fmaxf(deg[v], 1.f);
    uint4 r;
    __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = __floats2bfloat162_rn(acc[2 * k] / den, acc[2 * k + 1] / den);
    out[o] = r;
  }
}

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Blocks of kThreads for `work` items of `kernel`, whose threads stride
// over the work: as many as stay resident at once on the card (the
// occupancy query, asked once a kernel; 8 an SM, 2048 threads, where it
// cannot say), no more than the work needs.  A kernel of more than 32
// registers a thread fits fewer than 8 blocks an SM, and a grid of 8 an SM
// would leave its last blocks to a second wave on a few SMs.
template <auto kernel>
int grid_resident(long long work) {
  static const int per_sm = [] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) ==
                   cudaSuccess && n > 0 ? n : 8;
  }();
  const long long need = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(per_sm) * sm_count();
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace

extern "C" {

const char* tower_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (rows, f, d) bf16, contiguous -> out (rows, d) bf16.
int fanout_mean_bf16(const void* x, long long rows, int f, int d, void* out, void* stream) {
  if (rows < 0 || f <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 2 == 0 && aligned4(x) && aligned4(out)) {
    const long long pairs = rows * (d / 2);
    fanout_mean_pairs<<<grid_resident<fanout_mean_pairs>(pairs), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat162*>(x), pairs, d / 2, f,
        static_cast<__nv_bfloat162*>(out));
  } else {
    const long long n_out = rows * d;
    fanout_mean_scalar<<<grid_resident<fanout_mean_scalar>(n_out), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n_out, d, f, static_cast<__nv_bfloat16*>(out));
  }
  return cudaGetLastError();
}

// g (rows, d) bf16, contiguous -> dx (rows, f, d) bf16.
int fanout_mean_bf16_bwd(const void* g, long long rows, int f, int d, void* dx, void* stream) {
  if (rows < 0 || f <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 2 == 0 && aligned4(g) && aligned4(dx)) {
    const long long pairs = rows * (d / 2);
    fanout_mean_bwd_pairs<<<grid_resident<fanout_mean_bwd_pairs>(pairs), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat162*>(g), pairs, d / 2, f,
        static_cast<__nv_bfloat162*>(dx));
  } else {
    const long long n_in = rows * d;
    fanout_mean_bwd_scalar<<<grid_resident<fanout_mean_bwd_scalar>(n_in), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), n_in, d, f, static_cast<__nv_bfloat16*>(dx));
  }
  return cudaGetLastError();
}

// h (n_h, d) bf16 contiguous, src (E,) int64 in row order, indptr (N + 1,)
// int64, deg (N,) f32 -> out (N, d) bf16.  The caller checks that src and
// indptr index inside h and src.
int segment_mean_bf16(const void* h, const void* src, const void* indptr, const void* deg,
                      long long n, int d, void* out, void* stream) {
  if (n < 0 || d <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* s = static_cast<const long long*>(src);
  const long long* ip = static_cast<const long long*>(indptr);
  const float* dg = static_cast<const float*>(deg);
  if (d % 2 == 0 && aligned4(h) && aligned4(out)) {
    const long long pairs = n * (d / 2);
    segment_mean_pairs<<<grid_resident<segment_mean_pairs>(pairs), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat162*>(h), s, ip, dg, pairs, d / 2,
        static_cast<__nv_bfloat162*>(out));
  } else {
    const long long n_out = n * d;
    segment_mean_scalar<<<grid_resident<segment_mean_scalar>(n_out), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h), s, ip, dg, n_out, d,
        static_cast<__nv_bfloat16*>(out));
  }
  return cudaGetLastError();
}

// h (n_h, d) f32 contiguous, src (E,) int64 in row order, indptr (N + 1,)
// int64, deg (N,) f32 -> out (N, d) f32.  The caller checks that src and
// indptr index inside h and src.
int csr_mean_f32(const void* h, const void* src, const void* indptr, const void* deg,
                 long long n, int d, void* out, void* stream) {
  if (n < 0 || d <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* s = static_cast<const long long*>(src);
  const long long* ip = static_cast<const long long*>(indptr);
  const float* dg = static_cast<const float*>(deg);
  if (d % 4 == 0 && aligned16(h) && aligned16(out)) {
    const long long n_out = n * (d / 4);
    csr_mean_f32_rows<float4><<<grid_resident<csr_mean_f32_rows<float4>>(n_out), kThreads, 0,
                                st>>>(
        static_cast<const float4*>(h), s, ip, dg, n_out, d / 4, static_cast<float4*>(out));
  } else {
    const long long n_out = n * d;
    csr_mean_f32_rows<float><<<grid_resident<csr_mean_f32_rows<float>>(n_out), kThreads, 0,
                               st>>>(
        static_cast<const float*>(h), s, ip, dg, n_out, d, static_cast<float*>(out));
  }
  return cudaGetLastError();
}

// p (n_p, d) bf16 contiguous, d % 8 == 0, src (E,) int64 in row order,
// indptr (N + 1,) int64, deg (N,) f32 -> out (N, d) bf16; p and out 16-byte
// aligned.  The caller checks that src and indptr index inside p and src.
int csr_mean_bf16(const void* p, const void* src, const void* indptr, const void* deg,
                  long long n, int d, void* out, void* stream) {
  if (n < 0 || d <= 0 || d % 8) return cudaErrorInvalidValue;
  if (!aligned16(p) || !aligned16(out)) return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  const long long n_out = n * (d / 8);
  csr_mean_bf16_rows<<<grid_resident<csr_mean_bf16_rows>(n_out), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), static_cast<const long long*>(src),
      static_cast<const long long*>(indptr), static_cast<const float*>(deg), n_out, d / 8,
      static_cast<uint4*>(out));
  return cudaGetLastError();
}

}  // extern "C"
