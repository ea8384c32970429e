// Hopper (sm_90a) kernels for the TT-embedding lookup, its backward and the
// fused updates of the TT cores (Adam, SGD, adagrad, rowwise adagrad).
// Built by nvcc into a shared library with a plain C interface and loaded
// through ctypes (falcon_ttdforgnns_torch/ops/_build.py); the Python
// wrappers live in falcon_ttdforgnns_torch/ops/tt_kernels.py next to their
// plain versions.
//
// Cores keep the native (p_k, r_k, q_k, r_{k+1}) layout, row-major, f32.
// Digits are digit_k = (id / stride_k) % p_k.  The TPU kernels held whole
// cores in VMEM and selected rows with one-hot matmuls; here the cores stay
// in global memory (793 KB at the products shapes, resident in the 50 MB
// L2) and each id reads its core rows by digit.
//
// tt_fwd  replaces falcon_ttdforgnns_tpu/ops/tt_pallas.py:_fwd_kernel, and
//   with out_kind 2 also :_fwd_kernel_sr.
//   One warp per id.  The running chain state (L_k x r_k floats, at most
//   400 at the products shapes) ping-pongs between two per-warp shared
//   buffers; each lane computes outputs o = lane, lane+32, ... of the next
//   level with f32 FMAs over the input rank, reading the core row straight
//   from global (coalesced across lanes, L1/L2 resident).  The last level
//   is stored straight to the output row, in one of three ways (template
//   Store): f32; bf16 by round-to-nearest-even (__float2bfloat16_rn, the
//   rounding of JAX's astype); or bf16 by stochastic rounding, the
//   bit-exact port of tt_pallas.py:_sr_cast — element (b, f) adds the low
//   16 bits of splitmix32(seed * 0x9E3779B9 + (b / block) * D * block +
//   f * block + b % block) to its f32 bits and truncates.  `block` is a
//   parameter of the hash (the Pallas grid block), not of the launch; the
//   seed is read from device memory (no host sync).  Bound on H100: the
//   FMAs (8,000 per id at the products shapes, 15 GFLOP per 937,984 ids,
//   0.22 ms at the 67 TFLOP/s f32 peak) before the output store (375 MB in
//   f32, 0.11 ms; 188 MB in bf16, 0.06 ms); the SR hash adds ~12 integer
//   operations per output element.  The output pointer is typed per store
//   and __restrict__, and the last level has its own loop: a first version
//   that passed an untyped output pointer in a struct ran 15% slower (3.86
//   against 3.36 ms, scripts/torch_kernel_times.py).  Measured: PERF.md.
//
// tt_grads  replaces tt_pallas.py:_bwd_kernel.
//   One warp per id: recompute the left partials P_0..P_{T-2} into shared
//   memory, copy the d_out row in (f32, or bf16 upcast as it is staged),
//   then walk the cores from last to first:
//     dC_k[r, c]     = sum_l P_{k-1}[l, r] * G_k[l, c]     (scattered)
//     G_{k-1}[l, r]  = sum_c C_k[r, c]     * G_k[l, c]     (k > 0)
//   with c = (u, s) flattened.  The core row C_k is staged in shared memory
//   with an odd row pitch so lanes that differ in r hit different banks.
//   Scatter: 937,984 ids add ~1.3 billion values into 198,160 addresses,
//   ~6,700 adds per address, with atomicAdd (performed at L2) straight into
//   the zeroed (n_total,) gradient.  The gradient (793 KB) stays in L2, so
//   the read-modify-writes never reach HBM.  The summation order varies
//   from run to run: each core's gradient agrees with the plain version to
//   within 1e-4 of that core's largest magnitude (a reordered f32 sum of up
//   to ~2.3e5 terms; the check is in chip_smoke.py).  Bound: ~22,400 FMAs
//   per id (42 GFLOP per step, 0.63 ms at the f32 peak) before the d_out
//   read (375 MB f32, 188 MB bf16).  Measured: PERF.md.  Eight private
//   partial copies of the gradient summed by a second pass timed the same
//   as one (PERF.md): the per-id chain work, not atomic contention, sets
//   the time for now.
//
// The fused core updates.  A cross-block reduction needs a second pass on
// Hopper, so each fused update of the TPU (one pallas_call that sums the
// batch gradient over its sequential grid, then updates on the last block)
// is two launches here: tt_grads, then one of these kernels over every
// core value, in place.  Each is bound by bytes (a few arrays of 198,160
// floats at the products shapes: launch-latency sized).
//   tt_adam_apply     with tt_grads replaces tt_pallas.py:_adam_kernel.
//     Reads scal = [lr_eff, c1, c2] from device memory; updates cores, m, v.
//   tt_sgd_apply      with tt_grads replaces tt_pallas.py:_sgd_kernel.
//     core -= lr * g; the gradient was taken at the pre-step cores, since
//     tt_grads has finished before this kernel starts.  Bound: 198,160
//     values, 2.4 MB read and written, 0.7 us at 3.35 TB/s — far below a
//     launch, so what sets its time is the launch and the Python path that
//     makes it.  The design cuts both: blockIdx.y picks the core (no
//     per-element search over the core offsets), the body moves a float4 of
//     core and gradient per thread where both pointers are 16-byte aligned
//     (all three products cores are multiples of 4 values) with a scalar
//     tail, and the grid is one float4 per thread of the largest core,
//     capped at 4 blocks per SM per core (the SM count asked once).  The
//     wrapper validates the cores once per argument set and keeps their
//     ctypes arrays, checking only the step's new gradients on each call
//     (ops/tt_kernels.py, _launch_args), as for Adam and adagrad; the
//     launcher picks each core's pointers into separate kernel parameters.
//     Folding -lr * g into the cores inside tt_grads is
//     not done: ~6,700 atomic adds per address would round every add at
//     the core's ulp, far off the plain version.
//   tt_adagrad_apply  with tt_grads replaces tt_pallas.py:_adagrad_kernel.
//     Per element: a += g^2, core -= lr * g / (sqrt(a) + eps), one thread
//     per value.  Rowwise: one accumulator per p-row of each core; one warp
//     per row sums g^2 over the row's F_k = r_k q_k r_{k+1} contiguous
//     values (shuffle reduction), adds the mean to the accumulator, then
//     updates the row.  Products and sums are written out with __fmul_rn /
//     __fadd_rn so nvcc contracts nothing into an FMA: the kernels repeat
//     the plain versions' arithmetic operation for operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_info.cuh"

namespace {

constexpr int kMaxCores = 4;
constexpr int kWarpsPerBlock = 8;

struct TTMeta {
  int T;
  int D;                      // embedding dim = prod(q)
  int p[kMaxCores];
  int q[kMaxCores];
  int r[kMaxCores + 1];       // full ranks (1, r_1, ..., r_{T-1}, 1)
  int stride[kMaxCores];
  int L[kMaxCores + 1];       // L[k] = prod(q_0 .. q_{k-1}), L[0] = 1
  int F[kMaxCores];           // core row size r_k * q_k * r_{k+1}
  int S;                      // max_k L[k+1] * r[k+1]: largest chain state
  int P_total;                // sum_{k<T-1} L[k+1] * r[k+1]: saved left partials
  int C_stage;                // max_{k>=1} r[k] * pitch(k): staged core row
  long long off[kMaxCores + 1];  // offsets of each core in the flat gradient
};

struct CorePtrs {
  const float* c[kMaxCores];
};

// The in-place update kernels' view of T cores: each array k has n_k
// values (s1/s2: Adam's m and v, or adagrad's accumulator in s1); off[]
// are element offsets into the concatenation, row_off[] the offsets of
// the p-rows (F[k] values each).
struct OptPtrs {
  float* core[kMaxCores];
  float* s1[kMaxCores];
  float* s2[kMaxCores];
  const float* g[kMaxCores];
  long long off[kMaxCores + 1];
  long long row_off[kMaxCores + 1];
  int F[kMaxCores];
  int T;
};

constexpr int kSgdThreads = 256;

enum class Store { kF32, kBF16, kBF16SR };

__host__ __device__ inline int row_pitch(int mm) { return mm | 1; }

bool make_meta(const int* spec, TTMeta* m) {
  // spec = [T, p0..p3, q0..q3, r0..r4, stride0..stride3]
  m->T = spec[0];
  if (m->T < 2 || m->T > kMaxCores) return false;
  for (int k = 0; k < kMaxCores; ++k) {
    m->p[k] = spec[1 + k];
    m->q[k] = spec[5 + k];
    m->stride[k] = spec[14 + k];
  }
  for (int k = 0; k <= kMaxCores; ++k) m->r[k] = spec[9 + k];
  m->L[0] = 1;
  m->S = 0;
  m->P_total = 0;
  m->C_stage = 0;
  m->off[0] = 0;
  for (int k = 0; k < m->T; ++k) {
    if (m->p[k] <= 0 || m->q[k] <= 0 || m->r[k] <= 0 || m->r[k + 1] <= 0 ||
        m->stride[k] <= 0)
      return false;
    m->L[k + 1] = m->L[k] * m->q[k];
    m->F[k] = m->r[k] * m->q[k] * m->r[k + 1];
    const int level = m->L[k + 1] * m->r[k + 1];
    if (level > m->S) m->S = level;
    if (k < m->T - 1) m->P_total += level;
    if (k >= 1) {
      const int staged = m->r[k] * row_pitch(m->q[k] * m->r[k + 1]);
      if (staged > m->C_stage) m->C_stage = staged;
    }
    m->off[k + 1] = m->off[k] + (long long)m->p[k] * m->F[k];
  }
  m->D = m->L[m->T];
  return m->r[0] == 1 && m->r[m->T] == 1;
}

template <int T>
__device__ __forceinline__ void digits_of(int id, const TTMeta& m, int* d) {
#pragma unroll
  for (int k = 0; k < T; ++k) d[k] = (id / m.stride[k]) % m.p[k];
}

// ---------------------------------------------------------------- tt_fwd
// splitmix32 finalizer of the salt z, its low 16 bits added to the f32 bits
// of v, truncated to bf16 (tt_pallas.py:_sr_cast).
__device__ __forceinline__ unsigned short bf16_sr_bits(float v, unsigned z) {
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  z ^= z >> 16;
  return (unsigned short)((__float_as_uint(v) + (z & 0xFFFFu)) >> 16);
}

// The output element type of each store, and the conversion into it.
template <Store S> struct OutOf { using type = unsigned short; };  // bf16 bits
template <> struct OutOf<Store::kF32> { using type = float; };

template <Store S>
__device__ __forceinline__ typename OutOf<S>::type convert_out(float v, unsigned salt) {
  if constexpr (S == Store::kF32) {
    return v;
  } else if constexpr (S == Store::kBF16) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  } else {
    return bf16_sr_bits(v, salt);
  }
}

template <int T, Store S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tt_fwd_kernel(const int* __restrict__ ids, long long B, CorePtrs cores,
              TTMeta m, typename OutOf<S>::type* __restrict__ out,
              const int* __restrict__ seed, unsigned block) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* buf0 = smem + warp * 2 * m.S;
  float* buf1 = buf0 + m.S;
  unsigned seed_mix = 0;
  if constexpr (S == Store::kBF16SR) seed_mix = (unsigned)__ldg(seed) * 0x9E3779B9u;
  for (long long b = (long long)blockIdx.x * kWarpsPerBlock + warp; b < B;
       b += (long long)gridDim.x * kWarpsPerBlock) {
    int d[T];
    digits_of<T>(ids[b], m, d);
    // SR salt of element (b, 0); element (b, o) adds o * block (mod 2^32)
    unsigned row_salt = 0;
    if constexpr (S == Store::kBF16SR)
      row_salt = seed_mix + (unsigned)(b / block) * ((unsigned)m.D * block)
                 + (unsigned)(b % block);
    const float* c0 = cores.c[0] + (long long)d[0] * m.F[0];
    for (int i = lane; i < m.F[0]; i += 32) buf0[i] = __ldg(c0 + i);
    __syncwarp();
    float* cur = buf0;
    float* nxt = buf1;
#pragma unroll
    for (int k = 1; k < T; ++k) {
      const int rin = m.r[k];
      const int mm = m.q[k] * m.r[k + 1];
      const int n = m.L[k] * mm;
      const float* ck = cores.c[k] + (long long)d[k] * m.F[k];
      if (k == T - 1) {
        typename OutOf<S>::type* dst = out + b * m.D;
        for (int o = lane; o < n; o += 32) {
          const int l = o / mm;
          const int c = o - l * mm;
          const float* s = cur + l * rin;
          float acc = 0.f;
          for (int r = 0; r < rin; ++r) acc = fmaf(s[r], __ldg(ck + r * mm + c), acc);
          dst[o] = convert_out<S>(acc, row_salt + (unsigned)o * block);
        }
      } else {
        for (int o = lane; o < n; o += 32) {
          const int l = o / mm;
          const int c = o - l * mm;
          const float* s = cur + l * rin;
          float acc = 0.f;
          for (int r = 0; r < rin; ++r) acc = fmaf(s[r], __ldg(ck + r * mm + c), acc);
          nxt[o] = acc;
        }
      }
      __syncwarp();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// -------------------------------------------------------------- tt_grads
template <int T, typename DT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tt_grads_kernel(const int* __restrict__ ids, const DT* __restrict__ dout,
                long long B, CorePtrs cores, TTMeta m,
                float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* base = smem + warp * (m.P_total + 2 * m.S + m.C_stage);
  float* P = base;                     // left partials P_0 .. P_{T-2}
  float* g0 = P + m.P_total;           // chain-gradient ping-pong
  float* g1 = g0 + m.S;
  float* cst = g1 + m.S;               // staged core row, odd pitch

  for (long long b = (long long)blockIdx.x * kWarpsPerBlock + warp; b < B;
       b += (long long)gridDim.x * kWarpsPerBlock) {
    int d[T];
    digits_of<T>(ids[b], m, d);

    // forward: P_0 = core-0 row, P_k = P_{k-1} x C_k[d_k]
    int poff[T];
    poff[0] = 0;
    {
      const float* c0 = cores.c[0] + (long long)d[0] * m.F[0];
      for (int i = lane; i < m.F[0]; i += 32) P[i] = __ldg(c0 + i);
    }
    __syncwarp();
#pragma unroll
    for (int k = 1; k < T - 1; ++k) {
      const int rin = m.r[k];
      const int mm = m.q[k] * m.r[k + 1];
      const int n = m.L[k] * mm;
      poff[k] = poff[k - 1] + m.L[k] * rin;
      const float* prev = P + poff[k - 1];
      float* cur = P + poff[k];
      const float* ck = cores.c[k] + (long long)d[k] * m.F[k];
      for (int o = lane; o < n; o += 32) {
        const int l = o / mm;
        const int c = o - l * mm;
        float acc = 0.f;
        for (int r = 0; r < rin; ++r)
          acc = fmaf(prev[l * rin + r], __ldg(ck + r * mm + c), acc);
        cur[o] = acc;
      }
      __syncwarp();
    }

    // G_{T-1} = d_out row, upcast to f32 as it is staged
    const DT* drow = dout + b * m.D;
    for (int i = lane; i < m.D; i += 32) g0[i] = to_f32(drow[i]);
    __syncwarp();
    float* G = g0;
    float* Gn = g1;

#pragma unroll
    for (int k = T - 1; k >= 0; --k) {
      const int rin = m.r[k];
      const int mm = m.q[k] * m.r[k + 1];
      const int Lk = m.L[k];
      float* gk = grad + m.off[k] + (long long)d[k] * m.F[k];
      const float* ck = cores.c[k] + (long long)d[k] * m.F[k];
      const int pitch = row_pitch(mm);
      if (k > 0) {
        for (int i = lane; i < m.F[k]; i += 32) {
          const int r = i / mm;
          cst[r * pitch + (i - r * mm)] = __ldg(ck + i);
        }
      }
      // dC_k[r, c] = sum_l P_{k-1}[l, r] * G[l, c]   (P_{-1} = 1)
      const float* prev = (k > 0) ? P + poff[k - 1] : nullptr;
      for (int o = lane; o < m.F[k]; o += 32) {
        const int r = o / mm;
        const int c = o - r * mm;
        float acc;
        if (k > 0) {
          acc = 0.f;
          for (int l = 0; l < Lk; ++l) acc = fmaf(prev[l * rin + r], G[l * mm + c], acc);
        } else {
          acc = G[c];
        }
        atomicAdd(gk + o, acc);
      }
      if (k > 0) {
        __syncwarp();  // staged core row visible to every lane
        // G_{k-1}[l, r] = sum_c C_k[r, c] * G[l, c]
        for (int o = lane; o < Lk * rin; o += 32) {
          const int l = o / rin;
          const int r = o - l * rin;
          const float* crow = cst + r * pitch;
          const float* grow = G + l * mm;
          float acc = 0.f;
          for (int c = 0; c < mm; ++c) acc = fmaf(crow[c], grow[c], acc);
          Gn[o] = acc;
        }
        __syncwarp();
        float* t = G;
        G = Gn;
        Gn = t;
      }
    }
    __syncwarp();
  }
}

// ------------------------------------------------------- update kernels
__device__ __forceinline__ int core_of(const OptPtrs& a, long long i) {
  int k = 0;
  while (i >= a.off[k + 1]) ++k;
  return k;
}

__global__ void tt_adam_kernel(OptPtrs a, const float* __restrict__ scal,
                               float b1, float omb1, float b2, float omb2,
                               float eps) {
  const float lr = scal[0];
  const float c1 = scal[1];
  const float c2 = scal[2];
  const long long n = a.off[a.T];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = core_of(a, i);
    const long long j = i - a.off[k];
    const float g = a.g[k][j];
    const float m = b1 * a.s1[k][j] + omb1 * g;
    const float v = b2 * a.s2[k][j] + omb2 * g * g;
    a.s1[k][j] = m;
    a.s2[k][j] = v;
    a.core[k][j] = a.core[k][j] - lr * (m * c1) / (sqrtf(v * c2) + eps);
  }
}

__device__ __forceinline__ float sgd_step(float c, float g, float lr) {
  return __fsub_rn(c, __fmul_rn(lr, g));
}

// grid (x, T): blockIdx.y is the core; the x blocks stride over its values,
// four at a time (float4) when the core and its gradient are both 16-byte
// aligned, then one at a time over the rest.
// The pointers and sizes are separate parameters, selected by compares: an
// index into a parameter struct by blockIdx.y makes every thread copy the
// struct to local memory (104 bytes a thread, ~3x the bytes of the update).
__global__ void __launch_bounds__(kSgdThreads) tt_sgd_kernel(
    float* c0, float* c1, float* c2, float* c3, const float* g0, const float* g1,
    const float* g2, const float* g3, long long n0, long long n1, long long n2,
    long long n3, float lr) {
  const unsigned k = blockIdx.y;
  float* c = k == 0 ? c0 : k == 1 ? c1 : k == 2 ? c2 : c3;
  const float* g = k == 0 ? g0 : k == 1 ? g1 : k == 2 ? g2 : g3;
  const long long n = k == 0 ? n0 : k == 1 ? n1 : k == 2 ? n2 : n3;
  const long long tid = (long long)blockIdx.x * kSgdThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kSgdThreads;
  long long tail = 0;
  if (((reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(g)) & 15) == 0) {
    float4* c4 = reinterpret_cast<float4*>(c);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const long long n4 = n >> 2;
    for (long long i = tid; i < n4; i += stride) {
      float4 v = c4[i];
      const float4 d = __ldg(g4 + i);
      v.x = sgd_step(v.x, d.x, lr);
      v.y = sgd_step(v.y, d.y, lr);
      v.z = sgd_step(v.z, d.z, lr);
      v.w = sgd_step(v.w, d.w, lr);
      c4[i] = v;
    }
    tail = n4 << 2;
  }
  for (long long i = tail + tid; i < n; i += stride) c[i] = sgd_step(c[i], __ldg(g + i), lr);
}

// per element: s1 is the accumulator, shaped like the core
__global__ void tt_adagrad_kernel(OptPtrs a, float lr, float eps) {
  const long long n = a.off[a.T];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = core_of(a, i);
    const long long j = i - a.off[k];
    const float g = a.g[k][j];
    const float acc = __fadd_rn(a.s1[k][j], __fmul_rn(g, g));
    a.s1[k][j] = acc;
    a.core[k][j] = __fsub_rn(a.core[k][j],
                             __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(sqrtf(acc), eps)));
  }
}

// rowwise: one warp per p-row; s1[k] holds one accumulator per row of core k
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tt_rowwise_adagrad_kernel(OptPtrs a, float lr, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.row_off[a.T]) return;  // uniform across the warp
  int k = 0;
  while (row >= a.row_off[k + 1]) ++k;
  const long long r = row - a.row_off[k];
  const int F = a.F[k];
  const float* g = a.g[k] + r * F;
  float* c = a.core[k] + r * F;
  float sq = 0.f;
  for (int i = lane; i < F; i += 32) sq = __fadd_rn(sq, __fmul_rn(g[i], g[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float acc = __fadd_rn(a.s1[k][r], __fdiv_rn(sq, (float)F));
  const float den = __fadd_rn(sqrtf(acc), eps);
  for (int i = lane; i < F; i += 32)
    c[i] = __fsub_rn(c[i], __fdiv_rn(__fmul_rn(lr, g[i]), den));
  if (lane == 0) a.s1[k][r] = acc;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

unsigned blocks_for(long long B) {
  return (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <int T, Store S>
cudaError_t launch_fwd(const int* ids, long long B, const CorePtrs& c,
                       const TTMeta& m, void* out, const int* seed,
                       unsigned block, cudaStream_t st) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * m.S;
  cudaError_t e = set_smem(tt_fwd_kernel<T, S>, smem);
  if (e != cudaSuccess) return e;
  tt_fwd_kernel<T, S><<<blocks_for(B), kWarpsPerBlock * 32, smem, st>>>(
      ids, B, c, m, static_cast<typename OutOf<S>::type*>(out), seed, block);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_fwd_store(int out_kind, const int* ids, long long B,
                             const CorePtrs& c, const TTMeta& m, void* out,
                             const int* seed, unsigned block, cudaStream_t st) {
  switch (out_kind) {
    case 0: return launch_fwd<T, Store::kF32>(ids, B, c, m, out, seed, block, st);
    case 1: return launch_fwd<T, Store::kBF16>(ids, B, c, m, out, seed, block, st);
    case 2: return launch_fwd<T, Store::kBF16SR>(ids, B, c, m, out, seed, block, st);
  }
  return cudaErrorInvalidValue;
}

template <int T, typename DT>
cudaError_t launch_grads(const int* ids, const DT* dout, long long B,
                         const CorePtrs& c, const TTMeta& m, float* grad,
                         cudaStream_t st) {
  const size_t smem =
      sizeof(float) * kWarpsPerBlock * (m.P_total + 2 * m.S + m.C_stage);
  cudaError_t e = set_smem(tt_grads_kernel<T, DT>, smem);
  if (e != cudaSuccess) return e;
  tt_grads_kernel<T, DT><<<blocks_for(B), kWarpsPerBlock * 32, smem, st>>>(
      ids, dout, B, c, m, grad);
  return cudaGetLastError();
}

template <typename DT>
cudaError_t launch_grads_T(const int* ids, const DT* dout, long long B,
                           const CorePtrs& c, const TTMeta& m, float* grad,
                           cudaStream_t st) {
  switch (m.T) {
    case 2: return launch_grads<2, DT>(ids, dout, B, c, m, grad, st);
    case 3: return launch_grads<3, DT>(ids, dout, B, c, m, grad, st);
    case 4: return launch_grads<4, DT>(ids, dout, B, c, m, grad, st);
  }
  return cudaErrorInvalidValue;
}

CorePtrs core_ptrs(const void* c0, const void* c1, const void* c2, const void* c3) {
  CorePtrs c;
  c.c[0] = static_cast<const float*>(c0);
  c.c[1] = static_cast<const float*>(c1);
  c.c[2] = static_cast<const float*>(c2);
  c.c[3] = static_cast<const float*>(c3);
  return c;
}

// n[k] values in array k; F (may be null) the p-row size of core k.
bool opt_ptrs(int T, const long long* n, const int* F, void* const* cores,
              void* const* s1, void* const* s2, const void* const* grads,
              OptPtrs* a) {
  if (T < 1 || T > kMaxCores) return false;
  a->T = T;
  a->off[0] = 0;
  a->row_off[0] = 0;
  for (int k = 0; k < kMaxCores; ++k) {
    const bool on = k < T;
    a->core[k] = on ? static_cast<float*>(cores[k]) : nullptr;
    a->s1[k] = on && s1 ? static_cast<float*>(s1[k]) : nullptr;
    a->s2[k] = on && s2 ? static_cast<float*>(s2[k]) : nullptr;
    a->g[k] = on ? static_cast<const float*>(grads[k]) : nullptr;
    a->F[k] = on && F ? F[k] : 1;
    if (on && (n[k] <= 0 || a->F[k] <= 0 || n[k] % a->F[k] != 0)) return false;
    a->off[k + 1] = a->off[k] + (on ? n[k] : 0);
    a->row_off[k + 1] = a->row_off[k] + (on ? n[k] / a->F[k] : 0);
  }
  return true;
}

unsigned elementwise_blocks(const OptPtrs& a) {
  return (unsigned)((a.off[a.T] + 255) / 256);
}

}  // namespace

extern "C" {

const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (B, D) <- rows of the TT table at ids (B,) int32, stored as
// out_kind 0: f32; 1: bf16, round to nearest even; 2: bf16, stochastic
// rounding with the int32 at `seed` (device) and the hash's `block`.
int tt_fwd(const void* ids, long long B, const int* spec, const void* c0,
           const void* c1, const void* c2, const void* c3, void* out,
           int out_kind, const void* seed, int block, void* stream) {
  TTMeta m;
  if (!make_meta(spec, &m)) return cudaErrorInvalidValue;
  if (out_kind == 2 && (seed == nullptr || block <= 0)) return cudaErrorInvalidValue;
  const CorePtrs c = core_ptrs(c0, c1, c2, c3);
  const int* id = static_cast<const int*>(ids);
  const int* sd = static_cast<const int*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m.T) {
    case 2: return launch_fwd_store<2>(out_kind, id, B, c, m, out, sd, block, st);
    case 3: return launch_fwd_store<3>(out_kind, id, B, c, m, out, sd, block, st);
    case 4: return launch_fwd_store<4>(out_kind, id, B, c, m, out, sd, block, st);
  }
  return cudaErrorInvalidValue;
}

// grad (n_total,) f32, zeroed by the caller, accumulates the per-core
// gradients, core after core in the flat layout.  d_out (B, D) is f32, or
// bf16 when dout_bf16 is 1.
int tt_grads(const void* ids, const void* dout, int dout_bf16, long long B,
             const int* spec, const void* c0, const void* c1, const void* c2,
             const void* c3, void* grad, void* stream) {
  TTMeta m;
  if (!make_meta(spec, &m)) return cudaErrorInvalidValue;
  const CorePtrs c = core_ptrs(c0, c1, c2, c3);
  const int* id = static_cast<const int*>(ids);
  float* out = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dout_bf16)
    return launch_grads_T(id, static_cast<const __nv_bfloat16*>(dout), B, c, m, out, st);
  return launch_grads_T(id, static_cast<const float*>(dout), B, c, m, out, st);
}

// In-place Adam on T cores: cores/m/v/g are T separate f32 arrays of
// sizes n[k]; scal (3,) f32 on the device = [lr_eff, c1, c2].
int tt_adam_apply(int T, const long long* n, void* const* cores, void* const* ms,
                  void* const* vs, const void* const* grads, const void* scal,
                  float b1, float omb1, float b2, float omb2, float eps,
                  void* stream) {
  OptPtrs a;
  if (!opt_ptrs(T, n, nullptr, cores, ms, vs, grads, &a)) return cudaErrorInvalidValue;
  tt_adam_kernel<<<elementwise_blocks(a), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(scal), b1, omb1, b2, omb2, eps);
  return cudaGetLastError();
}

// In-place SGD on T cores: core k -= lr * g_k over its n[k] values.
int tt_sgd_apply(int T, const long long* n, void* const* cores, const void* const* grads,
                 float lr, void* stream) {
  if (T < 1 || T > kMaxCores) return cudaErrorInvalidValue;
  float* c[kMaxCores] = {};
  const float* g[kMaxCores] = {};
  long long m[kMaxCores] = {};
  long long most = 0;
  for (int k = 0; k < T; ++k) {
    if (n[k] <= 0) return cudaErrorInvalidValue;
    c[k] = static_cast<float*>(cores[k]);
    g[k] = static_cast<const float*>(grads[k]);
    m[k] = n[k];
    if (n[k] > most) most = n[k];
  }
  // one float4 per thread for the largest core, at most 4 blocks per SM per core
  const long long want = (most / 4 + kSgdThreads - 1) / kSgdThreads;
  const long long cap = 4LL * sm_count();
  const dim3 grid((unsigned)(want < 1 ? 1 : (want > cap ? cap : want)), (unsigned)T);
  tt_sgd_kernel<<<grid, kSgdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c[0], c[1], c[2], c[3], g[0], g[1], g[2], g[3], m[0], m[1], m[2], m[3], lr);
  return cudaGetLastError();
}

// In-place adagrad on T cores with accumulators accs: per element (accs
// shaped like the cores) or, with rowwise 1, one accumulator per p-row of
// F[k] values (accs[k] has n[k] / F[k] values).
int tt_adagrad_apply(int T, const long long* n, const int* F, void* const* cores,
                     void* const* accs, const void* const* grads, float lr,
                     float eps, int rowwise, void* stream) {
  OptPtrs a;
  if (!opt_ptrs(T, n, rowwise ? F : nullptr, cores, accs, nullptr, grads, &a))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rowwise)
    tt_rowwise_adagrad_kernel<<<blocks_for(a.row_off[T]), kWarpsPerBlock * 32, 0, st>>>(
        a, lr, eps);
  else
    tt_adagrad_kernel<<<elementwise_blocks(a), 256, 0, st>>>(a, lr, eps);
  return cudaGetLastError();
}

}  // extern "C"
