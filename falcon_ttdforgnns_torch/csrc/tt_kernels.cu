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
//   The backward is linear in d_out, and ids that share a prefix (digits
//   d_0..d_{T-2}, i.e. id // p_{T-1}) share the left partials P_0..P_{T-2}
//   and the core rows C_0..C_{T-2}.  So the ids are walked in sorted order
//   (the wrapper's torch.sort gives the sorted ids and the permutation into
//   d_out) and most of the chain is paid once per run of one prefix:
//     per distinct id, with G^ the sum of its d_out rows (f32, a bf16 d_out
//     upcast exactly) as (L_{T-1}, q_{T-1}):
//       dC_{T-1}[d_{T-1}][r, u] += sum_l P_{T-2}[l, r] G^[l, u]   (atomics)
//       SG[l, r]                += sum_u G^[l, u] C_{T-1}[d_{T-1}][r, u]
//     per segment (one prefix within one chunk), with G_{T-2} = SG:
//       dC_k[d_k][r, m] += sum_l P_{k-1}[l, r] G_k[l, m]   (atomics, k >= 1)
//       G_{k-1}[l, r]    = sum_m G_k[l, m] C_k[d_k][r, m]
//       dC_0[d_0]       += G_0                              (atomics)
//     then P_{T-2} of the next prefix, recomputed from its first changed
//     digit: P_k[l, m] = sum_r P_{k-1}[l, r] C_k[d_k][r, m].
//   This is the reference's sum in another order (exact in real arithmetic
//   for T = 2, 3, 4).  Work split: one warp takes a chunk of `chunk`
//   consecutive sorted positions (64 from the wrapper: 938K ids make 14,656
//   chunks, 3.5 per warp of a full card, and add at most one segment per
//   chunk to the <= prod(p_0..p_{T-2}) prefix runs), on a 1-D grid of one
//   wave, so the work per warp does not depend on how the ids are
//   distributed: the zipf draw's hottest id, a quarter of the batch, is
//   split over thousands of warps.  No host sync, no run table.  Each
//   product above is one warp_mm: a lane owns RB x CB outputs, so each value
//   it loads feeds RB or CB FMAs, and steps its output block without an
//   integer division.  Per warp in shared memory: P_0..P_{T-2}, the flush's
//   chain gradients and SG (2 * P_total floats), G^ (D) and 32 staged
//   (id, position) pairs: 4.5 KB at the products shapes (10.3 KB per id for
//   the per-id chain this replaces), so four 8-warp CTAs, 32 warps, fit an
//   SM at <= 64 registers a thread (__launch_bounds__).  At the products
//   shapes (p=125,140,140, q=5,5,4, ranks 16,16) a distinct id costs 3,200
//   FMAs and 64 atomics, a segment 19,200 FMAs (6,400 for P_1, 12,800 for
//   cores 1 and 0) and 1,360 atomics, against 22,400 FMAs and 1,424 atomics
//   for every id before.  Bound on H100: the larger of the bytes (d_out
//   once, 188 MB in bf16 for 937,984 ids, plus the ids, the int64
//   permutation, the cores and the gradient: ~0.06 ms at 3.35 TB/s) and
//   these FMAs for the input's counts of distinct ids and segments at the
//   f32 peak (chip_smoke.py computes and prints both).  The atomics run at
//   L2 into the zeroed (n_total,) gradient (793 KB, L2-resident), so the
//   summation order varies from run to run: each core's gradient agrees
//   with the plain version to within 1e-4 of that core's largest magnitude
//   (chip_smoke.py).  Measured: PERF.md.
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
//     not done: the many atomic adds per address (one per piece or
//     segment that reaches it) would round every add at the core's ulp,
//     far off the plain version.
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
  int P_total;                // sum_{k<T-1} L[k+1] * r[k+1]: the left partials
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
constexpr int kGradsBlocksPerSM = 4;  // tt_grads: 32 warps an SM, <= 64 registers a thread
constexpr int kStage = 32;            // tt_grads: sorted positions a warp stages at a time

enum class Store { kF32, kBF16, kBF16SR };

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
// One warp's share of an R x C product out(i, j) = sum_k A(i, k) B(k, j),
// A(i, k) = A[i * ai + k * ak] in shared memory, B(k, j) = B[k * bk + j *
// bj] in shared memory or, with kGlobalB, in global memory (a core row,
// read through the read-only cache).  A lane owns blocks of RB rows x CB
// columns: per k it loads RB values of A and CB of B for RB * CB FMAs.
// Blocks go to the lanes in order, each lane's next block found by adding
// the fixed step (32 blocks) without a division; rows and columns past the
// edge load a clamped address and emit nothing.  emit(i, j, value) takes
// every result.
template <int RB, int CB, bool kGlobalB, class Emit>
__device__ __forceinline__ void warp_mm(int R, int C, int K, const float* A, int ai, int ak,
                                        const float* B, int bk, int bj, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int ncb = (C + CB - 1) / CB;
  const int items = ((R + RB - 1) / RB) * ncb;
  const int di = 32 / ncb, dj = 32 % ncb;
  int ib = lane / ncb, jb = lane % ncb;
  for (int it = lane; it < items; it += 32) {
    const int i0 = ib * RB, j0 = jb * CB;
    const float* pa[RB];
    const float* pb[CB];
#pragma unroll
    for (int t = 0; t < RB; ++t) pa[t] = A + min(i0 + t, R - 1) * ai;
#pragma unroll
    for (int c = 0; c < CB; ++c) pb[c] = B + min(j0 + c, C - 1) * bj;
    float acc[RB][CB];
#pragma unroll
    for (int t = 0; t < RB; ++t)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[t][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[RB], b[CB];
#pragma unroll
      for (int t = 0; t < RB; ++t) {
        a[t] = *pa[t];
        pa[t] += ak;
      }
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        if constexpr (kGlobalB) b[c] = __ldg(pb[c]);
        else b[c] = *pb[c];
        pb[c] += bk;
      }
#pragma unroll
      for (int t = 0; t < RB; ++t)
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[t][c] = fmaf(a[t], b[c], acc[t][c]);
    }
#pragma unroll
    for (int t = 0; t < RB; ++t)
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (i0 + t < R && j0 + c < C) emit(i0 + t, j0 + c, acc[t][c]);
    jb += dj;
    ib += di;
    if (jb >= ncb) {
      jb -= ncb;
      ++ib;
    }
  }
}

// The per-warp state of tt_grads_kernel in shared memory.
struct GradsWarp {
  float* P;    // left partials P_0 .. P_{T-2}, P_k (L_{k+1}, r_{k+1}) at poff[k]
  float* Gb;   // a flush's chain gradients G_0 .. G_{T-3}, G_k where P_k is
  float* SG;   // sum over the segment's ids of G_{T-2} (L_{T-1}, r_{T-1})
  float* Gh;   // G^: the current id's summed d_out row (L_{T-1}, q_{T-1})
  int poff[kMaxCores];
};

// P_k for k = f .. T-2 at the prefix digits d (P_0 is the core-0 row).
template <int T>
__device__ __forceinline__ void grads_prefix(int f, const int* d, const TTMeta& m,
                                             const CorePtrs& cores, GradsWarp& w) {
  const int lane = threadIdx.x & 31;
  if (f == 0) {
    const float* c0 = cores.c[0] + (long long)d[0] * m.F[0];
    for (int i = lane; i < m.F[0]; i += 32) w.P[i] = __ldg(c0 + i);
    __syncwarp();
  }
#pragma unroll
  for (int k = 1; k < T - 1; ++k) {
    if (k < f) continue;
    const int rk = m.r[k], Mk = m.q[k] * m.r[k + 1];
    float* out = w.P + w.poff[k];
    warp_mm<2, 2, true>(m.L[k], Mk, rk, w.P + w.poff[k - 1], rk, 1,
                        cores.c[k] + (long long)d[k] * m.F[k], Mk, 1,
                        [&](int i, int j, float v) { out[i * Mk + j] = v; });
    __syncwarp();
  }
}

// The current id's share: the last core's gradient row, and its G_{T-2}
// added into SG.
template <int T>
__device__ __forceinline__ void grads_id(const int* d, const TTMeta& m, const CorePtrs& cores,
                                         GradsWarp& w, float* __restrict__ grad) {
  constexpr int K = T - 1;
  const int q = m.q[K], rl = m.r[K];
  const long long row = (long long)d[K] * m.F[K];
  float* g = grad + m.off[K] + row;
  float* SG = w.SG;
  // dC_{T-1}[d][r, u] += sum_l P_{T-2}[l, r] G^[l, u]
  warp_mm<2, 1, false>(rl, q, m.L[K], w.P + w.poff[T - 2], 1, rl, w.Gh, q, 1,
                       [&](int i, int j, float v) { atomicAdd(g + i * q + j, v); });
  // SG[l, r] += sum_u G^[l, u] C_{T-1}[d][r, u]
  warp_mm<4, 2, true>(m.L[K], rl, q, w.Gh, q, 1, cores.c[K] + row, 1, q,
                      [&](int i, int j, float v) { SG[i * rl + j] += v; });
  __syncwarp();
}

// The segment's share: SG through cores T-2 .. 0, then SG zeroed.
template <int T>
__device__ __forceinline__ void grads_flush(const int* d, const TTMeta& m, const CorePtrs& cores,
                                            GradsWarp& w, float* __restrict__ grad) {
  const int lane = threadIdx.x & 31;
  const float* G = w.SG;
#pragma unroll
  for (int k = T - 2; k >= 1; --k) {
    const int rk = m.r[k], Mk = m.q[k] * m.r[k + 1];
    const long long row = (long long)d[k] * m.F[k];
    float* g = grad + m.off[k] + row;
    float* Gn = w.Gb + w.poff[k - 1];
    // dC_k[d_k][r, m] += sum_l P_{k-1}[l, r] G_k[l, m]
    warp_mm<2, 2, false>(rk, Mk, m.L[k], w.P + w.poff[k - 1], 1, rk, G, Mk, 1,
                         [&](int i, int j, float v) { atomicAdd(g + i * Mk + j, v); });
    // G_{k-1}[l, r] = sum_m G_k[l, m] C_k[d_k][r, m]
    warp_mm<2, 2, true>(m.L[k], rk, Mk, G, Mk, 1, cores.c[k] + row, 1, Mk,
                        [&](int i, int j, float v) { Gn[i * rk + j] = v; });
    __syncwarp();
    G = Gn;
  }
  float* g0 = grad + m.off[0] + (long long)d[0] * m.F[0];
  for (int i = lane; i < m.F[0]; i += 32) atomicAdd(g0 + i, G[i]);
  __syncwarp();
  const int n = m.L[T - 1] * m.r[T - 1];
  for (int i = lane; i < n; i += 32) w.SG[i] = 0.f;
  __syncwarp();
}

// ids: sorted (B,); perm: their positions in d_out (B, D).  Warps take
// chunks of `chunk` sorted positions; see the note at the top of the file.
template <int T, typename DT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kGradsBlocksPerSM)
tt_grads_kernel(const int* __restrict__ ids, const long long* __restrict__ perm,
                const DT* __restrict__ dout, long long B, int chunk, CorePtrs cores,
                TTMeta m, float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int last = m.L[T - 1] * m.r[T - 1];  // size of P_{T-2}, G_{T-2}
  GradsWarp w;
  w.P = smem + warp * (2 * m.P_total + m.D + 2 * kStage);
  w.Gb = w.P + m.P_total;
  w.SG = w.Gb + (m.P_total - last);
  w.Gh = w.SG + last;
  int* s_id = reinterpret_cast<int*>(w.Gh + m.D);
  int* s_pos = s_id + kStage;
  w.poff[0] = 0;
#pragma unroll
  for (int k = 1; k < T - 1; ++k) w.poff[k] = w.poff[k - 1] + m.L[k] * m.r[k];
  for (int i = lane; i < last; i += 32) w.SG[i] = 0.f;

  const long long n_chunks = (B + chunk - 1) / chunk;
  for (long long c = (long long)blockIdx.x * kWarpsPerBlock + warp; c < n_chunks;
       c += (long long)gridDim.x * kWarpsPerBlock) {
    const long long hi = (c + 1) * chunk < B ? (c + 1) * chunk : B;
    int d[T] = {};  // digits of the current id
    int cur = 0;
    bool have = false;
    for (long long s0 = c * chunk; s0 < hi; s0 += kStage) {
      const int n = hi - s0 < kStage ? (int)(hi - s0) : kStage;
      __syncwarp();  // the last stage's reads are done
      if (lane < n) {
        s_id[lane] = ids[s0 + lane];
        s_pos[lane] = (int)perm[s0 + lane];
      }
      __syncwarp();
      for (int j = 0; j < n;) {
        const int id = s_id[j];
        if (!have || id != cur) {
          int nd[T];
          digits_of<T>(id, m, nd);
          int f = have ? T - 1 : 0;  // the first prefix digit that changes
          if (have) {
#pragma unroll
            for (int k = T - 2; k >= 0; --k)
              if (nd[k] != d[k]) f = k;
            __syncwarp();  // G^ complete
            grads_id<T>(d, m, cores, w, grad);
            if (f < T - 1) grads_flush<T>(d, m, cores, w, grad);
          }
#pragma unroll
          for (int k = 0; k < T; ++k) d[k] = nd[k];
          if (f < T - 1) grads_prefix<T>(f, d, m, cores, w);
          for (int i = lane; i < m.D; i += 32) w.Gh[i] = 0.f;
          cur = id;
          have = true;
        }
        // this stage's run of the id: its d_out rows into G^ (each lane its
        // own columns), several rows in flight
        int e = j + 1;
        while (e < n && s_id[e] == id) ++e;
        for (int i = lane; i < m.D; i += 32) {
          float acc = w.Gh[i];
#pragma unroll 4
          for (int jj = j; jj < e; ++jj) acc += to_f32(dout[(long long)s_pos[jj] * m.D + i]);
          w.Gh[i] = acc;
        }
        j = e;
      }
    }
    if (have) {
      __syncwarp();
      grads_id<T>(d, m, cores, w, grad);
      grads_flush<T>(d, m, cores, w, grad);
    }
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

// One wave: as many CTAs as fit on the card at once, fewer if there are
// fewer chunks than warps.
template <int T, typename DT>
cudaError_t launch_grads(const int* ids, const long long* perm, const DT* dout, long long B,
                         int chunk, const CorePtrs& c, const TTMeta& m, float* grad,
                         cudaStream_t st) {
  auto kernel = tt_grads_kernel<T, DT>;
  const size_t smem =
      kWarpsPerBlock * (sizeof(float) * (2 * m.P_total + m.D) + sizeof(int) * 2 * kStage);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpsPerBlock * 32, smem);
  if (e != cudaSuccess) return e;
  const long long want = ((B + chunk - 1) / chunk + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(want < cap ? want : cap), kWarpsPerBlock * 32, smem, st>>>(
      ids, perm, dout, B, chunk, c, m, grad);
  return cudaGetLastError();
}

template <typename DT>
cudaError_t launch_grads_T(const int* ids, const long long* perm, const DT* dout, long long B,
                           int chunk, const CorePtrs& c, const TTMeta& m, float* grad,
                           cudaStream_t st) {
  switch (m.T) {
    case 2: return launch_grads<2, DT>(ids, perm, dout, B, chunk, c, m, grad, st);
    case 3: return launch_grads<3, DT>(ids, perm, dout, B, chunk, c, m, grad, st);
    case 4: return launch_grads<4, DT>(ids, perm, dout, B, chunk, c, m, grad, st);
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
// gradients, core after core in the flat layout, from ids (B,) int32 in
// ascending order and perm (B,) int64, the position in d_out (B, D) of each
// sorted id (torch.sort's values and indices).  d_out is f32, or bf16 when
// dout_bf16 is 1.  Each warp takes `chunk` consecutive sorted positions.
int tt_grads(const void* ids, const void* perm, const void* dout, int dout_bf16, long long B,
             int chunk, const int* spec, const void* c0, const void* c1, const void* c2,
             const void* c3, void* grad, void* stream) {
  TTMeta m;
  if (!make_meta(spec, &m) || chunk <= 0 || B < 0 || B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const CorePtrs c = core_ptrs(c0, c1, c2, c3);
  const int* id = static_cast<const int*>(ids);
  const long long* pos = static_cast<const long long*>(perm);
  float* out = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dout_bf16)
    return launch_grads_T(id, pos, static_cast<const __nv_bfloat16*>(dout), B, chunk, c, m,
                          out, st);
  return launch_grads_T(id, pos, static_cast<const float*>(dout), B, chunk, c, m, out, st);
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
