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
// tt_fwd  replaces falcon_ttdforgnns_tpu/ops/tt_pallas.py:_fwd_kernel (f32 or
//   bf16 store) and :_fwd_kernel_sr (bf16 store by stochastic rounding).
//   Row b is the chain C_0[d_0] C_1[d_1] ... C_{T-1}[d_{T-1}] at id b's
//   digits.  Ids that share a prefix (digits d_0..d_{T-2}, i.e. id // p_{T-1})
//   share the left partial P_{T-2}, and equal ids share the whole row.  So
//   the ids come sorted, with their positions in the output (the wrapper's
//   grouped_order: the same sort tt_grads takes, made once a step and given
//   to both), and one warp walks a chunk of `chunk` consecutive sorted
//   positions on a 1-D grid of one wave, as tt_grads does:
//     per segment (one prefix within the chunk): P_{T-2}, recomputed from the
//       first digit that changed, P_k[l, m] = sum_r P_{k-1}[l, r] C_k[d_k][r, m];
//     per piece (one distinct id within the chunk): the last level
//       row[l, u] = sum_r P_{T-2}[l, r] C_{T-1}[d_{T-1}][r, u], into the
//       warp's shared memory (d_{T-1} = id - (id / p_{T-1}) p_{T-1});
//     per position j of that id: the row stored to out[perm[j]], the lanes on
//       consecutive values (f32 four at a time where D % 4 == 0, bf16 in
//       pairs where D is even).
//   Each product is one warp_mm (below): a lane owns 2 x 2 outputs, so each
//   value it loads feeds two FMAs, and steps its output block without an
//   integer division.  Each output element's arithmetic is the per-id
//   chain's: fmaf over the input rank in ascending order from 0.f, so the f32
//   rows are bit for bit those of the per-id kernel this replaces.  Three
//   stores (template Store): f32; bf16 by round-to-nearest-even
//   (__float2bfloat16_rn, the rounding of JAX's astype); bf16 by stochastic
//   rounding, the bit-exact port of tt_pallas.py:_sr_cast — element (b, f)
//   adds the low 16 bits of splitmix32(seed * 0x9E3779B9 + (b / block) * D *
//   block + f * block + b % block) to its f32 bits and truncates, b the
//   output row perm[j] and not the sorted position, so a row computed once is
//   still dithered apart at each of its positions.  `block` is a parameter of
//   the hash (the Pallas grid block), not of the launch; the seed is read
//   from device memory (no host sync).
//   Why the per-id chain was slow: one warp per id paid 8,000 FMAs an id at
//   the products shapes (p=125,140,140, q=5,5,4, ranks 16,16): 6,400 for
//   P_1, which every id of a prefix recomputed, and 1,600 for the last level;
//   each FMA loaded its core value through __ldg, and each output paid an
//   integer division.  It ran the main path's 937,984 ids in 3.38 ms on an
//   H100, 6.6% of the 0.224 ms that those FMAs take at the f32 peak.
//   Bound on H100 now: the main path's ~720K distinct ids in 17,494 prefix
//   runs need ~1.26 GMAC (1,600 a distinct id, 6,400 a prefix run): 0.038 ms
//   at the 67 TFLOP/s f32 peak, below the output store, 188 MB in bf16
//   (0.056 ms) or 375 MB in f32 (0.113 ms) at 3.35 TB/s, plus the ids (4 B
//   each) and the cores once.  chip_smoke.py computes both from each input's
//   distinct ids and prefix runs.  No tensor cores: after the grouping the
//   FMAs take less time than the store, and TF32 or bf16 MMA would round the
//   chain's products, off the 1e-5 and bit-equal checks against the plain
//   version.  What the work per piece costs, as measured on an H100
//   (scripts/torch_kernel_times.py, chip_smoke.py; PERF.md): a first
//   version read P_{T-2} in place, where the last level's lanes, two rows
//   each, found all their rows in one shared-memory bank (row stride r = 16
//   floats): 1.49 ms a main-path step.  A transposed copy of P_{T-2}, made
//   once per segment, gives them consecutive words: 0.70 ms.  The digits are
//   divided out once per segment (a piece takes its last digit from the
//   prefix, one division) and the last level's lane tiling is computed once
//   per launch: 0.74 -> 0.58 ms on 937,984 uniform ids.  Per warp in shared
//   memory: the row (D floats), P_0..P_{T-2} (P_total), P_{T-2} transposed
//   and 32 staged (id, position) pairs: 4.2 KB at the products shapes, so
//   four 8-warp CTAs fit an SM at <= 64 registers a thread (no spills but
//   for the 4-core f32 store's 56 bytes; at <= 80 registers, three CTAs, the
//   uniform ids took 0.61 ms).  The state grows with the ranks (57 KB a warp
//   at the products shapes and ranks 256, 256), so a CTA has 8 warps where
//   8 warps' state fits the card's 227 KB a CTA, else 4, 2 or 1 (tt_grads
//   likewise).  Measured: PERF.md.
//
// tt_grads  replaces tt_pallas.py:_bwd_kernel.
//   The backward is linear in d_out, and ids that share a prefix (digits
//   d_0..d_{T-2}, i.e. id // p_{T-1}) share the left partials P_0..P_{T-2}
//   and the core rows C_0..C_{T-2}.  So the ids are walked in sorted order
//   (grouped_order's torch.sort, the one tt_fwd took in the same step, gives
//   the sorted ids and the permutation into d_out) and most of the chain is
//   paid once per run of one prefix:
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
//   once, 188 MB in bf16 for 937,984 ids, plus the ids at 4 B each, the
//   cores and the gradient: ~0.06 ms at 3.35 TB/s) and
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
//     per value.  Products and sums are written out with __fmul_rn /
//     __fadd_rn so nvcc contracts nothing into an FMA: the kernels repeat
//     the plain versions' arithmetic operation for operation.
//   tt_adagrad_apply rowwise (the same Pallas kernel's rowwise finalize):
//     one accumulator per p-row of each core, a[r] += mean(g[r, :]^2), then
//     core[r, :] -= lr * g[r, :] / (sqrt(a[r]) + eps) over the row's F_k =
//     r_k q_k r_{k+1} contiguous values.  Bound: the bytes, 2.4 MB of core
//     and gradient at the products shapes, 0.7 us at 3.35 TB/s: the launch
//     sets its time.  A first version gave each row one warp, which walked
//     core 1's 1,280-value rows serially (40 dependent loads for the sum,
//     then 40 read-modify-writes re-reading g), found its core with a
//     search over the row offsets and indexed the pointer struct by it (a
//     copy of the struct to local memory per thread): 10.7 us on an H100.
//     Now one CTA of kRowThreads takes a row (grid (rows, T), one wave;
//     blockIdx.y picks the core from separate pointer parameters, as in
//     tt_sgd_kernel), holds the row's gradient in registers between the sum
//     and the update (float4 loads where core and gradient are 16-byte
//     aligned and F_k % 4 == 0, a scalar path otherwise; rows longer than
//     kRowVecs float4 a thread read the rest of g again), and sums with warp
//     shuffles and one shared-memory step.  The update keeps the plain
//     version's roundings (__fdiv_rn, no FMA); only the order of the row's
//     sum of g^2 differs.  Measured on an H100 (PERF.md): 2.6 us on the
//     device against 10.7 us; loading the row's core values with g, so that
//     the update waits on one round trip to memory, took 3.3 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_info.cuh"

namespace {

constexpr int kMaxCores = 4;
// Warps a CTA of tt_fwd and tt_grads: kWarpsPerBlock (their launch bounds)
// where that many warps' shared memory fits a CTA, else 4, 2 or 1
// (warps_for); the kernels read the count from blockDim.
constexpr int kWarpsPerBlock = 8;
constexpr int kWarpChoices[] = {8, 4, 2, 1};

struct TTMeta {
  int T;
  int D;                      // embedding dim = prod(q)
  int p[kMaxCores];
  int q[kMaxCores];
  int r[kMaxCores + 1];       // full ranks (1, r_1, ..., r_{T-1}, 1)
  int stride[kMaxCores];
  int L[kMaxCores + 1];       // L[k] = prod(q_0 .. q_{k-1}), L[0] = 1
  int F[kMaxCores];           // core row size r_k * q_k * r_{k+1}
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
constexpr int kRowThreads = 256;  // rowwise adagrad: one CTA a row
constexpr int kRowVecs = 4;       // float4 of g a thread holds: rows up to 4,096 values read once
constexpr int kGradsBlocksPerSM = 4;  // tt_grads: 32 warps an SM, <= 64 registers a thread
constexpr int kFwdBlocksPerSM = 4;    // tt_fwd: the same
constexpr int kStage = 32;            // sorted positions a warp stages at a time

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
  m->P_total = 0;
  m->off[0] = 0;
  for (int k = 0; k < m->T; ++k) {
    if (m->p[k] <= 0 || m->q[k] <= 0 || m->r[k] <= 0 || m->r[k + 1] <= 0 ||
        m->stride[k] <= 0)
      return false;
    m->L[k + 1] = m->L[k] * m->q[k];
    m->F[k] = m->r[k] * m->q[k] * m->r[k + 1];
    const int level = m->L[k + 1] * m->r[k + 1];
    if (k < m->T - 1) m->P_total += level;
    m->off[k + 1] = m->off[k] + (long long)m->p[k] * m->F[k];
  }
  m->D = m->L[m->T];
  // row-major digits: the walks take id / p_{T-1} as the prefix
  for (int k = 0; k < m->T; ++k)
    if (m->stride[k] != (k == m->T - 1 ? 1 : m->stride[k + 1] * m->p[k + 1])) return false;
  return m->r[0] == 1 && m->r[m->T] == 1;
}

template <int T>
__device__ __forceinline__ void digits_of(int id, const TTMeta& m, int* d) {
#pragma unroll
  for (int k = 0; k < T; ++k) d[k] = (id / m.stride[k]) % m.p[k];
}

// ---------------------------------------------------------- tt_fwd's stores
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ------------------------------------------------- the chain's warp products
// One warp's share of an R x C product out(i, j) = sum_k A(i, k) B(k, j),
// A(i, k) = A[i * ai + k * ak] in shared memory, B(k, j) = B[k * bk + j *
// bj] in shared memory or, with kGlobalB, in global memory (a core row,
// read through the read-only cache).  A lane owns blocks of RB rows x CB
// columns: per k it loads RB values of A and CB of B for RB * CB FMAs.
// Blocks go to the lanes in order, each lane's next block found by adding
// the fixed step (32 blocks) without a division; rows and columns past the
// edge load a clamped address and emit nothing.  emit(i, j, value) takes
// every result.
// Which RB x CB output blocks of an R x C product the lane takes: the first
// (ib, jb), the step (di, dj) to its next, 32 blocks on, and the count of
// blocks.  A product of fixed shape computes this once (tt_fwd's last level).
struct Tiling {
  int ncb, items, di, dj, ib, jb;
};

template <int RB, int CB>
__device__ __forceinline__ Tiling tiling(int R, int C) {
  const int lane = threadIdx.x & 31;
  Tiling t;
  t.ncb = (C + CB - 1) / CB;
  t.items = ((R + RB - 1) / RB) * t.ncb;
  t.di = 32 / t.ncb;
  t.dj = 32 % t.ncb;
  t.ib = lane / t.ncb;
  t.jb = lane % t.ncb;
  return t;
}

template <int RB, int CB, bool kGlobalB, class Emit>
__device__ __forceinline__ void warp_mm(const Tiling& tl, int R, int C, int K, const float* A,
                                        int ai, int ak, const float* B, int bk, int bj,
                                        Emit emit) {
  const int lane = threadIdx.x & 31;
  const int ncb = tl.ncb, di = tl.di, dj = tl.dj;
  int ib = tl.ib, jb = tl.jb;
  for (int it = lane; it < tl.items; it += 32) {
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

template <int RB, int CB, bool kGlobalB, class Emit>
__device__ __forceinline__ void warp_mm(int R, int C, int K, const float* A, int ai, int ak,
                                        const float* B, int bk, int bj, Emit emit) {
  warp_mm<RB, CB, kGlobalB>(tiling<RB, CB>(R, C), R, C, K, A, ai, ak, B, bk, bj, emit);
}

// P_k for k = f .. T-2 at the prefix digits d (P_0 is the core-0 row), P_k
// (L_{k+1}, r_{k+1}) at P + poff[k]: tt_fwd's and tt_grads' left partials.
template <int T>
__device__ __forceinline__ void left_partials(int f, const int* d, const TTMeta& m,
                                              const CorePtrs& cores, float* P,
                                              const int* poff) {
  const int lane = threadIdx.x & 31;
  if (f == 0) {
    const float* c0 = cores.c[0] + (long long)d[0] * m.F[0];
    for (int i = lane; i < m.F[0]; i += 32) P[i] = __ldg(c0 + i);
    __syncwarp();
  }
#pragma unroll
  for (int k = 1; k < T - 1; ++k) {
    if (k < f) continue;
    const int rk = m.r[k], Mk = m.q[k] * m.r[k + 1];
    float* out = P + poff[k];
    warp_mm<2, 2, true>(m.L[k], Mk, rk, P + poff[k - 1], rk, 1,
                        cores.c[k] + (long long)d[k] * m.F[k], Mk, 1,
                        [&](int i, int j, float v) { out[i * Mk + j] = v; });
    __syncwarp();
  }
}

// The first prefix digit (0 .. T-2) in which nd differs from d, else T - 1.
template <int T>
__device__ __forceinline__ int first_changed(const int* nd, const int* d) {
  int f = T - 1;
#pragma unroll
  for (int k = T - 2; k >= 0; --k)
    if (nd[k] != d[k]) f = k;
  return f;
}

// ---------------------------------------------------------------- tt_fwd
// Floats of one warp's shared memory: the current id's f32 row (D), P_0 ..
// P_{T-2} (P_total), P_{T-2} transposed (L_{T-1} r_{T-1}), each rounded up
// to 4 floats so that the row is read 16 bytes at a time, then kStage
// staged ids and kStage positions.
__host__ __device__ __forceinline__ int fwd_warp_floats(const TTMeta& m) {
  return ((m.D + 3) & ~3) + ((m.P_total + 3) & ~3) +
         ((m.L[m.T - 1] * m.r[m.T - 1] + 3) & ~3) + 2 * kStage;
}

// One row of D values from shared memory to dst in global memory, the lanes
// on consecutive values, `vec` at a time (4 or 2 where D and dst allow, else
// 1; a bf16 store writes pairs for 4 and 2).  salt: the SR hash's salt of
// element 0; element f adds f * block.
template <Store S>
__device__ __forceinline__ void store_row(typename OutOf<S>::type* __restrict__ dst,
                                          const float* row, int D, int vec, unsigned salt,
                                          unsigned block) {
  const int lane = threadIdx.x & 31;
  if constexpr (S == Store::kF32) {
    if (vec == 4) {
      for (int i = lane; i < D / 4; i += 32)
        reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(row)[i];
    } else if (vec == 2) {
      for (int i = lane; i < D / 2; i += 32)
        reinterpret_cast<float2*>(dst)[i] = reinterpret_cast<const float2*>(row)[i];
    } else {
      for (int i = lane; i < D; i += 32) dst[i] = row[i];
    }
  } else if (vec >= 2) {
    for (int i = lane; i < D / 2; i += 32) {
      const float2 v = reinterpret_cast<const float2*>(row)[i];
      const unsigned s0 = salt + (unsigned)(2 * i) * block;
      reinterpret_cast<unsigned*>(dst)[i] =
          (unsigned)convert_out<S>(v.x, s0) | ((unsigned)convert_out<S>(v.y, s0 + block) << 16);
    }
  } else {
    for (int i = lane; i < D; i += 32) dst[i] = convert_out<S>(row[i], salt + (unsigned)i * block);
  }
}

// ids: sorted (B,); perm: their rows in out (B, D).  Warps take chunks of
// `chunk` sorted positions; see the note at the top of the file.
template <int T, Store S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kFwdBlocksPerSM)
tt_fwd_kernel(const int* __restrict__ ids, const long long* __restrict__ perm, long long B,
              int chunk, CorePtrs cores, TTMeta m, typename OutOf<S>::type* __restrict__ out,
              const int* __restrict__ seed, unsigned block, int vec) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  constexpr int K = T - 1;
  const int q = m.q[K], rl = m.r[K], Ll = m.L[K];
  float* row = smem + warp * fwd_warp_floats(m);
  float* P = row + ((m.D + 3) & ~3);
  float* PT = P + ((m.P_total + 3) & ~3);  // P_{T-2} transposed, (r_{T-1}, L_{T-1})
  int* s_id = reinterpret_cast<int*>(PT + ((Ll * rl + 3) & ~3));
  int* s_pos = s_id + kStage;
  int poff[kMaxCores];
  poff[0] = 0;
#pragma unroll
  for (int k = 1; k < T - 1; ++k) poff[k] = poff[k - 1] + m.L[k] * m.r[k];
  const float* last = P + poff[T - 2];  // P_{T-2} (L_{T-1}, r_{T-1})
  const Tiling tl = tiling<2, 2>(Ll, q);  // the last level's, the same for every piece
  const unsigned p_last = (unsigned)m.p[K];
  unsigned seed_mix = 0;
  if constexpr (S == Store::kBF16SR) seed_mix = (unsigned)__ldg(seed) * 0x9E3779B9u;
  const unsigned row_step = (unsigned)m.D * block;  // the SR salt of row b + block

  const long long n_chunks = (B + chunk - 1) / chunk;
  for (long long c = (long long)blockIdx.x * warps + warp; c < n_chunks;
       c += (long long)gridDim.x * warps) {
    const long long hi = (c + 1) * chunk < B ? (c + 1) * chunk : B;
    int d[T] = {};  // digits of the current id
    int cur = 0;
    unsigned cur_pre = 0;  // its prefix, id / p_{T-1}
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
          // the prefix digits only where the prefix changed (a segment)
          const unsigned pre = (unsigned)id / p_last;
          int f = T - 1;
          if (!have || pre != cur_pre) {
            int nd[T];
            digits_of<T>(id, m, nd);
            f = have ? first_changed<T>(nd, d) : 0;
#pragma unroll
            for (int k = 0; k < T - 1; ++k) d[k] = nd[k];
            cur_pre = pre;
          }
          d[K] = (int)((unsigned)id - pre * p_last);
          __syncwarp();  // the last piece's row is stored
          if (f < T - 1) {
            left_partials<T>(f, d, m, cores, P, poff);
            // the last level's lanes read P_{T-2} down its columns: from the
            // transpose they read consecutive words, from P_{T-2} itself
            // every lane's rows would fall in one shared-memory bank
            for (int o = lane; o < Ll * rl; o += 32) {
              const int l = o / rl;
              PT[(o - l * rl) * Ll + l] = last[o];
            }
            __syncwarp();
          }
          warp_mm<2, 2, true>(tl, Ll, q, rl, PT, 1, Ll, cores.c[K] + (long long)d[K] * m.F[K],
                              q, 1, [&](int i, int u, float v) { row[i * q + u] = v; });
          __syncwarp();
          cur = id;
          have = true;
        }
        // this stage's run of the id: its row to each of its positions
        for (; j < n && s_id[j] == id; ++j) {
          const unsigned b = (unsigned)s_pos[j];
          unsigned salt = 0;
          if constexpr (S == Store::kBF16SR) salt = seed_mix + (b / block) * row_step + b % block;
          store_row<S>(out + (long long)b * m.D, row, m.D, vec, salt, block);
        }
      }
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
  const int warps = blockDim.x >> 5;
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
  for (long long c = (long long)blockIdx.x * warps + warp; c < n_chunks;
       c += (long long)gridDim.x * warps) {
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
          const int f = have ? first_changed<T>(nd, d) : 0;
          if (have) {
            __syncwarp();  // G^ complete
            grads_id<T>(d, m, cores, w, grad);
            if (f < T - 1) grads_flush<T>(d, m, cores, w, grad);
          }
#pragma unroll
          for (int k = 0; k < T; ++k) d[k] = nd[k];
          if (f < T - 1) left_partials<T>(f, d, m, cores, w.P, w.poff);
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

__device__ __forceinline__ float sq_sum(float s, float4 v) {
  s = __fadd_rn(s, __fmul_rn(v.x, v.x));
  s = __fadd_rn(s, __fmul_rn(v.y, v.y));
  s = __fadd_rn(s, __fmul_rn(v.z, v.z));
  return __fadd_rn(s, __fmul_rn(v.w, v.w));
}

__device__ __forceinline__ float adagrad_step(float c, float g, float lr, float den) {
  return __fsub_rn(c, __fdiv_rn(__fmul_rn(lr, g), den));
}

__device__ __forceinline__ float4 adagrad_step4(float4 c, float4 g, float lr, float den) {
  c.x = adagrad_step(c.x, g.x, lr, den);
  c.y = adagrad_step(c.y, g.y, lr, den);
  c.z = adagrad_step(c.z, g.z, lr, den);
  c.w = adagrad_step(c.w, g.w, lr, den);
  return c;
}

// The CTA's sum of v, in every thread: shuffles within each warp, one
// shared-memory step across the warps (red: kRowThreads / 32 floats, used
// by every other row, so a fast warp cannot overwrite what a slow one reads).
__device__ __forceinline__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < kRowThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rowwise: grid (x, T), blockIdx.y the core, the x CTAs stride over its p_k
// rows, one row a CTA at a time; a[k] holds one accumulator per row of core k.
__global__ void __launch_bounds__(kRowThreads) tt_rowwise_adagrad_kernel(
    float* c0, float* c1, float* c2, float* c3, float* a0, float* a1, float* a2, float* a3,
    const float* g0, const float* g1, const float* g2, const float* g3, int p0, int p1,
    int p2, int p3, int F0, int F1, int F2, int F3, float lr, float eps) {
  __shared__ float red[2][kRowThreads / 32];
  const unsigned k = blockIdx.y;
  float* c = k == 0 ? c0 : k == 1 ? c1 : k == 2 ? c2 : c3;
  float* a = k == 0 ? a0 : k == 1 ? a1 : k == 2 ? a2 : a3;
  const float* g = k == 0 ? g0 : k == 1 ? g1 : k == 2 ? g2 : g3;
  const int p = k == 0 ? p0 : k == 1 ? p1 : k == 2 ? p2 : p3;
  const int F = k == 0 ? F0 : k == 1 ? F1 : k == 2 ? F2 : F3;
  const int t = threadIdx.x;
  const bool vec =
      (F & 3) == 0 && ((reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  const int n4 = vec ? F >> 2 : 0;
  int parity = 0;
  for (int r = blockIdx.x; r < p; r += gridDim.x, parity ^= 1) {
    const float* gr = g + (long long)r * F;
    float* cr = c + (long long)r * F;
    const float4* g4 = reinterpret_cast<const float4*>(gr);
    float4* c4 = reinterpret_cast<float4*>(cr);
    float4 held[kRowVecs];
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < kRowVecs; ++v) {
      const int i = t + v * kRowThreads;
      if (i < n4) {
        held[v] = __ldg(g4 + i);
        sq = sq_sum(sq, held[v]);
      }
    }
    for (int i = t + kRowVecs * kRowThreads; i < n4; i += kRowThreads) sq = sq_sum(sq, __ldg(g4 + i));
    for (int i = 4 * n4 + t; i < F; i += kRowThreads) {
      const float x = __ldg(gr + i);
      sq = __fadd_rn(sq, __fmul_rn(x, x));
    }
    const float before = a[r];  // read before the barrier in cta_sum; thread 0 writes after it
    const float acc = __fadd_rn(before, __fdiv_rn(cta_sum(sq, red[parity]), (float)F));
    const float den = __fadd_rn(sqrtf(acc), eps);
#pragma unroll
    for (int v = 0; v < kRowVecs; ++v) {
      const int i = t + v * kRowThreads;
      if (i < n4) c4[i] = adagrad_step4(c4[i], held[v], lr, den);
    }
    for (int i = t + kRowVecs * kRowThreads; i < n4; i += kRowThreads)
      c4[i] = adagrad_step4(c4[i], __ldg(g4 + i), lr, den);
    for (int i = 4 * n4 + t; i < F; i += kRowThreads)
      cr[i] = adagrad_step(cr[i], __ldg(gr + i), lr, den);
    if (t == 0) a[r] = acc;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Warps a CTA for `warp_bytes` of shared memory a warp: the first of
// kWarpChoices whose CTA fits the card's largest dynamic shared memory, 0 if
// not even one warp fits.  8 covers the products shapes at ranks up to ~118
// (tt_grads) or ~129 (tt_fwd); at ranks 256, 256 a warp takes 57 KB
// (tt_fwd) or 62 KB (tt_grads), and a CTA 4 or 2 warps.
int warps_for(size_t warp_bytes) {
  for (int w : kWarpChoices)
    if ((size_t)w * warp_bytes <= (size_t)max_dynamic_smem()) return w;
  return 0;
}

// One wave of `kernel` in CTAs of `warps` warps over the chunks of B sorted
// positions: as many CTAs as fit on the card at once, fewer if there are
// fewer chunks than warps.
template <typename K>
cudaError_t one_wave(K kernel, int warps, size_t smem, long long B, int chunk,
                     unsigned* grid) {
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (e != cudaSuccess) return e;
  const long long want = ((B + chunk - 1) / chunk + warps - 1) / warps;
  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(want < cap ? want : cap);
  return cudaSuccess;
}

template <int T, Store S>
cudaError_t launch_fwd(const int* ids, const long long* perm, long long B, int chunk,
                       const CorePtrs& c, const TTMeta& m, void* out, const int* seed,
                       unsigned block, cudaStream_t st) {
  auto kernel = tt_fwd_kernel<T, S>;
  const int warps = warps_for(sizeof(float) * fwd_warp_floats(m));
  if (warps == 0) return cudaErrorInvalidConfiguration;  // not one warp's state fits
  const size_t smem = sizeof(float) * warps * fwd_warp_floats(m);
  unsigned grid = 0;
  cudaError_t e = one_wave(kernel, warps, smem, B, chunk, &grid);
  if (e != cudaSuccess) return e;
  // values a lane stores at once: rows start at multiples of D values
  const int vec = (reinterpret_cast<uintptr_t>(out) & 15) ? 1
                  : m.D % 4 == 0 ? 4 : m.D % 2 == 0 ? 2 : 1;
  kernel<<<grid, warps * 32, smem, st>>>(
      ids, perm, B, chunk, c, m, static_cast<typename OutOf<S>::type*>(out), seed, block, vec);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_fwd_store(int out_kind, const int* ids, const long long* perm, long long B,
                             int chunk, const CorePtrs& c, const TTMeta& m, void* out,
                             const int* seed, unsigned block, cudaStream_t st) {
  switch (out_kind) {
    case 0: return launch_fwd<T, Store::kF32>(ids, perm, B, chunk, c, m, out, seed, block, st);
    case 1: return launch_fwd<T, Store::kBF16>(ids, perm, B, chunk, c, m, out, seed, block, st);
    case 2:
      return launch_fwd<T, Store::kBF16SR>(ids, perm, B, chunk, c, m, out, seed, block, st);
  }
  return cudaErrorInvalidValue;
}

template <int T, typename DT>
cudaError_t launch_grads(const int* ids, const long long* perm, const DT* dout, long long B,
                         int chunk, const CorePtrs& c, const TTMeta& m, float* grad,
                         cudaStream_t st) {
  auto kernel = tt_grads_kernel<T, DT>;
  const size_t warp_bytes = sizeof(float) * (2 * m.P_total + m.D) + sizeof(int) * 2 * kStage;
  const int warps = warps_for(warp_bytes);
  if (warps == 0) return cudaErrorInvalidConfiguration;  // not one warp's state fits
  const size_t smem = warps * warp_bytes;
  unsigned grid = 0;
  cudaError_t e = one_wave(kernel, warps, smem, B, chunk, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, warps * 32, smem, st>>>(ids, perm, dout, B, chunk, c, m, grad);
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

// out (B, D) <- rows of the TT table, from ids (B,) int32 in ascending order
// and perm (B,) int64, the row of out that each sorted id fills (torch.sort's
// values and indices), stored as out_kind 0: f32; 1: bf16, round to nearest
// even; 2: bf16, stochastic rounding with the int32 at `seed` (device) and
// the hash's `block`.  Each warp takes `chunk` consecutive sorted positions.
int tt_fwd(const void* ids, const void* perm, long long B, int chunk, const int* spec,
           const void* c0, const void* c1, const void* c2, const void* c3, void* out,
           int out_kind, const void* seed, int block, void* stream) {
  TTMeta m;
  if (!make_meta(spec, &m) || chunk <= 0 || B < 0 || B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (out_kind == 2 && (seed == nullptr || block <= 0)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const CorePtrs c = core_ptrs(c0, c1, c2, c3);
  const int* id = static_cast<const int*>(ids);
  const long long* pos = static_cast<const long long*>(perm);
  const int* sd = static_cast<const int*>(seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m.T) {
    case 2: return launch_fwd_store<2>(out_kind, id, pos, B, chunk, c, m, out, sd, block, st);
    case 3: return launch_fwd_store<3>(out_kind, id, pos, B, chunk, c, m, out, sd, block, st);
    case 4: return launch_fwd_store<4>(out_kind, id, pos, B, chunk, c, m, out, sd, block, st);
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
  if (!rowwise) {
    tt_adagrad_kernel<<<elementwise_blocks(a), 256, 0, st>>>(a, lr, eps);
    return cudaGetLastError();
  }
  int p[kMaxCores] = {}, f[kMaxCores] = {1, 1, 1, 1};
  long long most = 0;
  for (int k = 0; k < T; ++k) {
    const long long rows = a.row_off[k + 1] - a.row_off[k];
    if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
    p[k] = (int)rows;
    f[k] = a.F[k];
    if (rows > most) most = rows;
  }
  // one wave: the CTAs that fit on the card at once, shared by the T cores
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tt_rowwise_adagrad_kernel, kRowThreads, 0);
  if (e != cudaSuccess) return e;
  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1) / T;
  const dim3 grid((unsigned)(most < cap ? most : (cap < 1 ? 1 : cap)), (unsigned)T);
  tt_rowwise_adagrad_kernel<<<grid, kRowThreads, 0, st>>>(
      a.core[0], a.core[1], a.core[2], a.core[3], a.s1[0], a.s1[1], a.s1[2], a.s1[3], a.g[0],
      a.g[1], a.g[2], a.g[3], p[0], p[1], p[2], p[3], f[0], f[1], f[2], f[3], lr, eps);
  return cudaGetLastError();
}

}  // extern "C"
