// Hopper (sm_90a) kernels for the full-graph SpMMs: the tiled segment sum
// (--spmm pallas), its per-tile partials, and the window gather of the
// blocked SpMM (--spmm blocked).  Built by nvcc into a shared library with a
// plain C interface and loaded through ctypes (falcon_ttdforgnns_torch/ops/
// _build.py); the Python wrappers live in ops/spmm_tiled.py and
// ops/spmm_blocked.py next to their plain versions.
//
// spmm_seg_mm  replaces falcon_ttdforgnns_tpu/ops/spmm_pallas.py:
//   _seg_mm_kernel (through _seg_mm_chunk, spmm_sum_tiled_arrays and
//   spmm_sum_tiled_uniform).  Tiles of E_t slots (src, dstl, w) belong to
//   NR-row output blocks; the TPU kernel turned each tile into one matmul
//   onehot(dstl)*w @ h[src] on the MXU, 2*NR*E_t*D operations per tile where
//   2*E_t*D are useful, and carried a block's sum across consecutive grid
//   steps (the `first` flag).  Hopper runs blocks in no order, so here one
//   CTA owns one (chunk, block) and a 64-column slab of it: it finds the
//   block's tiles in the chunk by binary search on the chunk's non-decreasing
//   block ids, sums w * h[src] over them into an NR x 64 f32 accumulator in
//   shared memory, and writes the block once.  No one-hot, no atomics in
//   device memory, no cross-CTA reduction.  A block that a later chunk also
//   covers is left to that chunk: that is the order in which the reference's
//   scan overwrites the pad blocks of a uniform chunk with the next chunk's
//   rows, so one grid over every chunk gives the reference's result.  Each
//   warp takes a contiguous share of the block's slots; dst-sorted slots
//   make runs of one row, summed in registers and added to shared memory
//   once per run (shared f32 atomics, so where a row's run spans two warps
//   the two partial sums meet in either order).  A slot with weight 0 (the
//   tilers' padding), a dstl outside [0, NR) (the one-hot of the reference
//   matches no row) or a src outside h adds nothing.  The 32 slots a warp
//   reads next are loaded one per lane and broadcast by shuffles; four rows
//   of h are in flight per warp.  h may be f32 or bf16 (upcast exactly); with
//   bf16_w the weight is rounded to bf16 as well, the reference's bf16
//   compute: both factors bf16, their product exact in f32, the sum in f32.
//   Bound on H100: the random row reads of h (one 64-column slab of a row per
//   slot: 256 B in f32) and the index stream; the compulsory bytes (h, the
//   slots, out, each once) over 3.35 TB/s are a few ms at products scale.
//   Measured: PERF.md.
//
// spmm_tile_mm  replaces spmm_pallas.py:_tile_mm_kernel (through
//   spmm_sum_tile_partials): the same accumulation, one CTA per tile (and
//   slab), each writing its own (NR, D) partial; the segment sum of the
//   partials by block stays a torch op, as it was XLA outside Pallas.
//
// spmm_window_gather  replaces falcon_ttdforgnns_tpu/ops/spmm_blocked.py:
//   _gather_kernel (through _gather_msgs, spmm_sum_blocked_dev and
//   apply_blocked_spmm): msgs[t*T + j] = h[win[t]*T/2 + idx[t*T + j]] *
//   w[t*T + j] in h's dtype.  The TPU kernel copied a T-row window of h into
//   VMEM and gathered from there; Hopper's L1/L2 do that without being told,
//   so one warp per slot reads the row straight from h (coalesced across
//   lanes) with a row bound check in place of the reference's zero padding
//   of h.  The product is one rounding (__fmul_rn in f32; in bf16 the product
//   of two bf16 values is exact in f32 and is rounded once to bf16), so the
//   kernel is bit-identical to its plain version.  Bound: bytes (each message
//   written once, a row of h read per slot).  The scatter-add of the
//   messages into the (N, D) accumulator is torch's index_add_, as the
//   reference's scatter sat outside Pallas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 64;     // output columns per CTA: two per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kInFlight = 4;  // rows of h a warp loads before it sums them

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void flush(float* acc, int row, int lane, float a0, float a1) {
  atomicAdd(&acc[row * kSlab + lane], a0);
  atomicAdd(&acc[row * kSlab + lane + 32], a1);
}

// Adds w * h[src] over slots [lo, hi) into acc (NR rows of kSlab floats in
// shared memory), columns [c0, c0 + kSlab) of h.
template <typename HT, bool kBf16W>
__device__ void accumulate(const HT* __restrict__ h, long long n_rows, int D, int c0,
                           const int* __restrict__ src, const int* __restrict__ dstl,
                           const float* __restrict__ w, long long lo, long long hi,
                           int NR, float* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = (hi - lo + kWarps - 1) / kWarps;
  const long long wlo = lo + warp * per;
  const long long whi = wlo + per < hi ? wlo + per : hi;
  const int ca = c0 + lane, cb = c0 + lane + 32;
  const bool va = ca < D, vb = cb < D;
  float a0 = 0.f, a1 = 0.f;
  int cur = -1;
  for (long long base = wlo; base < whi; base += 32) {
    const long long e = base + lane;
    int s = 0, dl = -1;
    float wv = 0.f;
    if (e < whi) {
      s = src[e];
      dl = dstl[e];
      wv = w[e];
      if (kBf16W) wv = round_bf16(wv);
    }
    if (wv == 0.f || (unsigned)dl >= (unsigned)NR || s < 0 || (long long)s >= n_rows)
      dl = -1;  // adds nothing
    for (int k = 0; k < 32; k += kInFlight) {
      int sk[kInFlight], dk[kInFlight];
      float wk[kInFlight], xa[kInFlight], xb[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        sk[u] = __shfl_sync(0xffffffffu, s, k + u);
        dk[u] = __shfl_sync(0xffffffffu, dl, k + u);
        wk[u] = __shfl_sync(0xffffffffu, wv, k + u);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const HT* row = h + (long long)sk[u] * D;
        xa[u] = (dk[u] >= 0 && va) ? to_f32(row[ca]) : 0.f;
        xb[u] = (dk[u] >= 0 && vb) ? to_f32(row[cb]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (dk[u] < 0) continue;  // the same for every lane: no divergence
        if (dk[u] != cur) {
          if (cur >= 0) flush(acc, cur, lane, a0, a1);
          cur = dk[u];
          a0 = 0.f;
          a1 = 0.f;
        }
        a0 = fmaf(wk[u], xa[u], a0);
        a1 = fmaf(wk[u], xb[u], a1);
      }
    }
  }
  if (cur >= 0) flush(acc, cur, lane, a0, a1);
}

__device__ __forceinline__ void zero_acc(float* acc, int NR) {
  for (int i = threadIdx.x; i < NR * kSlab; i += kThreads) acc[i] = 0.f;
}

// Rows [row0, row0 + NR) of out (D columns), slab columns [c0, c0 + kSlab).
__device__ __forceinline__ void write_rows(const float* acc, float* __restrict__ out,
                                           long long row0, long long out_rows, int NR,
                                           int D, int c0) {
  for (int i = threadIdx.x; i < NR * kSlab; i += kThreads) {
    const long long row = row0 + i / kSlab;
    const int col = c0 + i % kSlab;
    if (row < out_rows && col < D) out[row * D + col] = acc[i];
  }
}

// First position in the non-decreasing a[0..n) whose value is >= v.
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// grid (C * NBC, ceil(D / kSlab)): CTA (c * NBC + j, slab) owns block
// blk0[c] + j of chunk c.  Chunk c's arrays: slots [c*TC*E_t, (c+1)*TC*E_t)
// of src/dstl/w, block ids blkl[c*TC .. (c+1)*TC) (non-decreasing).
template <typename HT, bool kBf16W>
__global__ void __launch_bounds__(kThreads) seg_mm_kernel(
    const HT* __restrict__ h, long long n_rows, int D, const int* __restrict__ src,
    const int* __restrict__ dstl, const float* __restrict__ w,
    const int* __restrict__ blkl, const int* __restrict__ blk0, int C, int TC, int NBC,
    int NR, int E_t, float* __restrict__ out, long long out_rows) {
  extern __shared__ float acc[];
  const int c = blockIdx.x / NBC, j = blockIdx.x % NBC;
  const long long b = (long long)blk0[c] + j;
  if (c + 1 < C && b >= blk0[c + 1]) return;  // a later chunk writes block b
  const int c0 = blockIdx.y * kSlab;
  zero_acc(acc, NR);
  const int* bl = blkl + (long long)c * TC;
  const int t0 = lower_bound(bl, TC, j), t1 = lower_bound(bl, TC, j + 1);
  __syncthreads();
  const long long base = (long long)c * TC * E_t;
  accumulate<HT, kBf16W>(h, n_rows, D, c0, src, dstl, w, base + (long long)t0 * E_t,
                         base + (long long)t1 * E_t, NR, acc);
  __syncthreads();
  write_rows(acc, out, b * NR, out_rows, NR, D, c0);
}

// grid (n_tiles, ceil(D / kSlab)): CTA (t, slab) writes rows [t*NR, (t+1)*NR)
// of the partials.
template <typename HT, bool kBf16W>
__global__ void __launch_bounds__(kThreads) tile_mm_kernel(
    const HT* __restrict__ h, long long n_rows, int D, const int* __restrict__ src,
    const int* __restrict__ dstl, const float* __restrict__ w, int NR, int E_t,
    float* __restrict__ out) {
  extern __shared__ float acc[];
  const long long t = blockIdx.x;
  const int c0 = blockIdx.y * kSlab;
  zero_acc(acc, NR);
  __syncthreads();
  accumulate<HT, kBf16W>(h, n_rows, D, c0, src, dstl, w, t * E_t, (t + 1) * E_t, NR, acc);
  __syncthreads();
  write_rows(acc, out, t * NR, (long long)gridDim.x * NR, NR, D, c0);
}

__device__ __forceinline__ void set_zero(float* z) { *z = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* z) { *z = __float2bfloat16_rn(0.f); }

__device__ __forceinline__ void store(float* o, float v, float w) { *o = __fmul_rn(v, w); }
__device__ __forceinline__ void store(__nv_bfloat16* o, __nv_bfloat16 v, float w) {
  // bf16 * bf16 is exact in f32: one rounding, to bf16
  *o = __float2bfloat16_rn(__fmul_rn(__bfloat162float(v), round_bf16(w)));
}

// One warp per slot, lanes over the columns.
template <typename HT>
__global__ void __launch_bounds__(kThreads) window_gather_kernel(
    const HT* __restrict__ h, long long n_rows, int D, const int* __restrict__ win,
    const int* __restrict__ idx, const float* __restrict__ w, int T, long long n_slots,
    HT* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long half = T / 2;
  for (long long slot = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       slot < n_slots; slot += warps) {
    const long long row = (long long)win[slot / T] * half + idx[slot];
    const float ws = w[slot];
    const bool in_h = row >= 0 && row < n_rows;  // rows past h are the zero padding
    HT zero;
    set_zero(&zero);
    HT* o = out + slot * D;
    for (int col = lane; col < D; col += 32)
      store(o + col, in_h ? h[row * D + col] : zero, ws);
  }
}

int launch_blocks(long long work, int per_block) {
  long long b = (work + per_block - 1) / per_block;
  const long long cap = 132LL * 16;  // a grid-stride loop past 16 blocks per SM
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

template <typename HT, bool kBf16W>
int launch_seg_mm(const void* h, long long n_rows, int D, const int* src, const int* dstl,
                  const float* w, const int* blkl, const int* blk0, int C, int TC, int NBC,
                  int NR, int E_t, float* out, long long out_rows, cudaStream_t st) {
  const int smem = NR * kSlab * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(seg_mm_kernel<HT, kBf16W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((long long)C * NBC), (unsigned)((D + kSlab - 1) / kSlab));
  seg_mm_kernel<HT, kBf16W><<<grid, kThreads, smem, st>>>(
      static_cast<const HT*>(h), n_rows, D, src, dstl, w, blkl, blk0, C, TC, NBC, NR, E_t,
      out, out_rows);
  return cudaGetLastError();
}

template <typename HT, bool kBf16W>
int launch_tile_mm(const void* h, long long n_rows, int D, const int* src, const int* dstl,
                   const float* w, int n_tiles, int NR, int E_t, float* out,
                   cudaStream_t st) {
  const int smem = NR * kSlab * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tile_mm_kernel<HT, kBf16W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)n_tiles, (unsigned)((D + kSlab - 1) / kSlab));
  tile_mm_kernel<HT, kBf16W><<<grid, kThreads, smem, st>>>(
      static_cast<const HT*>(h), n_rows, D, src, dstl, w, NR, E_t, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Tiled segment sum over C chunks of TC tiles (one chunk and TC = all tiles
// for the flat tiling): out (out_rows, D) f32, block b's rows [b*NR,
// (b+1)*NR).  h is f32 (h_bf16 0) or bf16 (1); bf16_w rounds the weights to
// bf16 (the bf16 compute of the reference).
int spmm_seg_mm(const void* h, int h_bf16, long long n_rows, int D, const int* src,
                const int* dstl, const float* w, const int* blkl, const int* blk0, int C,
                int TC, int NBC, int NR, int E_t, int bf16_w, float* out, long long out_rows,
                void* stream) {
  if (C <= 0 || TC <= 0 || NBC <= 0 || NR <= 0 || E_t <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_bf16)
    return bf16_w ? launch_seg_mm<__nv_bfloat16, true>(h, n_rows, D, src, dstl, w, blkl, blk0,
                                                       C, TC, NBC, NR, E_t, out, out_rows, st)
                  : launch_seg_mm<__nv_bfloat16, false>(h, n_rows, D, src, dstl, w, blkl,
                                                        blk0, C, TC, NBC, NR, E_t, out,
                                                        out_rows, st);
  return bf16_w ? launch_seg_mm<float, true>(h, n_rows, D, src, dstl, w, blkl, blk0, C, TC,
                                             NBC, NR, E_t, out, out_rows, st)
                : launch_seg_mm<float, false>(h, n_rows, D, src, dstl, w, blkl, blk0, C, TC,
                                              NBC, NR, E_t, out, out_rows, st);
}

// One (NR, D) f32 partial per tile: out (n_tiles * NR, D).
int spmm_tile_mm(const void* h, int h_bf16, long long n_rows, int D, const int* src,
                 const int* dstl, const float* w, int n_tiles, int NR, int E_t, int bf16_w,
                 float* out, void* stream) {
  if (n_tiles <= 0 || NR <= 0 || E_t <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_bf16)
    return bf16_w ? launch_tile_mm<__nv_bfloat16, true>(h, n_rows, D, src, dstl, w, n_tiles,
                                                        NR, E_t, out, st)
                  : launch_tile_mm<__nv_bfloat16, false>(h, n_rows, D, src, dstl, w, n_tiles,
                                                         NR, E_t, out, st);
  return bf16_w ? launch_tile_mm<float, true>(h, n_rows, D, src, dstl, w, n_tiles, NR, E_t,
                                              out, st)
                : launch_tile_mm<float, false>(h, n_rows, D, src, dstl, w, n_tiles, NR, E_t,
                                               out, st);
}

// Weighted window gather: out (n_slots, D) in h's dtype.
int spmm_window_gather(const void* h, int h_bf16, long long n_rows, int D, const int* win,
                       const int* idx, const float* w, int T, long long n_slots, void* out,
                       void* stream) {
  if (T <= 0 || T % 2 || D <= 0 || n_slots < 0) return cudaErrorInvalidValue;
  if (n_slots == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = launch_blocks(n_slots, kWarps);
  if (h_bf16)
    window_gather_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h), n_rows, D, win, idx, w, T, n_slots,
        static_cast<__nv_bfloat16*>(out));
  else
    window_gather_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(h), n_rows, D, win, idx, w, T, n_slots,
        static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
