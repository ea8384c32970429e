// Hopper (sm_90a) kernels for the full-graph SpMMs: the tiled segment sum
// (--spmm pallas, the uniform tiling), the flat tiling's sum in place of
// the reference's per-tile partials, and the window gather of the blocked
// SpMM (--spmm blocked).  Built by nvcc into a shared library with a plain
// C interface and loaded through ctypes (falcon_ttdforgnns_torch/ops/
// _build.py); the Python wrappers live in ops/spmm_tiled.py and
// ops/spmm_blocked.py next to their plain versions.
//
// spmm_tile_sum  replaces falcon_ttdforgnns_tpu/ops/spmm_pallas.py:
//   _seg_mm_kernel (through _seg_mm_chunk, spmm_sum_tiled_arrays and
//   spmm_sum_tiled_uniform) and _tile_mm_kernel (through
//   spmm_sum_tile_partials) with the XLA segment sum of its partials.
//   Tiles of E_t slots (src, dstl, w) belong to NR-row output blocks; both
//   TPU kernels turned a tile into one matmul onehot(dstl)*w @ h[src] on the
//   MXU, 2*NR*E_t*D operations where 2*E_t*D are useful.  _seg_mm_kernel
//   carried a block's sum across consecutive grid steps (the `first` flag)
//   in chunks of tiles; _tile_mm_kernel wrote one (NR, D) partial per tile
//   for Mosaic's sake (no revisiting, no data-dependent index maps), ~12 GB
//   at products scale that the result does not need.  Both compute the sum
//   over the tiles' slots of w * h[src] into row block * NR + dstl, so on
//   the card both are this one kernel after one memset of the (num_nodes,
//   D) f32 output.  Bound on H100: the random reads of whole rows of h, one
//   per slot (122M rows of 400 B at D=100 f32, 49 GB: 14.6 ms at 3.35 TB/s),
//   then the slot stream (~1.9 GB) and the output's memset and atomics
//   (~1-2 GB); the compulsory bytes (h, slots, out once each) are ~1.1 ms.
//   Design: one warp owns a range of kRangeSlots slots of one tile (a 1-D
//   grid of one wave strides over (tile, range)), reads the slot stream
//   once, one slot per lane broadcast by shuffles, and covers the whole row:
//   16-byte loads (4 f32 or 8 bf16 values a lane) where D and h's base
//   allow, else one value per load in the same kernel; kRowsInFlight rows
//   of h are in flight per warp, the valid slots compacted by a ballot so
//   padding and dropped slots cost no load.  Each run of one dst row is
//   summed in f32 registers and added to out at the end of the run with a
//   vector atomicAdd (float4, native on sm_90); a row's ~50 terms meet
//   across warps in atomic order, so sums differ from the plain version's
//   by f32 reordering only.  Tile t's block is blkl[t] plus, for the
//   uniform tiling of C chunks of TC tiles, blk0[t / TC]; the flat tiling
//   is one chunk with no blk0.  A block that a later chunk also covers
//   (block >= blk0[c + 1]) belongs to that chunk, whose rows the reference's
//   scan writes last over the pad blocks of chunk c, so a tile of chunk c
//   that reaches it is dropped whole, before its slots are read.  A slot
//   adds nothing when w == 0, dstl is outside [0, NR), src is outside h, or
//   its row is at or past num_nodes (the plain versions sum those into pad
//   rows and slice them off).  bf16 h is upcast exactly.  With bf16 compute
//   the wrapper casts h to bf16 once, as the reference casts before its
//   gather, so the gather reads half the bytes, and the kernel rounds w to
//   bf16 (products exact in f32).  The uniform tiling's pad slots (157.7M
//   slots against the flat tiling's 156.7M at products) cost 12 bytes of
//   stream each.
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

#include "device_info.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsInFlight = 8;  // tile_sum: rows of h a warp loads before it sums them
constexpr int kRangeSlots = 512;  // tile_sum: slots of one tile a warp takes at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ------------------------------------------------------------ tile_sum
// What a lane loads of a row of h: kVN values of type HT in one load (16
// bytes for kVN > 1, one value for kVN == 1).
template <typename HT, int kVN> struct Load { using type = uint4; };
template <typename HT> struct Load<HT, 1> { using type = HT; };

template <typename HT, int kVN>
__device__ __forceinline__ typename Load<HT, kVN>::type load_h(const HT* p) {
  if constexpr (kVN == 1) return *p;  // h is read-only for the kernel's life
  else return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename HT, int kVN>
__device__ __forceinline__ void unpack(const typename Load<HT, kVN>::type& x, float* v) {
  if constexpr (kVN == 1) {
    v[0] = to_f32(x);
  } else {
    const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kVN == 4) {  // f32
        v[i] = __uint_as_float(u[i]);
      } else {  // 8 bf16: the low half of each word is the lower column
        v[2 * i] = __uint_as_float(u[i] << 16);
        v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
      }
    }
  }
}

// Sums w * h[src] over the valid slots [lo, hi) of one tile (block row
// row0) into out, for the column groups [g0, g0 + 32 * kPL) (a group is kVN
// columns; lane l has groups g0 + l + 32 j).  Runs of one row are summed in
// registers and added to out with one vector atomic per group at the end of
// the run.
template <typename HT, int kVN, int kPL, bool kBf16C>
__device__ __forceinline__ void tile_range_sum(
    const HT* __restrict__ h, long long n_rows, int D, int groups, int g0,
    const int* __restrict__ src, const int* __restrict__ dstl, const float* __restrict__ w,
    long long lo, long long hi, long long row0, int NR, long long num_nodes,
    float* __restrict__ out) {
  using L = typename Load<HT, kVN>::type;
  const int lane = threadIdx.x & 31;
  float acc[kPL][kVN];
  int cur = -1;
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < kPL; ++j) {
      const int g = g0 + lane + 32 * j;
      if (g >= groups) continue;
      float* o = out + (long long)cur * D + (long long)g * kVN;
      if constexpr (kVN == 1) {
        atomicAdd(o, acc[j][0]);
      } else {
#pragma unroll
        for (int q = 0; q < kVN / 4; ++q)
          atomicAdd(reinterpret_cast<float4*>(o) + q,
                    make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                                acc[j][4 * q + 3]));
      }
    }
  };
  for (long long base = lo; base < hi; base += 32) {
    const long long e = base + lane;
    int s = 0, row = -1;
    float wv = 0.f;
    if (e < hi) {
      s = __ldg(src + e);
      const int dl = __ldg(dstl + e);
      wv = __ldg(w + e);
      if (kBf16C) wv = round_bf16(wv);
      const long long r = row0 + dl;
      if (wv != 0.f && (unsigned)dl < (unsigned)NR && s >= 0 && (long long)s < n_rows &&
          r >= 0 && r < num_nodes)
        row = (int)r;  // else the slot adds nothing
    }
    unsigned live = __ballot_sync(0xffffffffu, row >= 0);
    while (live) {  // the valid slots in order, kRowsInFlight at a time
      int sk[kRowsInFlight], rk[kRowsInFlight];
      float wk[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int from = live ? __ffs(live) - 1 : 0;
        sk[u] = __shfl_sync(0xffffffffu, s, from);
        rk[u] = live ? __shfl_sync(0xffffffffu, row, from) : -1;
        wk[u] = __shfl_sync(0xffffffffu, wv, from);
        live &= live - 1;
      }
      L x[kRowsInFlight][kPL];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const HT* hrow = h + (long long)sk[u] * D;
#pragma unroll
        for (int j = 0; j < kPL; ++j) {
          const int g = g0 + lane + 32 * j;
          if (rk[u] >= 0 && g < groups) x[u][j] = load_h<HT, kVN>(hrow + (long long)g * kVN);
          else x[u][j] = L{};
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        if (rk[u] < 0) break;  // the same for every lane: the rest are empty too
        if (rk[u] != cur) {
          if (cur >= 0) flush();
          cur = rk[u];
#pragma unroll
          for (int j = 0; j < kPL; ++j)
#pragma unroll
            for (int i = 0; i < kVN; ++i) acc[j][i] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < kPL; ++j) {
          float v[kVN];
          unpack<HT, kVN>(x[u][j], v);
#pragma unroll
          for (int i = 0; i < kVN; ++i) acc[j][i] = fmaf(wk[u], v[i], acc[j][i]);
        }
      }
    }
  }
  if (cur >= 0) flush();
}

// The tiles: C chunks of TC tiles of E_t slots; tile t's block is blkl[t],
// plus blk0[t / TC] when blk0 is given (the uniform tiling; the flat tiling
// is one chunk without it).
struct Tiles {
  const int* src;
  const int* dstl;
  const float* w;
  const int* blkl;
  const int* blk0;
  int C;
  long long TC;
  int NR;
  int E_t;
};

// Work item = (tile t, range r of kRangeSlots slots); warps stride over the
// items (1-D grid sized to the card), each item's columns in passes of
// 32 * kPL groups (one pass for D <= 256 on the vector loads).  A tile of
// chunk c whose block chunk c + 1 also covers is skipped whole.
template <typename HT, int kVN, int kPL, bool kBf16C>
__global__ void __launch_bounds__(kThreads) tile_sum_kernel(
    const HT* __restrict__ h, long long n_rows, int D, Tiles tl, float* __restrict__ out,
    long long num_nodes) {
  const int groups = D / kVN;
  const int E_t = tl.E_t;
  const long long R = (E_t + kRangeSlots - 1) / kRangeSlots;
  const long long items = tl.C * tl.TC * R;
  for (long long it = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); it < items;
       it += (long long)gridDim.x * kWarps) {
    const long long t = it / R;
    long long blk = __ldg(tl.blkl + t);
    if (tl.blk0 != nullptr) {
      const long long c = t / tl.TC;
      blk += __ldg(tl.blk0 + c);
      if (c + 1 < tl.C && blk >= __ldg(tl.blk0 + c + 1)) continue;  // a later chunk's block
    }
    const long long r0 = (it - t * R) * kRangeSlots;
    const long long lo = t * E_t + r0;
    const long long hi = t * E_t + (r0 + kRangeSlots < E_t ? r0 + kRangeSlots : E_t);
    const long long row0 = blk * tl.NR;
    for (int g0 = 0; g0 < groups; g0 += 32 * kPL)
      tile_range_sum<HT, kVN, kPL, kBf16C>(h, n_rows, D, groups, g0, tl.src, tl.dstl, tl.w,
                                           lo, hi, row0, tl.NR, num_nodes, out);
  }
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

// One wave: as many CTAs as fit on the card at once, fewer if there are
// fewer work items than warps.
template <typename HT, int kVN, int kPL, bool kBf16C>
int launch_tile_sum(const void* h, long long n_rows, int D, const Tiles& tl, float* out,
                    long long num_nodes, cudaStream_t st) {
  auto kernel = tile_sum_kernel<HT, kVN, kPL, kBf16C>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long items = tl.C * tl.TC * ((tl.E_t + kRangeSlots - 1) / kRangeSlots);
  const long long want = (items + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(want < cap ? want : cap), kThreads, 0, st>>>(
      static_cast<const HT*>(h), n_rows, D, tl, out, num_nodes);
  return cudaGetLastError();
}

// 16-byte loads when D is a multiple of the values a load holds and h's
// base is 16-byte aligned; else one value per load, the same kernel.
template <typename HT, bool kBf16C>
int launch_tile_sum_h(const void* h, long long n_rows, int D, const Tiles& tl, float* out,
                      long long num_nodes, cudaStream_t st) {
  constexpr int kVN = 16 / sizeof(HT);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  if (D % kVN == 0 && (bases & 15) == 0) {
    if constexpr (sizeof(HT) == 4) {
      if (D / kVN > 32)  // f32 past 128 columns: two groups a lane
        return launch_tile_sum<HT, kVN, 2, kBf16C>(h, n_rows, D, tl, out, num_nodes, st);
    }
    return launch_tile_sum<HT, kVN, 1, kBf16C>(h, n_rows, D, tl, out, num_nodes, st);
  }
  return launch_tile_sum<HT, 1, 4, kBf16C>(h, n_rows, D, tl, out, num_nodes, st);
}

}  // namespace

extern "C" {

const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tiled sum: out (num_nodes, D) f32 is zeroed here (one memset) and
// gets w * h[src] of every slot of the C chunks of TC tiles at row block *
// NR + dstl, block = blkl[t] (+ blk0[t / TC] when blk0 is not null; a
// tile of chunk c whose block chunk c + 1 covers adds nothing), rows past
// num_nodes dropped.  h is f32 (h_bf16 0) or bf16 (1); bf16_c, the bf16
// compute of the reference, takes a bf16 h (the wrapper casts it, as the
// reference does before its gather) and rounds w to bf16.  No tiles leave
// the zeroed output and launch nothing.
int spmm_tile_sum(const void* h, int h_bf16, long long n_rows, int D, const int* src,
                  const int* dstl, const float* w, const int* blkl, const int* blk0, int C,
                  long long TC, int NR, int E_t, int bf16_c, float* out, long long num_nodes,
                  void* stream) {
  if (C < 0 || TC < 0 || NR <= 0 || E_t <= 0 || D <= 0 || num_nodes < 0 ||
      num_nodes > 0x7fffffffLL || (bf16_c && !h_bf16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)num_nodes * D * sizeof(float), st);
  if (err != cudaSuccess || C == 0 || TC == 0 || num_nodes == 0) return err;
  const Tiles tl{src, dstl, w, blkl, blk0, C, TC, NR, E_t};
  if (h_bf16)
    return bf16_c ? launch_tile_sum_h<__nv_bfloat16, true>(h, n_rows, D, tl, out, num_nodes, st)
                  : launch_tile_sum_h<__nv_bfloat16, false>(h, n_rows, D, tl, out, num_nodes,
                                                            st);
  return launch_tile_sum_h<float, false>(h, n_rows, D, tl, out, num_nodes, st);
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
