// Hopper (sm_90a) kernels for the TT-embedding lookup, its backward and the
// fused Adam update of the TT cores.  Built by nvcc into a shared library
// with a plain C interface and loaded through ctypes
// (falcon_ttdforgnns_torch/ops/_build.py); the Python wrappers live in
// falcon_ttdforgnns_torch/ops/tt_kernels.py next to their plain versions.
//
// Cores keep the native (p_k, r_k, q_k, r_{k+1}) layout, row-major, f32.
// Digits are digit_k = (id / stride_k) % p_k.  The TPU kernels held whole
// cores in VMEM and selected rows with one-hot matmuls; here the cores stay
// in global memory (793 KB at the products shapes, resident in the 50 MB
// L2) and each id reads its core rows by digit.
//
// tt_fwd  replaces falcon_ttdforgnns_tpu/ops/tt_pallas.py:_fwd_kernel.
//   One warp per id.  The running chain state (L_k x r_k floats, at most
//   400 at the products shapes) ping-pongs between two per-warp shared
//   buffers; each lane computes outputs o = lane, lane+32, ... of the next
//   level with f32 FMAs over the input rank, reading the core row straight
//   from global (coalesced across lanes, L1/L2 resident).  The last level
//   is stored straight to the output row.  Bound on H100: the FMAs (8,000
//   per id at the products shapes, 15 GFLOP per 937,984 ids, 0.22 ms at
//   the 67 TFLOP/s f32 peak) before the 375 MB output store (0.11 ms).
//   Measured: 3.4 ms for 937,984 ids on an H100 (PERF.md).
//
// tt_grads  replaces tt_pallas.py:_bwd_kernel.
//   One warp per id: recompute the left partials P_0..P_{T-2} into shared
//   memory, copy the d_out row in, then walk the cores from last to first:
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
//   per id (42 GFLOP per step, 0.63 ms at the f32 peak) before the 375 MB
//   d_out read.  Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py,
//   PERF.md): 14.5 ms for 937,984 zipf ids, the same as with 8 private
//   partial copies of the gradient summed by a second pass — the per-id
//   chain work, not atomic contention, sets the time for now.
//
// tt_adam_apply  together with tt_grads replaces tt_pallas.py:_adam_kernel.
//   A cross-block reduction needs a second pass on Hopper, so the fused
//   Adam is two launches: tt_grads, then this elementwise kernel over every
//   core value.  It reads scal = [lr_eff, c1, c2] from device memory (no
//   host sync) and updates cores, m and v IN PLACE.  Bound: bytes (~7
//   arrays of 198,160 floats).

#include <cuda_runtime.h>
#include <stdint.h>

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

struct AdamPtrs {
  float* core[kMaxCores];
  float* m[kMaxCores];
  float* v[kMaxCores];
  const float* g[kMaxCores];
  long long off[kMaxCores + 1];
  int T;
};

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
template <int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tt_fwd_kernel(const int* __restrict__ ids, long long B, CorePtrs cores,
              TTMeta m, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* buf0 = smem + warp * 2 * m.S;
  float* buf1 = buf0 + m.S;
  for (long long b = (long long)blockIdx.x * kWarpsPerBlock + warp; b < B;
       b += (long long)gridDim.x * kWarpsPerBlock) {
    int d[T];
    digits_of<T>(ids[b], m, d);
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
      float* dst = (k == T - 1) ? out + b * m.D : nxt;
      for (int o = lane; o < n; o += 32) {
        const int l = o / mm;
        const int c = o - l * mm;
        const float* s = cur + l * rin;
        float acc = 0.f;
        for (int r = 0; r < rin; ++r) acc = fmaf(s[r], __ldg(ck + r * mm + c), acc);
        dst[o] = acc;
      }
      __syncwarp();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

// -------------------------------------------------------------- tt_grads
template <int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tt_grads_kernel(const int* __restrict__ ids, const float* __restrict__ dout,
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

    // G_{T-1} = d_out row
    const float* drow = dout + b * m.D;
    for (int i = lane; i < m.D; i += 32) g0[i] = __ldg(drow + i);
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

// --------------------------------------------------------- tt_adam_apply
__global__ void tt_adam_kernel(AdamPtrs a, const float* __restrict__ scal,
                               float b1, float omb1, float b2, float omb2,
                               float eps) {
  const float lr = scal[0];
  const float c1 = scal[1];
  const float c2 = scal[2];
  const long long n = a.off[a.T];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    int k = 0;
    while (i >= a.off[k + 1]) ++k;
    const long long j = i - a.off[k];
    const float g = a.g[k][j];
    const float m = b1 * a.m[k][j] + omb1 * g;
    const float v = b2 * a.v[k][j] + omb2 * g * g;
    a.m[k][j] = m;
    a.v[k][j] = v;
    a.core[k][j] = a.core[k][j] - lr * (m * c1) / (sqrtf(v * c2) + eps);
  }
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

template <int T>
cudaError_t launch_fwd(const int* ids, long long B, const CorePtrs& c,
                       const TTMeta& m, float* out, cudaStream_t st) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * m.S;
  cudaError_t e = set_smem(tt_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  tt_fwd_kernel<T><<<blocks_for(B), kWarpsPerBlock * 32, smem, st>>>(ids, B, c, m, out);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_grads(const int* ids, const float* dout, long long B,
                         const CorePtrs& c, const TTMeta& m, float* grad,
                         cudaStream_t st) {
  const size_t smem =
      sizeof(float) * kWarpsPerBlock * (m.P_total + 2 * m.S + m.C_stage);
  cudaError_t e = set_smem(tt_grads_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  tt_grads_kernel<T><<<blocks_for(B), kWarpsPerBlock * 32, smem, st>>>(
      ids, dout, B, c, m, grad);
  return cudaGetLastError();
}

CorePtrs core_ptrs(const void* c0, const void* c1, const void* c2, const void* c3) {
  CorePtrs c;
  c.c[0] = static_cast<const float*>(c0);
  c.c[1] = static_cast<const float*>(c1);
  c.c[2] = static_cast<const float*>(c2);
  c.c[3] = static_cast<const float*>(c3);
  return c;
}

}  // namespace

extern "C" {

const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (B, D) f32 <- rows of the TT table at ids (B,) int32.
int tt_fwd(const void* ids, long long B, const int* spec, const void* c0,
           const void* c1, const void* c2, const void* c3, void* out,
           void* stream) {
  TTMeta m;
  if (!make_meta(spec, &m)) return cudaErrorInvalidValue;
  const CorePtrs c = core_ptrs(c0, c1, c2, c3);
  const int* id = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m.T) {
    case 2: return launch_fwd<2>(id, B, c, m, o, st);
    case 3: return launch_fwd<3>(id, B, c, m, o, st);
    case 4: return launch_fwd<4>(id, B, c, m, o, st);
  }
  return cudaErrorInvalidValue;
}

// grad (n_total,) f32, zeroed by the caller, accumulates the per-core
// gradients, core after core in the flat layout.
int tt_grads(const void* ids, const void* dout, long long B, const int* spec,
             const void* c0, const void* c1, const void* c2, const void* c3,
             void* grad, void* stream) {
  TTMeta m;
  if (!make_meta(spec, &m)) return cudaErrorInvalidValue;
  const CorePtrs c = core_ptrs(c0, c1, c2, c3);
  const int* id = static_cast<const int*>(ids);
  const float* g = static_cast<const float*>(dout);
  float* out = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m.T) {
    case 2: return launch_grads<2>(id, g, B, c, m, out, st);
    case 3: return launch_grads<3>(id, g, B, c, m, out, st);
    case 4: return launch_grads<4>(id, g, B, c, m, out, st);
  }
  return cudaErrorInvalidValue;
}

// In-place Adam on T cores: cores/m/v/g are T separate f32 arrays of
// sizes n[k]; scal (3,) f32 on the device = [lr_eff, c1, c2].
int tt_adam_apply(int T, const long long* n, void* const* cores, void* const* ms,
                  void* const* vs, const void* const* grads, const void* scal,
                  float b1, float omb1, float b2, float omb2, float eps,
                  void* stream) {
  if (T < 1 || T > kMaxCores) return cudaErrorInvalidValue;
  AdamPtrs a;
  a.T = T;
  a.off[0] = 0;
  for (int k = 0; k < kMaxCores; ++k) {
    const bool on = k < T;
    a.core[k] = on ? static_cast<float*>(cores[k]) : nullptr;
    a.m[k] = on ? static_cast<float*>(ms[k]) : nullptr;
    a.v[k] = on ? static_cast<float*>(vs[k]) : nullptr;
    a.g[k] = on ? static_cast<const float*>(grads[k]) : nullptr;
    if (on) a.off[k + 1] = a.off[k] + n[k];
  }
  for (int k = T; k < kMaxCores; ++k) a.off[k + 1] = a.off[k];
  const long long total = a.off[T];
  const unsigned blocks = (unsigned)((total + 255) / 256);
  tt_adam_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(scal), b1, omb1, b2, omb2, eps);
  return cudaGetLastError();
}

}  // extern "C"
