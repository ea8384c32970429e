// Hopper (sm_90a) kernel of the dense parameters' Adam: one pass over every
// tensor of the list, reading p, g, m and v and writing p, m and v.
// Built by nvcc into a shared library with a plain C interface and loaded
// through ctypes (falcon_ttdforgnns_torch/ops/_build.py); the Python
// wrapper lives in ops/adam.py, the plain version is the body of
// train/optim.py adam_update, which runs for CPU tensors.
//
// No TPU kernel is replaced: the JAX package leaves the dense Adam to optax,
// which XLA fuses into one loop.  In eager PyTorch the same arithmetic is
// ~17 elementwise launches a tensor, each reading and writing whole
// table-sized temporaries: ~40 GB a step over the 2,449,029 x 100 f32 table
// of the --no-tt SAGE, where this kernel moves 6.86 GB.
//
// adam_f32 (train/optim.py adam_update on CUDA tensors), for each value of
// each tensor, in the plain version's order and rounding:
//   m = (1 - b1) g + b1 m;  v = (1 - b2) (g g) + b2 v;
//   u = (m / bc1) / (sqrt(v / bc2) + eps);  u = u + wd p  (when decay);
//   p = p + scale (-lr u).
// Every operation is a round-to-nearest intrinsic, so nvcc contracts
// nothing into an FMA and the result is bit-identical to the plain chain
// run on the card (its kernels round after each operation; IEEE division
// and square root).  bc1, bc2 (the bias corrections) and the plateau scale
// are read from device memory, so that a step needs no host sync; a scale
// given as a number comes in as an argument.
//
// Bound on H100: bytes, 28 a value (p, g, m, v read; p, m, v written): the
// table's 244,902,900 values and the tower's ~0.21 M move 6.86 GB, 2.05 ms
// at 3.35 TB/s; 3 divisions and a square root a value are ~0.2 ms of the
// SFU's time.  Design: one launch for a list of up to kMaxTensors tensors.
// Each block takes kChunk values of one tensor; the tensor is chosen once a
// block, by a binary search over the blocks' starts, which all threads of
// the block read alike from the launch's parameters (a __grid_constant__
// struct, read in place: indexing a by-value parameter struct with a
// run-time index would copy it into each thread's local memory, as the
// note above tt_sgd_kernel in tt_kernels.cu found).  A thread loads kVec
// float4 of each of p, g, m and v before it computes any, so 16 loads a
// thread are in flight; a tensor whose four pointers are not all 16-byte
// aligned takes the same walk one float at a time, and the values past a
// tensor's last float4 are done one at a time by its last block.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                            // float4 of each array a thread in flight
constexpr int kPass = kThreads * kVec * 4;         // values a block covers in one pass
constexpr long long kChunk = 4LL * kPass;          // values a block: 16,384
constexpr int kMaxTensors = 64;                    // 3 KB of launch parameters

struct TensorList {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long n[kMaxTensors];
  int first_block[kMaxTensors];  // ascending; tensor t has blocks first_block[t] ..
  int aligned[kMaxTensors];      // p, g, m, v all 16-byte aligned
  int count;
};

struct Coef {
  float b1, omb1, b2, omb2, eps, bc1, bc2, neg_lr, wd, scale;
  bool decay;
};

__device__ __forceinline__ void adam_step(float& p, float g, float& m, float& v,
                                          const Coef& c) {
  m = __fadd_rn(__fmul_rn(c.omb1, g), __fmul_rn(c.b1, m));
  v = __fadd_rn(__fmul_rn(c.omb2, __fmul_rn(g, g)), __fmul_rn(c.b2, v));
  float u = __fdiv_rn(__fdiv_rn(m, c.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)), c.eps));
  if (c.decay) u = __fadd_rn(u, __fmul_rn(c.wd, p));
  p = __fadd_rn(p, __fmul_rn(c.scale, __fmul_rn(c.neg_lr, u)));
}

__device__ __forceinline__ void adam_step4(float4& p, float4 g, float4& m, float4& v,
                                           const Coef& c) {
  adam_step(p.x, g.x, m.x, v.x, c);
  adam_step(p.y, g.y, m.y, v.y, c);
  adam_step(p.z, g.z, m.z, v.z, c);
  adam_step(p.w, g.w, m.w, v.w, c);
}

// Values [lo, hi) of one tensor, 16-byte loads: kVec float4 of each array
// loaded a pass before any is computed.
__device__ __forceinline__ void chunk4(float* p, const float* g, float* m, float* v,
                                       long long lo, long long hi, const Coef& c) {
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const long long end = hi >> 2;  // float4s wholly inside [lo, hi)
  for (long long q = (lo >> 2) + threadIdx.x; q < end; q += kThreads * kVec) {
    float4 P[kVec], G[kVec], M[kVec], V[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long i = q + j * kThreads;
      if (i < end) {
        P[j] = p4[i];
        G[j] = __ldg(g4 + i);
        M[j] = m4[i];
        V[j] = v4[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long i = q + j * kThreads;
      if (i < end) {
        adam_step4(P[j], G[j], M[j], V[j], c);
        p4[i] = P[j];
        m4[i] = M[j];
        v4[i] = V[j];
      }
    }
  }
  for (long long i = (end << 2) + threadIdx.x; i < hi; i += kThreads) {
    float pv = p[i], mv = m[i], vv = v[i];
    adam_step(pv, __ldg(g + i), mv, vv, c);
    p[i] = pv;
    m[i] = mv;
    v[i] = vv;
  }
}

// The same one float at a time, kVec * 4 values a thread in flight.
__device__ __forceinline__ void chunk1(float* p, const float* g, float* m, float* v,
                                       long long lo, long long hi, const Coef& c) {
  constexpr int kN = kVec * 4;
  for (long long q = lo + threadIdx.x; q < hi; q += kThreads * kN) {
    float P[kN], G[kN], M[kN], V[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const long long i = q + j * kThreads;
      if (i < hi) {
        P[j] = p[i];
        G[j] = __ldg(g + i);
        M[j] = m[i];
        V[j] = v[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const long long i = q + j * kThreads;
      if (i < hi) {
        adam_step(P[j], G[j], M[j], V[j], c);
        p[i] = P[j];
        m[i] = M[j];
        v[i] = V[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) adam_f32_kernel(
    const __grid_constant__ TensorList a, const float* __restrict__ bc1,
    const float* __restrict__ bc2, const float* __restrict__ scale, float scale_value,
    float neg_lr, float wd, int decay, float b1, float omb1, float b2, float omb2, float eps) {
  // the block's tensor: the last whose first block is at most this one
  // (a tensor without values has no blocks, and its successor its start)
  const int b = blockIdx.x;
  int t = 0;
  for (int step = kMaxTensors / 2; step > 0; step >>= 1)
    if (t + step < a.count && a.first_block[t + step] <= b) t += step;
  const Coef c{b1, omb1, b2, omb2, eps, *bc1, *bc2, neg_lr, wd,
               scale != nullptr ? *scale : scale_value, decay != 0};
  const long long n = a.n[t];
  const long long lo = (long long)(b - a.first_block[t]) * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  if (a.aligned[t])
    chunk4(a.p[t], a.g[t], a.m[t], a.v[t], lo, hi, c);
  else
    chunk1(a.p[t], a.g[t], a.m[t], a.v[t], lo, hi, c);
}

bool aligned16(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; }

}  // namespace

extern "C" {

const char* optim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One Adam step over `count` (<= 64) f32 tensors, each contiguous: p[k],
// g[k], m[k], v[k] of n[k] values.  bc1, bc2: device f32 scalars; scale: a
// device f32 scalar, or null to take scale_value.  omb1 = 1 - b1 and
// omb2 = 1 - b2 as the caller rounds them.  One launch, none when no
// tensor has a value.
int adam_f32_apply(int count, void* const* p, const void* const* g, void* const* m,
                   void* const* v, const long long* n, const void* bc1, const void* bc2,
                   const void* scale, float scale_value, float lr, float wd, int decay,
                   float b1, float omb1, float b2, float omb2, float eps, void* stream) {
  if (count < 0 || count > kMaxTensors || bc1 == nullptr || bc2 == nullptr)
    return cudaErrorInvalidValue;
  TensorList a = {};
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    if (n[k] < 0) return cudaErrorInvalidValue;
    a.p[k] = static_cast<float*>(p[k]);
    a.g[k] = static_cast<const float*>(g[k]);
    a.m[k] = static_cast<float*>(m[k]);
    a.v[k] = static_cast<float*>(v[k]);
    a.n[k] = n[k];
    a.aligned[k] = aligned16(p[k]) && aligned16(g[k]) && aligned16(m[k]) && aligned16(v[k]);
    a.first_block[k] = static_cast<int>(blocks);
    blocks += (n[k] + kChunk - 1) / kChunk;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  a.count = count;
  if (blocks == 0) return cudaSuccess;
  adam_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const float*>(scale), scale_value, -lr, wd, decay, b1, omb1, b2, omb2, eps);
  return cudaGetLastError();
}

}  // extern "C"
