// Adam's update for Hopper (sm_90a): one pass over every parameter of a step.
//
// Replaces no Pallas kernel: fenet's optimizer is optax's
// chain(add_decayed_weights, scale_by_adam) under XLA (fenet/train/trainer.py),
// which fuses the update into its jitted step. The port ran torch.optim.Adam's
// foreach path: eight multi-tensor passes (add, lerp, mul, addcmul, sqrt, div,
// add, addcdiv) that move about 84 bytes a parameter and allocate a copy of
// every gradient for the weight decay's out-of-place add.
//
// Per element, torch's foreach arithmetic (float32) in its order:
//   g' = g + wd·p                                (_foreach_add, alpha = wd)
//   m  = m + (1−β1)·(g' − m)                     (_foreach_lerp_, weight < 0.5)
//   v  = v·β2 + (1−β2)·(g'·g')                   (_foreach_mul_, _foreach_addcmul_)
//   p  = p + (−lr/bc1)·(m / (√v / √bc2 + eps))   (sqrt, div, add, addcdiv)
// each step rounded with an _rn intrinsic, a product that feeds a sum as one
// fused multiply-add (as nvcc contracts torch's functors), the square root
// and both quotients IEEE (no --use_fast_math). −lr/bc1 and √bc2 come from
// the host per tensor, computed in double as torch computes them and rounded
// to float32 as its scalar lists are.
//
// What bounds it on an H100: bytes. p, g, m and v are read once and p, m and
// v written once, 28 bytes an element: RepVGG-A2's 177.24 M parameters move
// 4.96 GB, 1.48 ms at 3.35 TB/s; RepVGG-D2se's 282.36 M 7.91 GB, 2.36 ms.
// The arithmetic, ~40 instructions an element with two IEEE divisions and a
// square root, is a seventh of what the card issues in that time. The
// gradient is never written and nothing is allocated.
//
// Design. One launch covers up to kMaxTensors tensors (all of A2's 196 and
// D2se's 596). Their table (four pointers, the size, the two corrections)
// travels in the kernel's parameter space (__grid_constant__, ~31 KB of the
// 32,764 bytes CUDA 12.1 allows), filled anew for every launch (the gradients
// get new addresses each step), so nothing is copied ahead or synchronised. Each tensor is cut into chunks of kChunk elements and a block
// takes one chunk, finding its tensor by binary search over the table's
// chunk offsets. Each thread moves kUnroll float4 of each of the four arrays
// and issues all sixteen loads before any arithmetic, so 64 KB is in flight
// a block; loads and stores are cache-streaming (nothing is read twice). A
// chunk at a tensor's end, or a tensor whose pointers are not 16-byte
// aligned, takes a scalar loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * 4 * kUnroll;  // elements a block
constexpr int kMaxTensors = 600;                 // ops/adam.py: MAX_TENSORS

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long n[kMaxTensors];
  float neg_step[kMaxTensors];  // −lr / bc1
  float bc2_sqrt[kMaxTensors];  // √bc2
  int first_chunk[kMaxTensors + 1];
  int count;
  float w1, beta2, c2, eps, wd;  // 1−β1, β2, 1−β2, eps, weight decay
};

static_assert(sizeof(Table) <= 32764, "the table must fit the kernel's parameter space");

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float neg_step,
                                       float bc2_sqrt, const Table& t) {
  const float gd = t.wd != 0.f ? __fmaf_rn(t.wd, p, g) : g;
  m = __fmaf_rn(t.w1, __fsub_rn(gd, m), m);
  v = __fmaf_rn(t.c2, __fmul_rn(gd, gd), __fmul_rn(v, t.beta2));
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), bc2_sqrt), t.eps);
  p = __fmaf_rn(neg_step, __fdiv_rn(m, denom), p);
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m, float4& v,
                                        float neg_step, float bc2_sqrt, const Table& t) {
  update(p.x, g.x, m.x, v.x, neg_step, bc2_sqrt, t);
  update(p.y, g.y, m.y, v.y, neg_step, bc2_sqrt, t);
  update(p.z, g.z, m.z, v.z, neg_step, bc2_sqrt, t);
  update(p.w, g.w, m.w, v.w, neg_step, bc2_sqrt, t);
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Table t) {
  const int chunk = blockIdx.x;
  // The last tensor whose first chunk is <= chunk: an empty tensor shares its
  // first chunk with the next one and is passed over.
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long n = t.n[lo];
  const long long begin = static_cast<long long>(chunk - t.first_chunk[lo]) * kChunk;
  float* __restrict__ p = t.p[lo];
  const float* __restrict__ g = t.g[lo];
  float* __restrict__ m = t.m[lo];
  float* __restrict__ v = t.v[lo];
  const float neg_step = t.neg_step[lo], bc2_sqrt = t.bc2_sqrt[lo];
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  if ((bases & 15) == 0 && begin + kChunk <= n) {
    float4* p4 = reinterpret_cast<float4*>(p + begin);
    const float4* g4 = reinterpret_cast<const float4*>(g + begin);
    float4* m4 = reinterpret_cast<float4*>(m + begin);
    float4* v4 = reinterpret_cast<float4*>(v + begin);
    float4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * kThreads + threadIdx.x;
      rp[u] = __ldcs(p4 + i);
      rg[u] = __ldcs(g4 + i);
      rm[u] = __ldcs(m4 + i);
      rv[u] = __ldcs(v4 + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * kThreads + threadIdx.x;
      update4(rp[u], rg[u], rm[u], rv[u], neg_step, bc2_sqrt, t);
      __stcs(p4 + i, rp[u]);
      __stcs(m4 + i, rm[u]);
      __stcs(v4 + i, rv[u]);
    }
    return;
  }
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    float pi = p[i], mi = m[i], vi = v[i];
    update(pi, g[i], mi, vi, neg_step, bc2_sqrt, t);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// One launch over `count` tensors (1..kMaxTensors): ptrs holds each tensor's
// (param, grad, exp_avg, exp_avg_sq) addresses, numels their sizes (an empty
// tensor takes no chunk; with no element at all nothing is launched),
// neg_steps and bc2_sqrts their −lr/bc1 and √bc2. Returns the launch's CUDA
// error code (cudaErrorInvalidValue for a table it does not take).
extern "C" int fenet_adam(const unsigned long long* ptrs, const long long* numels,
                          const float* neg_steps, const float* bc2_sqrts, int count, float w1,
                          float beta2, float c2, float eps, float wd, void* stream) {
  if (count < 1 || count > kMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (numels[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.p[i] = reinterpret_cast<float*>(ptrs[4 * i]);
    t.g[i] = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
    t.m[i] = reinterpret_cast<float*>(ptrs[4 * i + 2]);
    t.v[i] = reinterpret_cast<float*>(ptrs[4 * i + 3]);
    t.n[i] = numels[i];
    t.neg_step[i] = neg_steps[i];
    t.bc2_sqrt[i] = bc2_sqrts[i];
    t.first_chunk[i] = static_cast<int>(chunks);
    chunks += (numels[i] + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunks == 0) return static_cast<int>(cudaSuccess);
  t.first_chunk[count] = static_cast<int>(chunks);
  t.count = count;
  t.w1 = w1;
  t.beta2 = beta2;
  t.c2 = c2;
  t.eps = eps;
  t.wd = wd;
  adam_kernel<<<static_cast<unsigned>(chunks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
