// Annealed log-domain Sinkhorn potentials, for Hopper (sm_90a).
//
// Replaces fenet/ops/sinkhorn.py:_sinkhorn_kernel (Pallas; wrapper
// sinkhorn_potentials, N, M <= 1024) and :_sinkhorn_stream_kernel (wrapper
// sinkhorn_potentials_stream, N, M <= 8192) with one kernel for N, M <= 8192.
// Inputs x (B, N, 3), y (B, M, 3) float32 and the per-iteration eps table
// (iters,) float32; outputs the potentials f (B, N) and g (B, M) float32.
//
// Uniform marginals and squared-euclidean cost C_ij = |x_i - y_j|^2. From
// f = g = 0, every iteration t with e = eps_table[t] runs, Gauss-Seidel:
//   f_i = -e * LSE_j[(g_j - C_ij) / e + log_nu]    (log_nu = -log M)
//   g_j = -e * LSE_i[(f_i - C_ij) / e + log_mu]    (log_mu = -log N)
// The host computes the table as the Pallas body does (fenet/ops/
// sinkhorn.py:80-89): max(eps, eps0 * exp(log_q * t)) in float32, the
// anneal reaching eps at 2/3 of the budget.
//
// What bounds it on an H100: operations, and among them the special-function
// units. Each iteration evaluates every pair twice (once per pass), each
// evaluation a cost (about 9 float32 operations), a division, an add and one
// exp: at B=128, N=M=1024 and 300 iterations, 8.05e10 evaluations. The
// special-function units issue 16 results per clock per SM (CUDA C++
// Programming Guide, arithmetic instruction throughput, compute capability
// 9.0), a quarter of the FMA rate's 64, so exp sets the bound. Bytes are
// negligible: 3 MB in, 1 MB out.
//
// Design. An SM's 227 KB of shared memory cannot hold a batch element's
// 4 MB (1024 x 1024) cost matrix, so the TPU's split between a resident and
// a streaming mode has no counterpart here: costs are recomputed from
// coordinates in every pass, with _rn intrinsics in the order of the plain
// version (fenet_torch/ops/pairwise.py; the cross term as a K=3 matmul's FMA
// chain), which gives the same bits in both passes and the plain version's
// bits. One persistent CTA of 1024 threads per batch element runs the whole
// loop. The f-pass gives each thread rows of x and stages y as float4
// (x, y, z, |y|^2) with g in shared memory; every thread reads the same
// column at once, a broadcast. The g-pass swaps the roles, staging x with f.
// 20 bytes a point: 20 KB at 1024, 160 KB at 8192, above 48 KB as dynamic
// shared memory with the opt-in attribute. f and g live in the output
// arrays between passes, made visible across the CTA by its barriers. The
// LSE is one pass with a running max: the sum is rescaled when the max
// rises. Divisions are IEEE (__fdiv_rn), exp and log the accurate expf and
// logf (no --use_fast_math).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPoints = 8192;

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Stage `count` points of `pts` as float4 (x, y, z, |p|^2) and their
// potential `pot` (0 when pot is null) in shared memory.
__device__ __forceinline__ void stage(const float* __restrict__ pts,
                                      const float* pot, int count,
                                      float4* s_pts, float* s_pot) {
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const float x = pts[3 * k], y = pts[3 * k + 1], z = pts[3 * k + 2];
    s_pts[k] = make_float4(x, y, z, sqnorm3(x, y, z));
    s_pot[k] = pot ? pot[k] : 0.f;
  }
}

// -e * LSE_j[(pot_j - C_ij) / e + log_w] over the `count` staged points,
// for the point (ax, ay, az) of squared norm aa.
__device__ __forceinline__ float soft_min(float ax, float ay, float az, float aa,
                                          const float4* s_pts, const float* s_pot,
                                          int count, float e, float log_w) {
  float run_max = -CUDART_INF_F, sum = 0.f;
  for (int j = 0; j < count; ++j) {
    const float4 q = s_pts[j];
    const float ab = __fmaf_rn(az, q.z, __fmaf_rn(ay, q.y, __fmul_rn(ax, q.x)));
    const float c = fmaxf(__fsub_rn(__fadd_rn(aa, q.w), __fmul_rn(2.f, ab)), 0.f);
    const float z = __fadd_rn(__fdiv_rn(__fsub_rn(s_pot[j], c), e), log_w);
    if (z > run_max) {
      sum = __fadd_rn(__fmul_rn(sum, expf(__fsub_rn(run_max, z))), 1.f);
      run_max = z;
    } else {
      sum = __fadd_rn(sum, expf(__fsub_rn(z, run_max)));
    }
  }
  return __fmul_rn(-e, __fadd_rn(logf(sum), run_max));
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ eps_table, float* f, float* g, int n,
                int m, int iters, float log_mu, float log_nu) {
  extern __shared__ float4 s_mem[];
  const int most = n > m ? n : m;
  float4* s_pts = s_mem;
  float* s_pot = reinterpret_cast<float*>(s_mem + most);

  const float* px = x + static_cast<size_t>(blockIdx.x) * n * 3;
  const float* py = y + static_cast<size_t>(blockIdx.x) * m * 3;
  float* pf = f + static_cast<size_t>(blockIdx.x) * n;
  float* pg = g + static_cast<size_t>(blockIdx.x) * m;

  for (int it = 0; it < iters; ++it) {
    const float e = eps_table[it];
    // f-pass: rows of x against y and g (g = 0 before the first pass).
    stage(py, it == 0 ? nullptr : pg, m, s_pts, s_pot);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float ax = px[3 * i], ay = px[3 * i + 1], az = px[3 * i + 2];
      pf[i] = soft_min(ax, ay, az, sqnorm3(ax, ay, az), s_pts, s_pot, m, e, log_nu);
    }
    __syncthreads();
    // g-pass: columns of y against x and the new f.
    stage(px, pf, n, s_pts, s_pot);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float bx = py[3 * j], by = py[3 * j + 1], bz = py[3 * j + 2];
      pg[j] = soft_min(bx, by, bz, sqnorm3(bx, by, bz), s_pts, s_pot, n, e, log_mu);
    }
    __syncthreads();
  }
}

}  // namespace

// x (batch, n, 3), y (batch, m, 3), eps_table (iters,) -> f (batch, n),
// g (batch, m), all float32, contiguous on the current device;
// 1 <= n, m <= 8192, iters >= 1. Launches on `stream` and returns the first
// CUDA error of setting the shared-memory size or of the launch.
extern "C" int fenet_sinkhorn(const float* x, const float* y, const float* eps_table,
                              float* f, float* g, int batch, int n, int m,
                              int iters, float log_mu, float log_nu, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || n > kMaxPoints || m > kMaxPoints || iters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int most = n > m ? n : m;
  const size_t smem = static_cast<size_t>(most) * (sizeof(float4) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, eps_table, f, g, n, m, iters, log_mu, log_nu);
  return static_cast<int>(cudaGetLastError());
}
