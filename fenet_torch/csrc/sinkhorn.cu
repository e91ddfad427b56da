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
// What bounds it on an H100: operations. Each iteration evaluates every pair
// twice (once per pass), each evaluation a cost, a quotient, an add and one
// exponential: at B=128, N=M=1024 and 300 iterations, 8.05e10 evaluations.
// The special-function units return 16 results per clock per SM (CUDA C++
// Programming Guide, arithmetic instruction throughput, compute capability
// 9.0): with one exponential an evaluation, that is the bound. Each of the
// SM's four schedulers issues one warp instruction a clock, so the bound
// holds only while an evaluation issues at most 8 instructions; this one
// issues 15 (below), and issue is what limits it. Bytes are negligible: 3 MB
// in, 1 MB out.
//
// Arithmetic. The exponent z_ij = (pot_j - C_ij) / e + log_w keeps the plain
// version's bits on the CPU (fenet_torch/ops/sinkhorn.py): the cost with
// _rn intrinsics in its order (the cross term as a K=3 matmul's FMA chain),
// the quotient rounded as IEEE division rounds it, then log_w added, per
// pair. These bits matter: at the scale of untrained predictions (~30x the
// gt's) z reaches 1e7, where one rounding is a whole unit, and the rounding
// noise of 300 iterations grows chaotically. A kernel that rounds z
// otherwise (a product with 1/(e ln 2), or log_w added after the LSE) leaves
// fenet's tolerance there (tests/test_torch_ops.py models it); so does
// PyTorch on the card, which divides a tensor by a scalar as a product with
// its reciprocal. The quotient needs no division instruction: with
// r = RN(1/e), one per iteration, q0 = RN(d r), rem = fma(-q0, e, d) and
// fma(rem, r, q0) is the IEEE quotient d / e (Markstein). Per evaluation:
// 6 instructions for the cost, 5 for the exponent, a max, the ex2 argument,
// one ex2.approx.ftz, an add. The argument is fma(z, log2 e, -top2), where
// top is the running max and top2 = RN(top log2 e); the rounding residual of
// top2 is taken back out of the log at the end, one accurate logf per row.
// The previous design's IEEE division and accurate expf issued about twice
// the instructions and two special-function results per evaluation.
//
// Design. An SM's 227 KB of shared memory cannot hold a batch element's
// 4 MB (1024 x 1024) cost matrix, so the TPU's split between a resident and
// a streaming mode has no counterpart here: costs are recomputed from
// coordinates in every pass. One persistent CTA of kThreads threads per
// batch element runs the whole loop. The f-pass stages y as float4
// (x, y, z, |y|^2) and g in shared memory and gives each thread R rows of x
// (t, t + kThreads, ...; R <= kRows, a template parameter, and more sweeps
// past kRows * kThreads rows); the g-pass swaps the roles, staging x with f.
// Every thread reads the same column at once, a broadcast, and each read
// serves R rows. The LSE runs in tiles of kTile columns: the tile's
// exponents in registers, their max by fmaxf, the running sum rescaled once
// per tile (one more ex2 per kTile evaluations), no branch; the loop body
// holds one tile's exponents (FMA work) beside the previous tile's
// exponentials (special-function work), so the two overlap. 20 bytes a
// point: 20 KB at 1024, 160 KB at 8192, above 48 KB as dynamic shared memory
// with the opt-in attribute. f and g live in the output arrays between
// passes, made visible across the CTA by its barriers.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;  // most rows a thread carries through one sweep
constexpr int kTile = 8;  // columns per LSE tile, a multiple of 4
constexpr int kMaxPoints = 8192;
constexpr float kLog2e = 1.44269504088896340736f;
constexpr float kLn2 = 0.693147180559945309417f;

static_assert(kTile % 4 == 0, "the tile's potentials are read as float4");

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// One row's point and its running LSE: max exponent `top`, top2 =
// RN(top * log2 e), and the sum of 2^(z log2 e - top2) over the columns seen.
struct Row {
  float x, y, z, aa, top, top2, sum;
};

// Per-iteration constants: e, r = RN(1/e) and the pass's log weight.
struct Step {
  float e, r, log_w;
};

template <int T>
__device__ __forceinline__ float tree_max(const float* v) {
  if constexpr (T == 1) {
    return v[0];
  } else {
    return fmaxf(tree_max<T / 2>(v), tree_max<T - T / 2>(v + T / 2));
  }
}

template <int T>
__device__ __forceinline__ float tree_sum(const float* v) {
  if constexpr (T == 1) {
    return v[0];
  } else {
    return __fadd_rn(tree_sum<T / 2>(v), tree_sum<T - T / 2>(v + T / 2));
  }
}

// The exponent of row a against the staged column (q, p):
// (p - C) / e + log_w, rounded as the plain version rounds it.
__device__ __forceinline__ float exponent(const Row& a, float4 q, float p, const Step& s) {
  const float ab = __fmaf_rn(a.z, q.z, __fmaf_rn(a.y, q.y, __fmul_rn(a.x, q.x)));
  // (aa + bb) - 2ab: 2ab is exact, so one fma rounds as the subtraction.
  const float c = fmaxf(__fmaf_rn(-2.f, ab, __fadd_rn(a.aa, q.w)), 0.f);
  const float d = __fsub_rn(p, c);
  // d / e, rounded as IEEE division, from the reciprocal.
  const float q0 = __fmul_rn(d, s.r);
  return __fadd_rn(__fmaf_rn(__fmaf_rn(-q0, s.e, d), s.r, q0), s.log_w);
}

// The exponents z[k][t] of the R rows against the T staged columns q[0..T),
// p[0..T): each column read once serves every row.
template <int R, int T>
__device__ __forceinline__ void exponents(const Row (&a)[R], const float4* q, const float* p,
                                          const Step& s, float (&z)[R][T]) {
  float pot[T];
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int t = 0; t < T; t += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + t);
      pot[t] = v.x;
      pot[t + 1] = v.y;
      pot[t + 2] = v.z;
      pot[t + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) pot[t] = p[t];
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float4 col = q[t];
#pragma unroll
    for (int k = 0; k < R; ++k) z[k][t] = exponent(a[k], col, pot[t], s);
  }
}

// Fold a tile of exponents z into the R rows' LSEs.
template <int R, int T>
__device__ __forceinline__ void accumulate(Row (&a)[R], float (&z)[R][T]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float top = fmaxf(a[k].top, tree_max<T>(z[k]));
    const float top2 = __fmul_rn(top, kLog2e);
#pragma unroll
    for (int t = 0; t < T; ++t) z[k][t] = ex2(__fmaf_rn(z[k][t], kLog2e, -top2));
    a[k].sum = __fadd_rn(__fmul_rn(a[k].sum, ex2(__fsub_rn(a[k].top2, top2))),
                         tree_sum<T>(z[k]));
    a[k].top = top;
    a[k].top2 = top2;
  }
}

// -e * LSE of row a: log(sum) less the rounding residual of top2, plus top.
__device__ __forceinline__ float finish(const Row& a, float e) {
  const float resid = __fmaf_rn(a.top, kLog2e, -a.top2);  // exact
  const float lse = __fadd_rn(__fsub_rn(logf(a.sum), __fmul_rn(resid, kLn2)), a.top);
  return __fmul_rn(-e, lse);
}

// Rows first + t + k * kThreads (k < R) of `rows` against the `cols`
// staged points: out_i = -e * LSE_j[(pot_j - C_ij) / e + log_w]. Rows past
// `count` repeat the last row and are not stored.
template <int R>
__device__ __forceinline__ void sweep(const float* __restrict__ rows, int count, int first,
                                      const float4* s_pts, const float* s_pot, int cols,
                                      const Step& s, float* out) {
  Row a[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = min(first + static_cast<int>(threadIdx.x) + k * kThreads, count - 1);
    a[k].x = rows[3 * i];
    a[k].y = rows[3 * i + 1];
    a[k].z = rows[3 * i + 2];
    a[k].aa = sqnorm3(a[k].x, a[k].y, a[k].z);
    a[k].top = a[k].top2 = -CUDART_INF_F;
    a[k].sum = 0.f;
  }
  const int full = cols - cols % kTile;
  // The exponents of one tile (FMA work) beside the exponentials of the
  // previous one (special-function work), in one loop body.
  if (full > 0) {
    float z0[R][kTile], z1[R][kTile];
    exponents<R, kTile>(a, s_pts, s_pot, s, z0);
    int j = kTile;
    for (; j + kTile < full; j += 2 * kTile) {
      exponents<R, kTile>(a, s_pts + j, s_pot + j, s, z1);
      accumulate<R, kTile>(a, z0);
      exponents<R, kTile>(a, s_pts + j + kTile, s_pot + j + kTile, s, z0);
      accumulate<R, kTile>(a, z1);
    }
    if (j < full) {
      exponents<R, kTile>(a, s_pts + j, s_pot + j, s, z1);
      accumulate<R, kTile>(a, z0);
      accumulate<R, kTile>(a, z1);
    } else {
      accumulate<R, kTile>(a, z0);
    }
  }
  for (int j = full; j < cols; ++j) {
    float z[R][1];
    exponents<R, 1>(a, s_pts + j, s_pot + j, s, z);
    accumulate<R, 1>(a, z);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = first + static_cast<int>(threadIdx.x) + k * kThreads;
    if (i < count) out[i] = finish(a[k], s.e);
  }
}

// One half-iteration: stage the columns (pts, pot), then every row of
// `rows` in sweeps of up to kRows * kThreads rows, then a barrier.
__device__ __noinline__ void pass(const float* __restrict__ rows, int count,
                                  const float* __restrict__ pts, const float* pot, int cols,
                                  Step s, float* out, float4* s_pts, float* s_pot) {
  stage(pts, pot, cols, s_pts, s_pot);
  __syncthreads();
  for (int first = 0; first < count; first += kRows * kThreads) {
    const int left = count - first;
    const int r = left >= kRows * kThreads ? kRows : (left + kThreads - 1) / kThreads;
    if (r == 1) {
      sweep<1>(rows, count, first, s_pts, s_pot, cols, s, out);
    } else if (r == 2) {
      sweep<2>(rows, count, first, s_pts, s_pot, cols, s, out);
    } else if (r == 3) {
      sweep<3>(rows, count, first, s_pts, s_pot, cols, s, out);
    } else {
      sweep<kRows>(rows, count, first, s_pts, s_pot, cols, s, out);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
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
    const float r = __frcp_rn(e);
    // f-pass: rows of x against y and g (g = 0 before the first pass).
    pass(px, n, py, it == 0 ? nullptr : pg, m, Step{e, r, log_nu}, pf, s_pts, s_pot);
    // g-pass: rows of y against x and the new f.
    pass(py, m, px, pf, n, Step{e, r, log_mu}, pg, s_pts, s_pot);
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
