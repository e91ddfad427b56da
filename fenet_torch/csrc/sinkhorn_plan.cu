// The Sinkhorn EMD loss's transport plan and its gradient, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: fenet's plan is XLA (fenet/losses/sinkhorn.py:
// 104-109), which the port ran as plain PyTorch over (B, N, M) float32
// tensors (fenet_torch/losses/sinkhorn.py: pairwise_sqdist, then plan_loss),
// and autograd went back through them. This kernel recomputes the plan pair
// by pair from x (B, N, 3), y (B, M, 3) and the detached potentials f (B, N),
// g (B, M), and writes only per-point sums: nothing of size N·M reaches
// device memory.
//
// Per pair, as the plain version computes it on the card:
//   d_ij  = (|x_i|^2 + |y_j|^2) - 2 x_i.y_j      (the cost, unclamped)
//   c_ij  = max(d_ij, 0)
//   pi_ij = exp(((f_i + g_j) - c_ij) * RN(1/eps) - log N - log M)
// The cost with _rn intrinsics in the order of the other kernels (the cross
// term as a K=3 matmul's FMA chain, the norms summed x, y, z); the exponent
// rounded step by step in PyTorch's order on the card, which divides a
// tensor by a scalar as a product with its reciprocal; the accurate expf, as
// torch.exp takes it (no ex2.approx: the plan is one evaluation, not 300
// chaotic ones, so it keeps the plain version's arithmetic throughout).
//
// plan_rows_kernel: for each row i
//   cost_i = N * sum_j pi_ij c_ij                      (the loss's per point)
//   V_i    = sum_j pi_ij [d_ij >= 0] (x_i - y_j)       (B, N, 3)
// The loss's gradient in x_i is 2 N u_i V_i, u_i the upstream gradient of
// cost_i: the cost's clamp passes the gradient where d_ij >= 0, as autograd's
// clamp_min does, and pi is a constant. The wrapper forms it, a (B, N, 3)
// product; no second pass over the pairs.
// plan_cols_kernel, launched only when y needs a gradient: for each column j
//   W_j = sum_i u_i pi_ij [d_ij >= 0] (x_i - y_j)      (B, M, 3)
// and the wrapper's gradient in y_j is -2 N W_j. Both kernels compute pi_ij
// with the same bits (every step above is symmetric in its operands).
//
// What bounds it on an H100: issued instructions. Per pair about 6 for the
// cost, 5 for the exponent, ~10 for expf (one special-function result), 2 for
// cost_i and 8 for V_i (mask, three differences, three FMAs): ~31. At B=128,
// N=M=2048, 5.4e8 pairs, that is ~0.5 ms at 128 instructions a clock per SM
// (132 SMs, 1.98 GHz); the exponentials alone, at 16 a clock per SM, 0.13 ms.
// Bytes are negligible: 4 MB in, 4 MB out.
//
// Design. A grid of (blocks of kThreads * kRows rows, batch), so that at
// B=128 every SM holds several CTAs (a CTA an element, K7's layout, would
// give each SM one). Each thread carries kRows rows in registers; the
// columns stream through shared memory in tiles of kTile points, staged as
// float4 (x, y, z, |p|^2) with their potential, and every thread reads the
// same column at once (a broadcast), each read serving kRows rows. Any N and
// M: rows past N repeat the last row and are not stored, and the last tile
// is partial. The column kernel swaps the roles and stages u beside x and f.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;   // rows (columns, in the column kernel) a thread carries
constexpr int kTile = 256; // points staged in shared memory a tile
constexpr int kMaxBatch = 65535;  // gridDim.y

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// A point held in registers: coordinates, squared norm and potential.
struct Point {
  float x, y, z, sq, pot;
};

// The plan's constants: RN(1/eps) and the two log weights.
struct Consts {
  float r, log_n, log_m;
};

__device__ __forceinline__ Point load(const float* __restrict__ pts,
                                      const float* __restrict__ pot, int i) {
  const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
  return Point{x, y, z, sqnorm3(x, y, z), pot[i]};
}

// Stage points [first, first + count) of pts with their potential (and their
// upstream gradient, where w is given) in shared memory.
__device__ __forceinline__ void stage(const float* __restrict__ pts,
                                      const float* __restrict__ pot,
                                      const float* __restrict__ w, int first, int count,
                                      float4* s_pts, float* s_pot, float* s_w) {
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int i = first + k;
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    s_pts[k] = make_float4(x, y, z, sqnorm3(x, y, z));
    s_pot[k] = pot[i];
    if (w != nullptr) s_w[k] = w[i];
  }
}

// pi between a and the staged point (q, p), with its cost c and the clamp's
// mask (the unclamped cost >= 0).
__device__ __forceinline__ float plan_entry(const Point& a, float4 q, float p, const Consts& k,
                                            float& c, bool& live) {
  const float ab = __fmaf_rn(a.z, q.z, __fmaf_rn(a.y, q.y, __fmul_rn(a.x, q.x)));
  // (|a|^2 + |q|^2) - 2ab: 2ab is exact, so one fma rounds as the subtraction.
  const float d = __fmaf_rn(-2.f, ab, __fadd_rn(a.sq, q.w));
  live = d >= 0.f;
  c = fmaxf(d, 0.f);
  const float z = __fmul_rn(__fsub_rn(__fadd_rn(a.pot, p), c), k.r);
  return expf(__fsub_rn(__fsub_rn(z, k.log_n), k.log_m));
}

__global__ void __launch_bounds__(kThreads)
plan_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ f, const float* __restrict__ g,
                 float* __restrict__ cost, float* __restrict__ v, int n, int m, Consts k) {
  __shared__ float4 s_pts[kTile];
  __shared__ float s_pot[kTile];
  const size_t b = blockIdx.y;
  const float* px = x + b * n * 3;
  const float* py = y + b * m * 3;
  const float* pf = f + b * n;
  const float* pg = g + b * m;
  const int first = blockIdx.x * kThreads * kRows + threadIdx.x;

  Point a[kRows];
  float s[kRows], vx[kRows], vy[kRows], vz[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    a[r] = load(px, pf, min(first + r * kThreads, n - 1));
    s[r] = vx[r] = vy[r] = vz[r] = 0.f;
  }
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int len = min(kTile, m - j0);
    __syncthreads();  // the previous tile is read
    stage(py, pg, nullptr, j0, len, s_pts, s_pot, nullptr);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < len; ++j) {
      const float4 q = s_pts[j];
      const float p = s_pot[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float c;
        bool live;
        const float pi = plan_entry(a[r], q, p, k, c, live);
        s[r] = __fadd_rn(s[r], __fmul_rn(pi, c));
        const float w = live ? pi : 0.f;
        vx[r] = __fmaf_rn(w, __fsub_rn(a[r].x, q.x), vx[r]);
        vy[r] = __fmaf_rn(w, __fsub_rn(a[r].y, q.y), vy[r]);
        vz[r] = __fmaf_rn(w, __fsub_rn(a[r].z, q.z), vz[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = first + r * kThreads;
    if (i < n) {
      cost[b * n + i] = __fmul_rn(static_cast<float>(n), s[r]);
      float* out = v + (b * n + i) * 3;
      out[0] = vx[r];
      out[1] = vy[r];
      out[2] = vz[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
plan_cols_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ f, const float* __restrict__ g,
                 const float* __restrict__ u, float* __restrict__ out, int n, int m,
                 Consts k) {
  __shared__ float4 s_pts[kTile];
  __shared__ float s_pot[kTile];
  __shared__ float s_u[kTile];
  const size_t b = blockIdx.y;
  const float* px = x + b * n * 3;
  const float* py = y + b * m * 3;
  const float* pf = f + b * n;
  const float* pg = g + b * m;
  const float* pu = u + b * n;
  const int first = blockIdx.x * kThreads * kRows + threadIdx.x;

  Point a[kRows];
  float wx[kRows], wy[kRows], wz[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    a[r] = load(py, pg, min(first + r * kThreads, m - 1));
    wx[r] = wy[r] = wz[r] = 0.f;
  }
  for (int i0 = 0; i0 < n; i0 += kTile) {
    const int len = min(kTile, n - i0);
    __syncthreads();
    stage(px, pf, pu, i0, len, s_pts, s_pot, s_u);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < len; ++i) {
      const float4 q = s_pts[i];
      const float p = s_pot[i];
      const float ui = s_u[i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float c;
        bool live;
        const float pi = plan_entry(a[r], q, p, k, c, live);
        const float w = live ? __fmul_rn(ui, pi) : 0.f;
        wx[r] = __fmaf_rn(w, __fsub_rn(q.x, a[r].x), wx[r]);
        wy[r] = __fmaf_rn(w, __fsub_rn(q.y, a[r].y), wy[r]);
        wz[r] = __fmaf_rn(w, __fsub_rn(q.z, a[r].z), wz[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = first + r * kThreads;
    if (j < m) {
      float* o = out + (b * m + j) * 3;
      o[0] = wx[r];
      o[1] = wy[r];
      o[2] = wz[r];
    }
  }
}

int blocks(int count) { return (count + kThreads * kRows - 1) / (kThreads * kRows); }

bool valid(int batch, int n, int m, float eps) {
  return batch >= 1 && batch <= kMaxBatch && n >= 1 && m >= 1 && eps > 0.f;
}

}  // namespace

// x (batch, n, 3), y (batch, m, 3), f (batch, n), g (batch, m) -> cost
// (batch, n), v (batch, n, 3), all float32, contiguous on the current device;
// 1 <= batch <= 65535, n, m >= 1, eps > 0; log_n, log_m the float32 logs of
// n and m. Launches on `stream` and returns the launch's CUDA error.
extern "C" int fenet_sinkhorn_plan_rows(const float* x, const float* y, const float* f,
                                        const float* g, float* cost, float* v, int batch,
                                        int n, int m, float eps, float log_n, float log_m,
                                        void* stream) {
  if (!valid(batch, n, m, eps)) return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{1.0f / eps, log_n, log_m};
  plan_rows_kernel<<<dim3(blocks(n), batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, f, g, cost, v, n, m, k);
  return static_cast<int>(cudaGetLastError());
}

// The same inputs and u (batch, n), the upstream gradient of cost -> out
// (batch, m, 3) = sum_i u_i pi_ij [d_ij >= 0] (x_i - y_j).
extern "C" int fenet_sinkhorn_plan_cols(const float* x, const float* y, const float* f,
                                        const float* g, const float* u, float* out,
                                        int batch, int n, int m, float eps, float log_n,
                                        float log_m, void* stream) {
  if (!valid(batch, n, m, eps)) return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{1.0f / eps, log_n, log_m};
  plan_cols_kernel<<<dim3(blocks(m), batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, f, g, u, out, n, m, k);
  return static_cast<int>(cudaGetLastError());
}
