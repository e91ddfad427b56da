// Directional nearest neighbour for the chamfer distance, for Hopper (sm_90a).
//
// Replaces fenet/ops/chamfer.py:_nn_kernel (Pallas; wrapper _nn_pallas, M <=
// 8192) and :_nn_stream_kernel (wrapper _nn_pallas_stream, M > 8192): the
// TPU needs a second kernel once B no longer fits VMEM; here B always
// streams through shared memory in tiles, so one kernel takes any M, and the
// strict '<' over rising j keeps the first argmin across tiles as the
// streaming kernel's running fold does.
// For every point a_i of cloud A (B, N, 3):
//   dist_i = min_j max((|a_i|^2 + |b_j|^2) - 2 a_i.b_j, 0)
//   idx_i  = the first j that attains it (as torch.min and jnp.argmin do),
// over cloud B (B, M, 3). Float32 in, float32 and int32 out.
//
// What bounds it on an H100: operations. At the eval shapes (B=64,
// N=M=1024) it reads 1.5 MB and writes 0.5 MB, 0.6 us at 3.35 TB/s, but it
// evaluates 64 * 2^20 pairs at about 9 float32 operations each, about 9 us at
// 67 TFLOP/s.
//
// Design. One thread per A row, so the running min and argmin need no
// reduction across threads, and a strict '<' while j rises keeps the first
// argmin. Cloud B streams through shared memory in tiles of float4
// (x, y, z, |b|^2): all threads of a block read the same tile entry, a
// broadcast, and |b|^2 is computed once per point instead of once per pair.
// The arithmetic uses _rn intrinsics in the order of the plain version
// (fenet_torch/ops/pairwise.py): squared norms summed x, y, z; the cross term
// as the FMA chain that a float32 matmul with K=3 performs. nvcc cannot
// reassociate or contract intrinsics, so the kernel agrees with the plain
// version bit for bit wherever the matmul does the same.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // A rows per block
constexpr int kTile = 1024;    // B points per shared-memory tile (16 KB)

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
chamfer_nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ dist, int* __restrict__ idx, int n, int m) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* pa = a + static_cast<size_t>(blockIdx.y) * n * 3;
  const float* pb = b + static_cast<size_t>(blockIdx.y) * m * 3;

  float ax = 0.f, ay = 0.f, az = 0.f;
  if (i < n) {
    ax = pa[3 * i];
    ay = pa[3 * i + 1];
    az = pa[3 * i + 2];
  }
  const float aa = sqnorm3(ax, ay, az);
  float best = CUDART_INF_F;
  int arg = 0;

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const float* p = pb + 3 * (base + j);
      const float x = p[0], y = p[1], z = p[2];
      tile[j] = make_float4(x, y, z, sqnorm3(x, y, z));
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < count; ++j) {
      const float4 q = tile[j];
      const float ab = __fmaf_rn(az, q.z, __fmaf_rn(ay, q.y, __fmul_rn(ax, q.x)));
      const float d = fmaxf(__fsub_rn(__fadd_rn(aa, q.w), __fmul_rn(2.f, ab)), 0.f);
      if (d < best) {
        best = d;
        arg = base + j;
      }
    }
  }
  if (i < n) {
    const size_t o = static_cast<size_t>(blockIdx.y) * n + i;
    dist[o] = best;
    idx[o] = arg;
  }
}

}  // namespace

// a (batch, n, 3), b (batch, m, 3) -> dist (batch, n) f32, idx (batch, n) i32,
// all contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs and synchronising would
// not report it.
extern "C" int fenet_chamfer_nn(const float* a, const float* b, float* dist,
                                int* idx, int batch, int n, int m, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  chamfer_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, dist, idx, n, m);
  return static_cast<int>(cudaGetLastError());
}
