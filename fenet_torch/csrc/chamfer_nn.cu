// Directional nearest neighbour for the chamfer distance, for Hopper (sm_90a).
//
// Replaces fenet/ops/chamfer.py:_nn_kernel (Pallas; wrapper _nn_pallas, M <=
// 8192) and :_nn_stream_kernel (wrapper _nn_pallas_stream, M > 8192): the
// TPU needs a second kernel once B no longer fits VMEM; here B always
// streams through shared memory in tiles, so one kernel takes any M.
// For every point a_i of cloud A (B, N, 3):
//   dist_i = min_j max((|a_i|^2 + |b_j|^2) - 2 a_i.b_j, 0)
//   idx_i  = the first j that attains it (as torch.min and jnp.argmin do),
// over cloud B (B, M, 3). Float32 in, float32 and int32 out.
//
// What bounds it on an H100: instruction issue. A pair is at least 9 issued
// instructions (FMUL and two FFMA for the cross term, FADD for |a|^2 + |b|^2,
// FFMA for - 2ab, FMNMX for the clamp, FSETP for the compare, two selects
// for best and arg), and an SM issues 128 a clock: at B=128, N=M=2048 that
// is 0.144 ms, while the 24 bytes a point move in well under a microsecond.
//
// Design.
// - Rows in registers: each thread owns kRows rows of A (rows t, t +
//   kThreads, ... of its block), with their coordinates, |a|^2, best and
//   arg. Cloud B streams through shared memory in tiles of float4 (x, y, z,
//   |b|^2); every lane reads the same entry (a broadcast), so one LDS.128
//   serves kRows pairs, and the kRows compare-select chains are independent
//   and overlap. The next tile's coordinates are loaded into registers while
//   the current one is scanned.
// - Exact arithmetic: _rn intrinsics in the plain version's order
//   (fenet_torch/ops/pairwise.py): squared norms summed x, y, z; the cross
//   term as fma(az, bz, fma(ay, by, ax*bx)), the FMA chain of a float32
//   matmul with K=3; then (aa + bb) - 2ab as one __fmaf_rn(-2, ab, aa + bb):
//   2ab is exact in float32 short of overflow, so this rounds the same exact
//   value once, as the plain version's subtraction does; max with +0; and a
//   strict '<' while j rises, which keeps the first argmin. nvcc cannot
//   reassociate or contract intrinsics, so the kernel agrees with the plain
//   version bit for bit wherever the matmul's cross term is the same.
// - The M axis split across blocks where the grid is small: the caller
//   passes S (fenet_torch/ops/chamfer.py:nn_slices), and block z of S scans
//   tiles [z T / S, (z + 1) T / S) of the T tiles of M. With S = 1 a block
//   writes dist and idx itself. With S > 1 each block merges each row into
//   a 64-bit key with atomicMin: the high word is the bits of the clamped
//   d >= +0 (whose order as unsigned integers is the order of the floats),
//   the low word j. The least key is the least d and, among equal d, the
//   first j, in any order of blocks. The keys and a counter for each row
//   block start at all ones (one cudaMemsetAsync on the same stream); the
//   last of a row block's S blocks to finish unpacks the keys into dist and
//   idx, so they come out contiguous, as with S = 1.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 4;                         // A rows per thread
constexpr int kThreads = 128;                    // threads per block
constexpr int kRowsPerBlock = kRows * kThreads;  // A rows per block
constexpr int kTile = 256;                       // B points per tile (4 KB)
constexpr int kStage = kTile / kThreads;         // B points each thread stages
static_assert(kTile % kThreads == 0, "a tile is staged in whole rounds");

__device__ __forceinline__ float sqnorm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Load this thread's points of the tile at `base` (zeros past m).
__device__ __forceinline__ void fetch(const float* pb, int base, int m, float (&c)[3 * kStage]) {
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int j = base + k * kThreads + threadIdx.x;
    const bool in = j < m;
    c[3 * k] = in ? pb[3 * j] : 0.f;
    c[3 * k + 1] = in ? pb[3 * j + 1] : 0.f;
    c[3 * k + 2] = in ? pb[3 * j + 2] : 0.f;
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
chamfer_nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ dist, int* __restrict__ idx,
                  unsigned long long* keys, int* done, int n, int m) {
  __shared__ float4 tile[kTile];
  __shared__ bool last;
  const int row0 = blockIdx.x * kRowsPerBlock + threadIdx.x;
  const float* pa = a + static_cast<size_t>(blockIdx.y) * n * 3;
  const float* pb = b + static_cast<size_t>(blockIdx.y) * m * 3;

  float ax[kRows], ay[kRows], az[kRows], aa[kRows], best[kRows];
  int arg[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r * kThreads;
    const bool in = i < n;
    ax[r] = in ? pa[3 * i] : 0.f;
    ay[r] = in ? pa[3 * i + 1] : 0.f;
    az[r] = in ? pa[3 * i + 2] : 0.f;
    aa[r] = sqnorm3(ax[r], ay[r], az[r]);
    best[r] = CUDART_INF_F;
    arg[r] = 0;
  }

  // This block's slice of M: a run of whole tiles (all of them with S = 1,
  // which spares the small grids, often launch-bound, two 64-bit divisions).
  const int tiles = (m + kTile - 1) / kTile;
  int t0 = 0, t1 = tiles;
  if constexpr (kSplit) {
    t0 = static_cast<int>(static_cast<long long>(blockIdx.z) * tiles / gridDim.z);
    t1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * tiles / gridDim.z);
  }
  float c[3 * kStage];
  fetch(pb, t0 * kTile, m, c);
  for (int t = t0; t < t1; ++t) {
    const int base = t * kTile;
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      tile[k * kThreads + threadIdx.x] =
          make_float4(c[3 * k], c[3 * k + 1], c[3 * k + 2], sqnorm3(c[3 * k], c[3 * k + 1], c[3 * k + 2]));
    }
    __syncthreads();
    if (t + 1 < t1) fetch(pb, base + kTile, m, c);  // in flight during the scan
    const int count = min(kTile, m - base);
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const float4 q = tile[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float ab = __fmaf_rn(az[r], q.z, __fmaf_rn(ay[r], q.y, __fmul_rn(ax[r], q.x)));
        const float d = fmaxf(__fmaf_rn(-2.f, ab, __fadd_rn(aa[r], q.w)), 0.f);
        if (d < best[r]) {
          best[r] = d;
          arg[r] = base + j;
        }
      }
    }
  }

  const size_t out = static_cast<size_t>(blockIdx.y) * n;
  if constexpr (!kSplit) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row0 + r * kThreads;
      if (i < n) {
        dist[out + i] = best[r];
        idx[out + i] = arg[r];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row0 + r * kThreads;
      if (i < n) {
        atomicMin(keys + out + i, (static_cast<unsigned long long>(__float_as_uint(best[r])) << 32) |
                                      static_cast<unsigned>(arg[r]));
      }
    }
    __threadfence();  // this block's keys before its count
    __syncthreads();
    if (threadIdx.x == 0) {
      // The counter starts at -1: the k-th block of the row block to finish
      // reads k - 2, the last (k = S) reads S - 2.
      last = atomicAdd(done + blockIdx.y * gridDim.x + blockIdx.x, 1) ==
             static_cast<int>(gridDim.z) - 2;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row0 + r * kThreads;
      if (i < n) {
        const unsigned long long key = __ldcg(keys + out + i);  // from L2, where the atomics are
        dist[out + i] = __uint_as_float(static_cast<unsigned>(key >> 32));
        idx[out + i] = static_cast<int>(key & 0xffffffffu);
      }
    }
  }
}

}  // namespace

// The kernel's shape, for the caller's choice of S.
extern "C" const int fenet_chamfer_nn_rows_per_block = kRowsPerBlock;
extern "C" const int fenet_chamfer_nn_tile = kTile;

// a (batch, n, 3), b (batch, m, 3) -> dist (batch, n) f32, idx (batch, n) i32,
// all contiguous on the current device, M scanned in `slices` parts (1 ..
// the tiles of M). With slices > 1, `scratch` holds at least batch * n * 12
// bytes (the keys, then a counter for each row block); it may be null with
// slices = 1. Launches on `stream` and returns cudaGetLastError(): a refused
// launch never runs and synchronising would not report it.
extern "C" int fenet_chamfer_nn_split(const float* a, const float* b, float* dist, int* idx,
                                      void* scratch, int batch, int n, int m, int slices,
                                      void* stream) {
  const int tiles = (m + kTile - 1) / kTile;
  if (batch < 1 || batch > 65535 || n < 1 || m < 1 || slices < 1 || slices > tiles ||
      slices > 65535 || (slices > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, batch, slices);
  const auto s = static_cast<cudaStream_t>(stream);
  if (slices == 1) {
    chamfer_nn_kernel<false><<<grid, kThreads, 0, s>>>(a, b, dist, idx, nullptr, nullptr, n, m);
  } else {
    auto* keys = static_cast<unsigned long long*>(scratch);
    int* done = reinterpret_cast<int*>(keys + static_cast<size_t>(batch) * n);
    const size_t bytes = static_cast<size_t>(batch) * n * 8 + static_cast<size_t>(batch) * grid.x * 4;
    const cudaError_t set = cudaMemsetAsync(scratch, 0xff, bytes, s);
    if (set != cudaSuccess) return static_cast<int>(set);
    chamfer_nn_kernel<true><<<grid, kThreads, 0, s>>>(a, b, dist, idx, keys, done, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
