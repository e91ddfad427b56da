// The backward of RepVGG-D2se's squeeze-and-excite gate, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: fenet's gate (fenet/models/repvgg.py: SEBlock)
// is jnp under XLA, which fuses it. The port's gate is eager PyTorch forward
// (a mean, two addmm, a ReLU, a sigmoid and a broadcast product) and was
// autograd's nodes backward, which write dy·x and a broadcast mean-gradient
// as two more tensors of x's size: some 16 device operations a gate
// backward, 48 gates a D2se step. Its backward is three launches here.
//
// For x (B, C, h, w) float32 and down (R, C), up (C, R), R = C/16, the
// forward (ops/se_gate.py, PyTorch's operations) saves
//   m = mean_hw x,  h = relu(down·m + bd),  s = sigmoid(up·h + bu)
// and from dy this computes
//   t = sum_hw dy·x,  ds = t·(1 - s)·s,  dz = (upᵀ·ds)·[h > 0],
//   dm = downᵀ·dz,  dx = dy·s + dm / (h·w)
//   d_up = Σ_b ds ⊗ h,  d_bu = Σ_b ds,  d_down = Σ_b dz ⊗ m,  d_bd = Σ_b dz
// in float32 FMA (never TF32), in another summation order than autograd's.
// The forward stays PyTorch's: the training benchmark holds the first
// step's loss to 2e-7 of a reference that runs PyTorch's ops, and an auction
// EMD over clouds that moved by one ulp takes other assignments (a mean and
// linears summed in another order read 2.6e-6 to 1.2e-5 there); the
// gradients are held to 1e-3.
//
// What bounds it on an H100: bytes. It reads dy twice and x once and writes
// dx once; D2se's 48 gates at batch 128 hold 1.917 GB of x a step, so
// 7.67 GB, 2.29 ms at 3.35 TB/s. Everything else is (B, C) or a weight of at
// most 2560 x 160.
//
// Design: no atomics, every sum in an order fixed by the shape alone, so that
// a run repeats bit for bit.
// - squeeze_kernel: t for one (b, c) row by T lanes of a 256-thread block, T
//   a power of two from the row's length (4 at 4x4, 8 at 8x8, 32 at 16x16,
//   128 at 32x32, 256 at 64x64: each lane 1 to 4 float4 of dy and of x),
//   several rows a warp where T < 32; a shuffle tree, then shared memory
//   across warps where T > 32.
// - excite_backward_kernel: four samples (kSamples) a block. It computes ds
//   for the samples, upᵀ·ds by columns (each thread a float4 of a row's
//   columns over a fixed slice of the rows, the slices added in order
//   through shared memory), the ReLU's mask, then downᵀ·dz the same way. A
//   block above 48 KB of shared memory (the 2560-channel gate's 84 KB) opts
//   in to more; a gate beyond the card's limit (227 KB, C above ~7,000) is
//   refused.
// - scale_kernel: dx = dy·s + dm/hw, float4 loads and stores, four a thread.
//   Its first blocks compute the four parameter gradients, 32 x 32 outputs a
//   block from 32 samples at a time through shared memory, each output a sum
//   over b in order, so that they run beside the stream of dy rather than
//   after it.
// Rows whose length is not a multiple of four, or tensors not 16-byte
// aligned, take scalar loops of the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // squeeze, scale and gradient blocks
constexpr int kScaleUnroll = 4;      // vectors a thread in the scale pass
constexpr int kExciteThreads = 512;  // excite blocks
constexpr int kSamples = 4;          // samples an excite block
constexpr int kUnroll = 4;           // loads in flight a thread in the excite's products
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory without opting in
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// ---------------------------------------------------------------------------
// Squeeze: t[row] = sum over the row of dy·x.
// ---------------------------------------------------------------------------

template <int T>
__device__ __forceinline__ float row_dot(const float* __restrict__ a, const float* __restrict__ b,
                                         int hw, int lane, bool vec) {
  float acc = 0.f;
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const int n4 = hw >> 2;
    int j = lane;
    for (; j + 3 * T < n4; j += 4 * T) {
      float4 va[4], vb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        va[u] = __ldg(a4 + j + u * T);
        vb[u] = __ldg(b4 + j + u * T);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = dot4(va[u], vb[u], acc);
    }
    for (; j < n4; j += T) acc = dot4(__ldg(a4 + j), __ldg(b4 + j), acc);
  } else {
    for (int i = lane; i < hw; i += T) acc = __fmaf_rn(__ldg(a + i), __ldg(b + i), acc);
  }
  return acc;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
squeeze_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
               int rows, int hw, bool vec) {
  constexpr int kRowsPerBlock = kThreads / T;
  const int lane = threadIdx.x % T;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / T;
  float acc = 0.f;
  if (row < rows) {
    const long long base = static_cast<long long>(row) * hw;
    acc = row_dot<T>(a + base, b + base, hw, lane, vec);
  }
#pragma unroll
  for (int off = (T < 32 ? T : 32) / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  }
  if constexpr (T > 32) {
    __shared__ float warp_sums[kThreads / 32];
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
    __syncthreads();
    if (lane == 0) {
      acc = 0.f;
#pragma unroll
      for (int w = 0; w < T / 32; ++w) acc = __fadd_rn(acc, warp_sums[threadIdx.x / 32 + w]);
    }
  }
  if (lane == 0 && row < rows) out[row] = acc;
}

// Lanes a row: 1 to 4 vectors each, 4 to 256 lanes.
int squeeze_lanes(int n) {
  int t = 4;
  while (t < 256 && 2 * t <= n / 2) t *= 2;
  return t;
}

void launch_squeeze(const float* a, const float* b, float* out, int rows, int hw,
                    cudaStream_t stream) {
  const bool vec = hw % 4 == 0 && aligned16(a) && aligned16(b);
  const int t = squeeze_lanes(vec ? hw / 4 : hw);
  const int blocks = (rows + kThreads / t - 1) / (kThreads / t);
#define FENET_SQUEEZE(T)                                                                  \
  case T:                                                                                 \
    squeeze_kernel<T><<<blocks, kThreads, 0, stream>>>(a, b, out, rows, hw, vec);         \
    break;
  switch (t) {
    FENET_SQUEEZE(4)
    FENET_SQUEEZE(8)
    FENET_SQUEEZE(16)
    FENET_SQUEEZE(32)
    FENET_SQUEEZE(64)
    FENET_SQUEEZE(128)
    FENET_SQUEEZE(256)
  }
#undef FENET_SQUEEZE
}

// ---------------------------------------------------------------------------
// The excite's backward: block-level products of a weight matrix with S
// vectors in shared memory. V = 4 reads the matrix as float4 (len % 4 == 0,
// 16-byte aligned).
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ float4 load_vec(const float* __restrict__ p) {
  if constexpr (V == 4) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    return make_float4(__ldg(p), 0.f, 0.f, 0.f);
  }
}

// The split of col_reduce's threads: `width` threads across a row's vectors,
// `parts` slices of the rows.
__host__ __device__ __forceinline__ int col_width(int len, int v, int threads) {
  return len / v < threads ? len / v : threads;
}

// Floats of col_reduce's shared scratch for S samples, for any length up to
// len: parts · len is at most len, or threads · v where a row takes fewer
// than `threads` vectors.
__host__ __device__ __forceinline__ int col_scratch(int len, int v, int threads, int s) {
  return s * (len > threads * v ? len : threads * v);
}

// For k < len: epi(s, k, sum_i m[i·ld + k] · v[s·vstride + i]), i < rows.
// Each thread takes one vector of a row's columns at a time over the rows
// part, part + parts, ...; the parts' sums meet in `partial` and are added
// in the order of the parts. Ends with the block synchronised.
template <int S, int V, typename Epilogue>
__device__ __forceinline__ void col_reduce(const float* __restrict__ m, int ld, const float* v,
                                           int vstride, int rows, int len, float* partial,
                                           Epilogue epi) {
  const int nv = len / V, threads = static_cast<int>(blockDim.x);
  const int width = nv > 0 ? col_width(len, V, threads) : 1;
  // No more parts than keep kUnroll rows each: their sums are added in turn.
  const int most = rows > kUnroll ? (rows + kUnroll - 1) / kUnroll : 1;
  const int parts = threads / width < most ? threads / width : most;
  const int part = threadIdx.x / width;
  if (part < parts) {
    for (int q = threadIdx.x % width; q < nv; q += width) {
      float acc[S][V];
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[s][e] = 0.f;
      }
      const float* col = m + q * V;
      for (int i0 = part; i0 < rows; i0 += kUnroll * parts) {
        float4 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * parts;
          if (i < rows) w[u] = load_vec<V>(col + static_cast<long long>(i) * ld);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * parts;
          if (i < rows) {
            const float we[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const float vi = v[s * vstride + i];
#pragma unroll
              for (int e = 0; e < V; ++e) acc[s][e] = __fmaf_rn(we[e], vi, acc[s][e]);
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float* dst = partial + (part * S + s) * len + q * V;
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
        } else {
          dst[0] = acc[s][0];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * len; i += threads) {
    const int s = i / len, k = i - s * len;
    float sum = 0.f;
    for (int p = 0; p < parts; ++p) sum = __fadd_rn(sum, partial[(p * S + s) * len + k]);
    epi(s, k, sum);
  }
  __syncthreads();
}

// For a block's S samples: ds (B, C) = t·(1 - s)·s; dz (B, R) =
// (upᵀ·ds)·[hidden > 0]; shift (B, C) = (downᵀ·dz) / hw.
template <int VH, int VM>
__global__ void __launch_bounds__(kExciteThreads)
excite_backward_kernel(const float* __restrict__ t, const float* __restrict__ gate,
                       const float* __restrict__ hidden, const float* __restrict__ wd,
                       const float* __restrict__ wu, float* __restrict__ ds,
                       float* __restrict__ dz, float* __restrict__ shift, int batch, int c, int r,
                       float hw) {
  constexpr int S = kSamples;
  extern __shared__ float4 smem4[];
  const int cs = pad4(c), rs = pad4(r);
  float* ds_s = reinterpret_cast<float*>(smem4);  // [S][cs]
  float* dz_s = ds_s + S * cs;                     // [S][rs]: the hidden units, then dz
  float* partial = dz_s + S * rs;                  // col_reduce's scratch
  const int b0 = static_cast<int>(blockIdx.x) * S;
  const int ns = batch - b0 < S ? batch - b0 : S;
  for (int i = threadIdx.x; i < S * c; i += blockDim.x) {
    const int s = i / c, k = i - s * c;
    float d = 0.f;
    if (s < ns) {
      const long long at = static_cast<long long>(b0) * c + i;
      const float g = gate[at];
      d = __fmul_rn(__fmul_rn(t[at], __fsub_rn(1.f, g)), g);
      ds[at] = d;
    }
    ds_s[s * cs + k] = d;
  }
  for (int i = threadIdx.x; i < S * r; i += blockDim.x) {
    const int s = i / r, j = i - s * r;
    dz_s[s * rs + j] = s < ns ? hidden[static_cast<long long>(b0) * r + i] : 0.f;
  }
  __syncthreads();
  col_reduce<S, VH>(wu, r, ds_s, cs, c, r, partial, [&](int s, int j, float sum) {
    const float d = dz_s[s * rs + j] > 0.f ? sum : 0.f;
    if (s < ns) dz[static_cast<long long>(b0 + s) * r + j] = d;
    dz_s[s * rs + j] = d;
  });
  col_reduce<S, VM>(wd, c, dz_s, rs, r, c, partial, [&](int s, int j, float sum) {
    if (s < ns) shift[static_cast<long long>(b0 + s) * c + j] = __fdiv_rn(sum, hw);
  });
}

// Bytes of an excite block's shared memory.
int excite_backward_smem(int c, int r, int vh, int vm) {
  const int a = col_scratch(r, vh, kExciteThreads, kSamples);
  const int b = col_scratch(c, vm, kExciteThreads, kSamples);
  return (kSamples * (pad4(c) + pad4(r)) + (a > b ? a : b)) * 4;
}

// ---------------------------------------------------------------------------
// Scale back, and the parameter gradients in the same launch.
// ---------------------------------------------------------------------------

constexpr int kTile = 32;  // a gradient block's outputs: kTile x kTile

struct Grads {
  const float* ds;      // (B, C)
  const float* dz;      // (B, R)
  const float* hidden;  // (B, R)
  const float* mean;    // (B, C)
  float* dwd;           // (R, C)
  float* dbd;           // (R)
  float* dwu;           // (C, R)
  float* dbu;           // (C)
  int batch, c, r;
  int blocks;  // the launch's first blocks, which compute them
};

__host__ __device__ __forceinline__ int tiles(int n) { return (n + kTile - 1) / kTile; }

// out (I, J) = sum_b a[b, i] · m[b, j] and bias (I) = sum_b a[b, i] on the
// tile (ti, tj) of kTile x kTile outputs (bias on the tiles tj = 0): a
// chunk of kTile samples of both operands at a time through shared memory,
// each thread four outputs of one column, each a sum over b in order.
__device__ void outer_tile(const float* __restrict__ a, const float* __restrict__ m, int batch,
                           int ni, int nj, int ti, int tj, float* __restrict__ out,
                           float* __restrict__ bias) {
  __shared__ float a_s[kTile][kTile];
  __shared__ float m_s[kTile][kTile];
  constexpr int kRowsAPass = kThreads / kTile;  // 8
  const int lane = threadIdx.x % kTile, i0 = (threadIdx.x / kTile) * 4;
  const int ia = ti * kTile + lane, jm = tj * kTile + lane;
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, sum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = 0; b0 < batch; b0 += kTile) {
#pragma unroll
    for (int u = 0; u < kTile / kRowsAPass; ++u) {
      const int bb = threadIdx.x / kTile + u * kRowsAPass, b = b0 + bb;
      a_s[bb][lane] = b < batch && ia < ni ? a[static_cast<long long>(b) * ni + ia] : 0.f;
      m_s[bb][lane] = b < batch && jm < nj ? m[static_cast<long long>(b) * nj + jm] : 0.f;
    }
    __syncthreads();
    const int nb = batch - b0 < kTile ? batch - b0 : kTile;
    for (int bb = 0; bb < nb; ++bb) {
      const float mv = m_s[bb][lane];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float av = a_s[bb][i0 + k];
        acc[k] = __fmaf_rn(av, mv, acc[k]);
        sum[k] = __fadd_rn(sum[k], av);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = ti * kTile + i0 + k;
    if (i < ni && jm < nj) out[static_cast<long long>(i) * nj + jm] = acc[k];
    if (i < ni && tj == 0 && lane == 0) bias[i] = sum[k];
  }
}

// Block `block` of the gradients: first d_up's tiles (i = channel, j =
// hidden unit, from ds and hidden), then d_down's (i = hidden unit, j =
// channel, from dz and the means).
__device__ void weight_grads(const Grads& g, int block) {
  const int up_tiles = tiles(g.c) * tiles(g.r);
  if (block < up_tiles) {
    outer_tile(g.ds, g.hidden, g.batch, g.c, g.r, block / tiles(g.r), block % tiles(g.r), g.dwu,
               g.dbu);
  } else {
    block -= up_tiles;
    outer_tile(g.dz, g.mean, g.batch, g.r, g.c, block / tiles(g.c), block % tiles(g.c), g.dwd,
               g.dbd);
  }
}

__device__ __forceinline__ float scaled(float dy, float s, float shift) {
  return __fadd_rn(__fmul_rn(dy, s), shift);
}

// dx = dy·gate[row] + shift[row] over rows of hw, after g.blocks blocks of
// weight gradients.
__global__ void __launch_bounds__(kThreads)
scale_kernel(const float* __restrict__ dy, const float* __restrict__ gate,
             const float* __restrict__ shift, float* __restrict__ dx, int rows, int hw, bool vec,
             Grads g) {
  if (static_cast<int>(blockIdx.x) < g.blocks) {
    weight_grads(g, blockIdx.x);
    return;
  }
  const long long first =
      static_cast<long long>(blockIdx.x - g.blocks) * (kThreads * kScaleUnroll) + threadIdx.x;
  const long long n = static_cast<long long>(rows) * hw;
  if (vec) {
    const long long n4 = n >> 2;
    const int hw4 = hw >> 2;
    const float4* dy4 = reinterpret_cast<const float4*>(dy);
    float4* dx4 = reinterpret_cast<float4*>(dx);
    float4 v[kScaleUnroll];
#pragma unroll
    for (int u = 0; u < kScaleUnroll; ++u) {
      const long long k = first + u * kThreads;
      if (k < n4) v[u] = __ldcs(dy4 + k);
    }
#pragma unroll
    for (int u = 0; u < kScaleUnroll; ++u) {
      const long long k = first + u * kThreads;
      if (k < n4) {
        const long long row = k / hw4;
        const float s = gate[row], sh = shift[row];
        dx4[k] = make_float4(scaled(v[u].x, s, sh), scaled(v[u].y, s, sh), scaled(v[u].z, s, sh),
                             scaled(v[u].w, s, sh));
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kScaleUnroll; ++u) {
    const long long i = first + u * kThreads;
    if (i < n) {
      const long long row = i / hw;
      dx[i] = scaled(dy[i], gate[row], shift[row]);
    }
  }
}

unsigned scale_blocks(int rows, int hw, bool vec) {
  const long long n = static_cast<long long>(rows) * hw;
  const long long items = vec ? n / 4 : n;
  return static_cast<unsigned>((items + kThreads * kScaleUnroll - 1) / (kThreads * kScaleUnroll));
}

bool valid(int batch, int c, int r, int hw) {
  return batch > 0 && c > 0 && r > 0 && hw > 0 &&
         static_cast<long long>(batch) * c <= 0x7fffffffLL &&
         scale_blocks(batch * c, hw, false) < 0x40000000u;
}

}  // namespace

// t (rows) = sum over each row of dy·x, both (rows, hw). One launch.
extern "C" int fenet_se_squeeze(const float* dy, const float* x, float* t, int rows, int hw,
                                void* stream) {
  if (rows <= 0 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  launch_squeeze(dy, x, t, rows, hw, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// ds (batch, c), dz (batch, r) and shift (batch, c) = downᵀ·dz / hw from
// t (batch, c), the forward's gate and hidden, down and up. One launch.
extern "C" int fenet_se_excite_backward(const float* t, const float* gate, const float* hidden,
                                        const float* wd, const float* wu, float* ds, float* dz,
                                        float* shift, int batch, int c, int r, int hw,
                                        void* stream) {
  if (!valid(batch, c, r, hw)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vh = r % 4 == 0 && aligned16(wu), vm = c % 4 == 0 && aligned16(wd);
  const int smem = excite_backward_smem(c, r, vh ? 4 : 1, vm ? 4 : 1);
  auto kernel = vh ? (vm ? excite_backward_kernel<4, 4> : excite_backward_kernel<4, 1>)
                   : (vm ? excite_backward_kernel<1, 4> : excite_backward_kernel<1, 1>);
  if (smem > kSmemDefault) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not sticky: leave no error for the next launch to read
      return static_cast<int>(err);
    }
  }
  kernel<<<static_cast<unsigned>((batch + kSamples - 1) / kSamples), kExciteThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(t, gate, hidden, wd, wu, ds, dz, shift, batch, c,
                                                r, static_cast<float>(hw));
  return static_cast<int>(cudaGetLastError());
}

// dx (batch, c, hw) = dy·gate[b, c] + shift[b, c], and in the same launch
// dwd (r, c), dbd (r), dwu (c, r), dbu (c) from ds, dz, hidden and mean.
extern "C" int fenet_se_scale(const float* dy, const float* gate, const float* shift, float* dx,
                              int batch, int c, int r, int hw, const float* ds, const float* dz,
                              const float* hidden, const float* mean, float* dwd, float* dbd,
                              float* dwu, float* dbu, void* stream) {
  if (!valid(batch, c, r, hw)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = batch * c;
  const bool vec = hw % 4 == 0 && aligned16(dy) && aligned16(dx);
  const Grads g{ds, dz, hidden, mean, dwd, dbd, dwu, dbu, batch, c, r, 2 * tiles(c) * tiles(r)};
  const unsigned blocks = scale_blocks(rows, hw, vec) + static_cast<unsigned>(g.blocks);
  scale_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(dy, gate, shift, dx,
                                                                          rows, hw, vec, g);
  return static_cast<int>(cudaGetLastError());
}
