// What the upper layers of the raw conv stack share (conv_stack_fwd.cu K7f,
// conv_stack_bwd.cu K7b): a register-tiled implicit GEMM on the CUDA cores
// in float32, which is K7f's conv and K7b's dX; the weights' layouts it
// reads; the launch plans and limits.
//
// Layouts (tpukaldi's): a layer's input h (N, lin, C) float32, its kernel W
// (O, C, K), its pooled outputs, idx and gradients (N, M, O), gamma and beta
// (M, O), stats (N, 2, O) = (mean, std).
//
// The GEMM.  Over an input X (N, len, cin), output position t of a window
// and column j:
//
//     acc[t, j] = sum over c < cin, then k < K,
//                 of X[t - shift + k, c] wt[c K + k, j]
//
// each one chain of fmaf in that order (c outer, k inner), X zero outside
// rows [0, len).  K7f's conv is X = h, shift 0, wt[c K + k, o] = W[o, c, k]:
// the chains of the one-filter-per-lane kernel before it, so the pooled
// value and its argmax keep their bits.  K7b's dX is X = dconv (the pooled
// gradient scattered onto the conv rows), shift K - 1, wt[o K + k, c] =
// W[o, c, K - 1 - k].  A block takes kGemmCols = 64 columns (a tile) and a
// span of positions; a thread computes kGemmP = 8 consecutive positions x
// kGemmF = 8 columns, 64 chains in registers.  Per input channel it loads 8
// + K - 1 rows of X (scalars, one row stride of kGemmStride words, so the
// four position groups of a warp read four banks) and per tap its columns'
// weights as two 16-byte loads: 12 + 10 shared loads for 320 fmaf at K = 5.
// A thread's columns are (f / 4) * 32 + fl * 4 + f % 4 for f < 8 and its
// column lane fl < 8, so the 8 lanes of a position group read 32
// consecutive words a load.  The block stages kGemmChunk input channels at
// a time (their rows and their weights) with cp.async, double-buffered.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"
#include "persist_grid.cuh"

namespace tpk {

// (conv_stack.py's gate restates the first two, and its masks the third)
constexpr int kMaxUpperK = 8;      // taps of an upper layer
// the pool of a layer (layer 0's, through K6, and each upper one's): the
// stack keeps the limit it was designed and held at, below K6's own
constexpr int kMaxStackPool = 12;
constexpr int kMaxChannels = 128;  // input channels and filters of one
constexpr uint32_t kMaskLanes = 128;  // element id m * 128 + o, every layer
// what the entries return, in place of a cudaError_t, for a layer whose
// blocks would need more than kMaxSmem bytes of shared memory (_launch.py's
// SMEM_REFUSED)
constexpr int kErrSmem = -1;

constexpr int kGemmP = 8;        // output positions a thread computes
constexpr int kGemmF = 8;        // columns a thread computes
constexpr int kGemmCols = 64;    // columns a block computes (a tile)
constexpr int kGemmLanes = kGemmCols / kGemmF;  // threads of a position group
constexpr int kGemmChunk = 16;   // input channels staged at a time
constexpr int kGemmStride = kGemmChunk + 1;     // words of a staged row
constexpr int kGemmMaxPos = 256;  // positions a block covers, at most
constexpr int kGemmMinPos = 64;   // ... at least, where the grid is small
constexpr int kGemmThreads = kGemmMaxPos / kGemmP * kGemmLanes;
constexpr int kPoolStride = kGemmCols + 4;  // words of a pooling-buffer row
static_assert(kGemmF == 8 && kGemmLanes == 8,
              "a thread's columns are two float4 groups, 32 apart");

// columns padded to whole tiles
__host__ __device__ inline int gemm_cols_pad(int cols) {
  return (cols + kGemmCols - 1) / kGemmCols * kGemmCols;
}

// wt[(a K + k) cpad + b] = W[b, a, k] (flip 0: rows (c, k), columns the
// filters o, K7f), or W[a, b, K - 1 - k] (flip 1: rows (o, k), columns the
// channels c, K7b's dX); zero in the columns past the tensor's
__global__ void prep_weights_kernel(const float* __restrict__ w, int O, int C,
                                    int K, int flip, int cpad,
                                    float* __restrict__ wt) {
  const int rows = (flip ? O : C) * K;
  const size_t total = static_cast<size_t>(rows) * cpad;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / cpad);
    const int b = static_cast<int>(i % cpad);
    const int a = r / K;
    const int k = r % K;
    float v = 0.0f;
    if (!flip && b < O) v = w[(static_cast<size_t>(b) * C + a) * K + k];
    if (flip && b < C) v = w[(static_cast<size_t>(a) * C + b) * K + K - 1 - k];
    wt[i] = v;
  }
}

inline cudaError_t launch_prep(const float* w, int O, int C, int K, int flip,
                               float* wt, cudaStream_t stream) {
  const int cpad = gemm_cols_pad(flip ? C : O);
  const int total = (flip ? O : C) * K * cpad;
  prep_weights_kernel<<<(total + 255) / 256, 256, 0, stream>>>(w, O, C, K,
                                                               flip, cpad, wt);
  return cudaGetLastError();
}

// The GEMM's operands, and what its epilogue writes.  With `pool` (K7f):
// out is y (N, M, cols), the max over each pool of positions plus bias,
// and idx (may be null) its first argmax; positions are conv rows, M *
// pool of them.  Without (K7b's dX): out is dh (N, outs, cols).
struct GemmArgs {
  const float* x;   // (N, len, cin)
  int len, cin;
  const float* wt;  // (cin K, gemm_cols_pad(cols))
  int shift;        // position t reads input rows t - shift + k
  int span;         // positions a block covers (whole pools with `pool`)
  int outs;         // positions of a window (M * pool with `pool`)
  float* out;
  int8_t* idx;
  const float* bias;
  int cols, pool, M;
};

// acc[p][f] += the chunk's cn channels' terms, in channel order, taps inner
// (xs: the staged rows from the thread's first, ws: the chunk's weights)
template <int K>
__device__ __forceinline__ void gemm_chunk(const float* xs, const float* ws,
                                           int cn, int fl,
                                           float (&acc)[kGemmP][kGemmF]) {
  const float4* w4 = reinterpret_cast<const float4*>(ws) + fl;
  for (int c = 0; c < cn; ++c) {
    float xr[kGemmP + K - 1];
#pragma unroll
    for (int i = 0; i < kGemmP + K - 1; ++i) xr[i] = xs[i * kGemmStride + c];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 a = w4[(c * K + k) * (kGemmCols / 4)];
      const float4 b = w4[(c * K + k) * (kGemmCols / 4) + 8];
      const float wk[kGemmF] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < kGemmP; ++p) {
#pragma unroll
        for (int f = 0; f < kGemmF; ++f) {
          acc[p][f] = fmaf(xr[p + k], wk[f], acc[p][f]);
        }
      }
    }
  }
}

// words of one staging buffer: the rows (16-byte aligned), then the weights
__host__ __device__ inline int gemm_rows_words(int threads, int K) {
  return ((threads / kGemmLanes * kGemmP + K - 1) * kGemmStride + 3) / 4 * 4;
}
__host__ __device__ inline int gemm_weight_words(int K) {
  return kGemmChunk * K * kGemmCols;
}

inline size_t gemm_smem_bytes(int threads, int K, bool pool) {
  const size_t stage = 2 * static_cast<size_t>(gemm_rows_words(threads, K) +
                                               gemm_weight_words(K));
  const size_t pooled =
      pool ? static_cast<size_t>(threads / kGemmLanes * kGemmP) * kPoolStride
           : 0;
  return (stage > pooled ? stage : pooled) * sizeof(float);
}

// Block (position span, column tile, window n); thread: column lane fl =
// threadIdx.x % 8, positions p0 .. p0 + 7, p0 = threadIdx.x / 8 * 8 from
// the span's first.  A thread past the span computes on zero rows and
// writes nothing.
template <int K, bool kPool>
__global__ void __launch_bounds__(kGemmThreads, 2)
upper_gemm_kernel(const GemmArgs g) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.z;
  const int col0 = blockIdx.y * kGemmCols;
  const int t0 = blockIdx.x * g.span;
  const int tid = threadIdx.x;
  const int fl = tid % kGemmLanes;
  const int p0 = tid / kGemmLanes * kGemmP;
  const int rows = blockDim.x / kGemmLanes * kGemmP + K - 1;
  const int xw = gemm_rows_words(blockDim.x, K);
  const int bw = xw + gemm_weight_words(K);
  const int cpad = gemm_cols_pad(g.cols);
  const float* xn = g.x + static_cast<size_t>(n) * g.len * g.cin;
  const int row0 = t0 - g.shift;
  const int chunks = (g.cin + kGemmChunk - 1) / kGemmChunk;
  // the chunk's rows, zero outside [0, len), and its weights
  auto stage = [&](int j) {
    float* xs = smem + (j & 1) * bw;
    float* ws = xs + xw;
    const int c0 = j * kGemmChunk;
    const int cn = min(kGemmChunk, g.cin - c0);
    for (int i = tid; i < rows * kGemmChunk; i += blockDim.x) {
      const int r = i / kGemmChunk;
      const int cc = i % kGemmChunk;
      const int t = row0 + r;
      if (cc < cn) {
        float* dst = xs + r * kGemmStride + cc;
        if (t >= 0 && t < g.len) {
          cp_async4(dst, xn + static_cast<size_t>(t) * g.cin + c0 + cc);
        } else {
          *dst = 0.0f;
        }
      }
    }
    const float* src = g.wt + static_cast<size_t>(c0) * K * cpad + col0;
    for (int i = tid; i < cn * K * (kGemmCols / 4); i += blockDim.x) {
      const int r = i / (kGemmCols / 4);
      const int q = i % (kGemmCols / 4);
      cp_async16_cg(ws + r * kGemmCols + q * 4,
                    src + static_cast<size_t>(r) * cpad + q * 4);
    }
    cp_async_commit();
  };

  float acc[kGemmP][kGemmF];
#pragma unroll
  for (int p = 0; p < kGemmP; ++p) {
#pragma unroll
    for (int f = 0; f < kGemmF; ++f) acc[p][f] = 0.0f;
  }
  stage(0);
  for (int j = 0; j < chunks; ++j) {
    if (j + 1 < chunks) {
      stage(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + (j & 1) * bw;
    gemm_chunk<K>(xs + p0 * kGemmStride, xs + xw,
                  min(kGemmChunk, g.cin - j * kGemmChunk), fl, acc);
    __syncthreads();
  }

  if constexpr (kPool) {
    // the conv rows into the pooling buffer (over the staging buffers),
    // then each pooled row of the span: the first index reaching the max
    // (tpukaldi's first match), + bias
    float* cs = smem;
#pragma unroll
    for (int p = 0; p < kGemmP; ++p) {
      float* row = cs + (p0 + p) * kPoolStride + fl * 4;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      *reinterpret_cast<float4*>(row + 32) =
          make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
    }
    __syncthreads();
    const int r0 = t0 / g.pool;
    const int rb = min(g.span / g.pool, g.M - r0);
    for (int i = tid; i < rb * kGemmCols; i += blockDim.x) {
      const int r = i / kGemmCols;
      const int col = i % kGemmCols;
      const int o = col0 + col;
      if (o >= g.cols) continue;
      const float* v = cs + r * g.pool * kPoolStride + col;
      float m = 0.0f;
      int arg = 0;
      for (int q = 0; q < g.pool; ++q) {
        const float a = v[q * kPoolStride];
        if (q == 0 || a > m) {
          m = a;
          arg = q;
        }
      }
      const size_t e = (static_cast<size_t>(n) * g.M + r0 + r) * g.cols + o;
      g.out[e] = m + g.bias[o];
      if (g.idx != nullptr) g.idx[e] = static_cast<int8_t>(arg);
    }
  } else {
    const bool vec = g.cols % 4 == 0;
#pragma unroll
    for (int p = 0; p < kGemmP; ++p) {
      const int t = t0 + p0 + p;
      if (p0 + p >= g.span || t >= g.outs) break;
      float* row = g.out + (static_cast<size_t>(n) * g.outs + t) * g.cols;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + h * 32 + fl * 4;
        if (vec && c + 3 < g.cols) {
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[p][4 * h], acc[p][4 * h + 1], acc[p][4 * h + 2],
                          acc[p][4 * h + 3]);
        } else {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            if (c + f < g.cols) row[c + f] = acc[p][4 * h + f];
          }
        }
      }
    }
  }
}

// The launch of a GEMM over `units` of `unit` positions a window (K7f:
// pooled rows of `pool` conv rows; dX: rows): the largest span of up to
// kGemmMaxPos positions that still gives two blocks an SM, down to
// kGemmMinPos, balanced over the window's blocks
struct GemmPlan {
  int span, blocks, threads;
  size_t smem;
};

inline GemmPlan gemm_plan(int N, int units, int unit, int tiles, int K,
                          bool pool) {
  const long fill = 2L * sm_count();
  GemmPlan p{};
  for (int cap = kGemmMaxPos; cap >= kGemmMinPos; cap /= 2) {
    const int per = cap / unit;
    int blocks = (units + per - 1) / per;
    const int each = (units + blocks - 1) / blocks;
    blocks = (units + each - 1) / each;
    p.span = each * unit;
    p.blocks = blocks;
    if (static_cast<long>(blocks) * tiles * N >= fill) break;
  }
  p.threads = ((p.span + kGemmP - 1) / kGemmP + 3) / 4 * 4 * kGemmLanes;
  p.smem = gemm_smem_bytes(p.threads, K, pool);
  return p;
}

// the GEMM over N windows (g.span set from the plan)
template <int K, bool kPool>
inline cudaError_t launch_gemm(GemmArgs g, int N, cudaStream_t stream) {
  const GemmPlan p = gemm_plan(N, kPool ? g.M : g.outs, kPool ? g.pool : 1,
                               gemm_cols_pad(g.cols) / kGemmCols, K, kPool);
  g.span = p.span;
  cudaError_t err = allow_smem(upper_gemm_kernel<K, kPool>);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.blocks, gemm_cols_pad(g.cols) / kGemmCols, N);
  upper_gemm_kernel<K, kPool><<<grid, p.threads, p.smem, stream>>>(g);
  return cudaGetLastError();
}

// the layer-norm kernels' shared memory (K7f's epilogue, K7b's first
// pass): the tile's M pooled rows (or their c = y - mu), two rows of
// per-warp sums
inline size_t ln_smem_bytes(int M) {
  return (static_cast<size_t>(M) * kFilt + 2 * kLnWarps * kFilt) *
         sizeof(float);
}

// the geometry checks of both entries
inline bool upper_geometry_ok(int N, int lin, int C, int K, int O, int pool,
                              int M) {
  return N > 0 && C >= 1 && C <= kMaxChannels && K >= 1 && K <= kMaxUpperK &&
         O >= 1 && O <= kMaxChannels && pool >= 1 && pool <= kMaxStackPool &&
         M >= 1 && M * pool + K - 1 <= lin;
}

// dispatch a launcher templated on the taps K (1 .. kMaxUpperK)
template <template <int> class Launch, typename Args>
cudaError_t dispatch_taps(int K, const Args& a, cudaStream_t stream) {
  switch (K) {
    case 1: return Launch<1>::run(a, stream);
    case 2: return Launch<2>::run(a, stream);
    case 3: return Launch<3>::run(a, stream);
    case 4: return Launch<4>::run(a, stream);
    case 5: return Launch<5>::run(a, stream);
    case 6: return Launch<6>::run(a, stream);
    case 7: return Launch<7>::run(a, stream);
    case 8: return Launch<8>::run(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tpk
