// What the raw-waveform layer-0 kernels share (conv_pool_fwd.cu K5f,
// conv_pool_bwd.cu K5b, conv_ln_fwd.cu K6f, conv_ln_bwd.cu K6b): the window
// and filter loads, the conv of a run of positions, its max-pool, the layer
// norm's affine step and block sums, and the dropout hash.  The backwards'
// dX and dW passes are in conv_pool_bwd.cuh.
//
// Layouts (tpukaldi's): x (N, L) float32, w (K, O) float32, pooled outputs
// and their gradients (N, M, O) with M = (L - K + 1) / pool, idx (N, M, O)
// int8.  A block takes kFilt filters, one per lane of every warp, so the
// lanes of a warp read one x sample (a broadcast) and kFilt consecutive
// weights (no bank conflict) from shared memory.
//
// The forward computes each conv value as one chain of fmaf over the taps
// k = 0 .. Kp - 1 in order (conv_run).  Taps K .. Kp - 1 carry zero
// weights, and the window is zero-padded past L, so they add exact zeros.
// K6f saves the pooled value in training, so K6b normalises the same bits
// and opens the relu gate where the forward did.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpk {

constexpr int kMaxTaps = 129;   // tpukaldi's MAX_K
constexpr int kTapChunk = 8;    // taps per register window of conv_run
constexpr int kRun = 12;        // conv positions per thread per run
constexpr int kMaxPool = kRun;  // a run holds whole pooling windows
constexpr int kFilt = 32;       // filters per block, one per lane
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory per block

__host__ __device__ inline int padded_taps(int K) {
  return (K + kTapChunk - 1) / kTapChunk * kTapChunk;
}

// pooled rows per run, and the conv positions a block of `runs` runs reads
__host__ __device__ inline int run_rows(int pool) { return kRun / pool; }
__host__ __device__ inline int run_span(int runs, int pool, int Kp) {
  return runs * run_rows(pool) * pool + Kp + kRun;
}

// xs[i] = x_row[start + i] for i < count, zero outside [0, L): the zeros
// meet zero weights or fall beyond the last pooled row, and stay finite
__device__ inline void load_window(const float* __restrict__ x_row, int L,
                                   int start, int count, float* xs) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int t = start + i;
    xs[i] = (t >= 0 && t < L) ? x_row[t] : 0.0f;
  }
}

// ws[k * kFilt + c] = w[k, o0 + c], zero for taps k >= K and filters >= O
__device__ inline void load_filters(const float* __restrict__ w, int K, int O,
                                    int o0, int Kp, float* ws) {
  for (int i = threadIdx.x; i < Kp * kFilt; i += blockDim.x) {
    const int k = i / kFilt;
    const int o = o0 + i % kFilt;
    ws[i] = (k < K && o < O) ? w[static_cast<size_t>(k) * O + o] : 0.0f;
  }
}

// acc[j] = sum over k < Kp of xs[s + j + k] * ws[k * kFilt + col], for
// j < kRun: the taps in chunks of kTapChunk, the chunk's samples in a
// sliding register window (kRun + kTapChunk - 1 loads for kRun * kTapChunk
// fmaf), each acc[j] one chain in k order
__device__ __forceinline__ void conv_run(const float* xs, const float* ws,
                                         int s, int col, int Kp,
                                         float (&acc)[kRun]) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < Kp; k0 += kTapChunk) {
    float xr[kRun + kTapChunk - 1];
    float wr[kTapChunk];
#pragma unroll
    for (int i = 0; i < kRun + kTapChunk - 1; ++i) xr[i] = xs[s + k0 + i];
#pragma unroll
    for (int kk = 0; kk < kTapChunk; ++kk) wr[kk] = ws[(k0 + kk) * kFilt + col];
#pragma unroll
    for (int kk = 0; kk < kTapChunk; ++kk) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) acc[j] = fmaf(xr[j + kk], wr[kk], acc[j]);
    }
  }
}

// Max-pool a run: for each of its run_rows(pool) rows, emit(row, max,
// argmax) with the first index that reaches the max (torch's and
// tpukaldi's first match)
template <typename Emit>
__device__ __forceinline__ void pool_run(const float (&acc)[kRun], int pool,
                                         Emit emit) {
  const int used = run_rows(pool) * pool;
  float m = 0.0f;
  int arg = 0;
  int q = 0;
  int row = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (j < used) {
      if (q == 0 || acc[j] > m) {
        m = acc[j];
        arg = q;
      }
      if (++q == pool) {
        emit(row, m, arg);
        q = 0;
        ++row;
      }
    }
  }
}

// the layer norm's affine step, ((c * r) * g) + b, each product and the sum
// rounded on its own (never contracted into an fma), as tpukaldi and the
// plain version compute it: K6f and K6b open the relu gate alike
__device__ __forceinline__ float ln_affine(float c, float r, float g,
                                           float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(c, r), g), b);
}

// tpukaldi's dropout hash (kernels/conv1d.py::_drop_mask): murmur3's fmix32
// over the element id, xor the seed and the window id each times a
// constant; the element is kept where the hash is below the threshold
__device__ __forceinline__ bool drop_keep(uint32_t eid, uint32_t seed,
                                          uint32_t wid, uint32_t threshold) {
  uint32_t h = eid * 0xC2B2AE3Du ^ seed * 0x9E3779B1u ^ wid * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h < threshold;
}

// The layer-norm kernels (K6f, K6b): block (window n, tile of 32 filters),
// kLnWarps warps over the window's runs and rows; shared memory holds the
// window, the filter tile, the pooled rows of the tile (M x kFilt) and two
// rows of per-warp partial sums
constexpr int kLnWarps = 16;

inline __host__ __device__ int ln_runs(int M, int pool) {
  return (M + run_rows(pool) - 1) / run_rows(pool);
}

inline size_t ln_smem_bytes(int L, int K, int pool) {
  const int M = (L - K + 1) / pool;
  const int Kp = padded_taps(K);
  return (static_cast<size_t>(run_span(ln_runs(M, pool), pool, Kp)) +
          static_cast<size_t>(Kp) * kFilt + static_cast<size_t>(M) * kFilt +
          2 * kLnWarps * kFilt) * sizeof(float);
}

// the sum over the block's warps of each lane's `part`, in warp order;
// every thread gets its lane's total.  red holds kLnWarps x kFilt floats.
__device__ inline float warp_sum(float part, float* red) {
  const int lane = threadIdx.x % 32;
  red[(threadIdx.x / 32) * kFilt + lane] = part;
  __syncthreads();
  float tot = 0.0f;
  for (int w = 0; w < kLnWarps; ++w) tot += red[w * kFilt + lane];
  return tot;
}

// the shared geometry checks of the four entries
inline bool geometry_ok(int N, int L, int K, int O, int pool) {
  return N > 0 && O > 0 && K >= 1 && K <= kMaxTaps && pool >= 1 &&
         pool <= kMaxPool && L - K + 1 >= pool;
}

}  // namespace tpk
