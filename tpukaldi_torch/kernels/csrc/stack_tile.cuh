// What the upper layers of the raw conv stack share (conv_stack_fwd.cu K7f,
// conv_stack_bwd.cu K7b): the filter tile's weights in shared memory, the
// conv of a run of positions and of one position, and the shared memory of
// the forward and layer-norm passes.
//
// Layouts (tpukaldi's): a layer's input h (N, lin, C) float32, its kernel W
// (O, C, K), its pooled outputs, idx and gradients (N, M, O), gamma and beta
// (M, O), stats (N, 2, O) = (mean, std).  A block takes kFilt = 32 filters,
// one per lane, so the lanes of a warp read one h value (a broadcast) and
// 32 consecutive weights from shared memory.
//
// Bit-equal remat: the forward computes each conv value as one chain of fmaf
// over the channels c = 0 .. C - 1 and, within each, the taps k = 0 .. K - 1
// (upper_run); the backward's upper_conv_at runs the same chain for one
// position, so the pooled value K7b recomputes through idx equals the one
// K7f normalised, bit for bit, and the relu gate opens where the forward's
// did.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace tpk {

// (conv_stack.py's gate restates the first two, and its masks the third)
constexpr int kMaxUpperK = 8;      // taps of an upper layer (registers)
constexpr int kMaxChannels = 128;  // input channels and filters of one
constexpr uint32_t kMaskLanes = 128;  // element id m * 128 + o, every layer
// what the entries return, in place of a cudaError_t, for a layer whose
// blocks would need more than kMaxSmem bytes of shared memory (_launch.py's
// SMEM_REFUSED)
constexpr int kErrSmem = -1;

// ws[(c * K + k) * kFilt + col] = W[o0 + col, c, k], zero for filters >= O
__device__ inline void load_upper_filters(const float* __restrict__ w, int C,
                                          int K, int O, int o0, float* ws) {
  const int ck = C * K;
  for (int i = threadIdx.x; i < ck * kFilt; i += blockDim.x) {
    const int o = o0 + i % kFilt;
    ws[i] = o < O ? w[static_cast<size_t>(o) * ck + i / kFilt] : 0.0f;
  }
}

// acc[j] = sum over c < C, k < K of h[s + j + k, c] * ws[(c K + k), col]
// for j < kRun: per channel the run's kRun + K - 1 rows in registers (a
// broadcast load each) against the K weights, each acc[j] one chain in (c,
// k) order; rows past lin read 0 (they only reach positions past the last
// pooled row)
template <int K>
__device__ __forceinline__ void upper_run(const float* __restrict__ h,
                                          const float* ws, int s, int lin,
                                          int C, int col, float (&acc)[kRun]) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) acc[j] = 0.0f;
  for (int c = 0; c < C; ++c) {
    float xr[kRun + K - 1];
    float wr[K];
#pragma unroll
    for (int i = 0; i < kRun + K - 1; ++i) {
      const int t = s + i;
      xr[i] = t < lin ? __ldg(h + static_cast<size_t>(t) * C + c) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) wr[k] = ws[(c * K + k) * kFilt + col];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) acc[j] = fmaf(xr[j + k], wr[k], acc[j]);
    }
  }
}

// the same chain for the one conv position s
__device__ __forceinline__ float upper_conv_at(const float* __restrict__ h,
                                               const float* ws, int s, int C,
                                               int K, int col) {
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    for (int k = 0; k < K; ++k) {
      acc = fmaf(h[static_cast<size_t>(s + k) * C + c],
                 ws[(c * K + k) * kFilt + col], acc);
    }
  }
  return acc;
}

// the forward's and the layer-norm pass's shared memory: the tile's
// weights, its M pooled rows (or their c = y - mu), two rows of per-warp
// sums
inline size_t upper_smem_bytes(int C, int K, int M) {
  return (static_cast<size_t>(C) * K * kFilt + static_cast<size_t>(M) * kFilt +
          2 * kLnWarps * kFilt) * sizeof(float);
}

// the geometry checks of both entries
inline bool upper_geometry_ok(int N, int lin, int C, int K, int O, int pool,
                              int M) {
  return N > 0 && C >= 1 && C <= kMaxChannels && K >= 1 && K <= kMaxUpperK &&
         O >= 1 && O <= kMaxChannels && pool >= 1 && pool <= kMaxPool &&
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
