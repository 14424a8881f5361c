// Valid single-channel 1-D conv + max-pool, for Hopper (sm_90a): K5f.
//
// Replaces tpukaldi/kernels/conv1d.py::_fwd_kernel (launched from
// _conv_pool_fwd), layer 0 of the raw-waveform SincNet recipe:
//
//     c[n, s, o]   = sum_k x[n, s + k] * w[k, o]          k < K <= 129
//     y[n, m, o]   = max_q c[n, m * pool + q, o]          m < M = (L-K+1)/pool
//     idx[n, m, o] = the first q reaching it (int8; not written when null)
//
// x (N, L), w (K, O) and y (N, M, O) float32, products and sums in float32
// (tpukaldi multiplies bf16 only on a TPU).
//
// Design: one block per (window n, block of kBlockRows pooled rows, tile of
// 32 filters).  The block stages its span of the window and the filter
// tile's weights (zero past K, taps padded to a multiple of 8) in shared
// memory.  Lane = filter, warp = a run of kRun = 12 conv positions (12/pool
// whole pooled rows); a thread keeps the run's 12 sums and a sliding window
// of 19 samples in registers (conv_tile.cuh::conv_run), so 27 shared loads,
// the samples broadcast to the warp, feed 96 fmaf.  The max and the first
// index reaching it come out of the registers (pool_run).
//
// What bounds it: 2 N (L-K+1) K O flops, 13 GFLOP at the training batch
// (128, 3200, 129, 128), against 86 MB of x, y and idx: the float32 FMA
// rate, 0.2 ms at 67 TFLOP/s.  The shared-load rate (27 loads per 96
// fmaf) and the idle lanes of a partial filter tile (O = 80: 96 lanes)
// keep it below; a tensor-core implicit GEMM over the staged window is the
// faster design (ROADMAP), with its own agreement rule.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

constexpr int kWarps = 8;
// pooled rows per block: a multiple of every run_rows(pool), pool <= 12
constexpr int kBlockRows = 96;

__global__ void __launch_bounds__(kWarps * 32)
conv_pool_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int8_t* __restrict__ idx, int L,
                     int K, int O, int M, int pool) {
  extern __shared__ float smem[];
  const int Kp = tpk::padded_taps(K);
  const int R = tpk::run_rows(pool);
  const int n = blockIdx.x;
  const int m0 = blockIdx.y * kBlockRows;
  const int o0 = blockIdx.z * tpk::kFilt;
  const int runs = (min(kBlockRows, M - m0) + R - 1) / R;
  const int span = tpk::run_span(runs, pool, Kp);
  float* xs = smem;       // the block's samples from m0 * pool
  float* ws = xs + span;  // Kp x kFilt
  tpk::load_window(x + static_cast<size_t>(n) * L, L, m0 * pool, span, xs);
  tpk::load_filters(w, K, O, o0, Kp, ws);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int o = o0 + lane;
  const size_t win = static_cast<size_t>(n) * M * O;
  for (int g = threadIdx.x / 32; g < runs; g += kWarps) {
    float acc[tpk::kRun];
    tpk::conv_run(xs, ws, g * R * pool, lane, Kp, acc);
    tpk::pool_run(acc, pool, [&](int r, float m, int arg) {
      const int row = m0 + g * R + r;
      if (row < M && o < O) {
        const size_t e = win + static_cast<size_t>(row) * O + o;
        y[e] = m;
        if (idx != nullptr) idx[e] = static_cast<int8_t>(arg);
      }
    });
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.  idx may be null.
extern "C" int tpk_conv_pool_fwd(const float* x, const float* w, float* y,
                                 int8_t* idx, int N, int L, int K, int O,
                                 int pool, cudaStream_t stream) {
  if (!tpk::geometry_ok(N, L, K, O, pool)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = (L - K + 1) / pool;
  const int Kp = tpk::padded_taps(K);
  const int max_runs = kBlockRows / tpk::run_rows(pool);
  const size_t smem =
      (static_cast<size_t>(tpk::run_span(max_runs, pool, Kp)) +
       static_cast<size_t>(Kp) * tpk::kFilt) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv_pool_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N, (M + kBlockRows - 1) / kBlockRows,
                  (O + tpk::kFilt - 1) / tpk::kFilt);
  conv_pool_fwd_kernel<<<grid, kWarps * 32, smem, stream>>>(x, w, y, idx, L, K,
                                                            O, M, pool);
  return static_cast<int>(cudaGetLastError());
}
