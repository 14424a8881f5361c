// Layer 0 of the raw-waveform CNN, fused, for Hopper (sm_90a): K6f.
//
// Replaces tpukaldi/kernels/conv1d.py::_fused_fwd_kernel (launched from
// _fused_fwd).  Per window n and filter o, from the valid conv + max-pool
// of K5 (conv_tile.cuh), over the M pooled rows:
//
//     y     = max-pool(conv)[m, o] + bias[o]
//     mu    = sum_m y / M,  c = y - mu,  s = sqrt(sum_m c^2 / max(M - 1, 1))
//     z     = ((c * r) * gt[m, o]) + bt[m, o],  r = 1 / (s + eps)
//     z     = relu(z) if relu;  z = keep ? z * scale : 0 if drop_on
//
// keep = tpukaldi's hash of (seed, window n, element m * O + o) below the
// threshold (conv_tile.cuh::drop_keep).  Writes out (N, M, O) and, when
// they are not null (training), idx (N, M, O) int8, stats (N, 2, O) = (mu,
// s) and ypool (N, M, O), the pooled conv value before the bias, which K6b
// reads.  float32 throughout; seed is an int32 on the device.
//
// Design: one block per (window n, tile of 32 filters), 16 warps.  The
// block stages the whole window and the tile's weights in shared memory,
// runs the conv + pool of K5f (lane = filter, warp = a run of 12 conv
// positions), and keeps the pooled rows of its 32 filters in shared
// memory: 1024 x 32 x 4 B = 128 KB at the recipe's M = 1024.  The moments
// are per-lane sums over the warp's rows, then over the 16 warps in order.
// The normalised, activated, dropped row goes straight to `out`: the
// separate layer norm, relu and dropout passes over the 64 MB activation
// (and a mask tensor) never touch device memory.
//
// What bounds it: the conv's 2 N (L-K+1) K O flops (13 GFLOP at the
// training batch (128, 3200, 129, 128), 0.2 ms at 67 TFLOP/s) against the
// bytes of x, gt, bt, out, idx, stats and ypool (153 MB there, 0.05 ms);
// serving writes out alone, 13 GB for 24,896 windows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

__global__ void __launch_bounds__(tpk::kLnWarps * 32)
conv_ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ gt,
                   const float* __restrict__ bt, const int* __restrict__ seed_p,
                   float* __restrict__ out, int8_t* __restrict__ idx,
                   float* __restrict__ stats, float* __restrict__ ypool, int L,
                   int K, int O, int M, int pool, float eps, int relu,
                   uint32_t threshold, float scale, int drop_on) {
  extern __shared__ float smem[];
  const int Kp = tpk::padded_taps(K);
  const int R = tpk::run_rows(pool);
  const int runs = tpk::ln_runs(M, pool);
  const int span = tpk::run_span(runs, pool, Kp);
  float* xs = smem;                   // the window
  float* ws = xs + span;              // Kp x kFilt
  float* ys = ws + Kp * tpk::kFilt;   // M x kFilt pooled rows + bias
  float* red = ys + M * tpk::kFilt;   // 2 x kLnWarps x kFilt
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * tpk::kFilt;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int o = o0 + lane;
  const bool active = o < O;
  const size_t win = static_cast<size_t>(n) * M * O;
  tpk::load_window(x + static_cast<size_t>(n) * L, L, 0, span, xs);
  tpk::load_filters(w, K, O, o0, Kp, ws);
  __syncthreads();

  const float b0 = active ? bias[o] : 0.0f;
  for (int g = warp; g < runs; g += tpk::kLnWarps) {
    float acc[tpk::kRun];
    tpk::conv_run(xs, ws, g * R * pool, lane, Kp, acc);
    tpk::pool_run(acc, pool, [&](int r, float m, int arg) {
      const int row = g * R + r;
      if (row < M) {
        ys[row * tpk::kFilt + lane] = m + b0;
        if (idx != nullptr && active) {
          const size_t e = win + static_cast<size_t>(row) * O + o;
          idx[e] = static_cast<int8_t>(arg);
          ypool[e] = m;
        }
      }
    });
  }
  __syncthreads();

  float part = 0.0f;
  for (int m = warp; m < M; m += tpk::kLnWarps) part += ys[m * tpk::kFilt + lane];
  const float mu = tpk::warp_sum(part, red) / static_cast<float>(M);
  part = 0.0f;
  for (int m = warp; m < M; m += tpk::kLnWarps) {
    const float c = ys[m * tpk::kFilt + lane] - mu;
    part += c * c;
  }
  const float ss = tpk::warp_sum(part, red + tpk::kLnWarps * tpk::kFilt);
  const float s = sqrtf(ss / static_cast<float>(max(M - 1, 1)));
  const float r = 1.0f / (s + eps);

  if (!active) return;
  const uint32_t seed = drop_on ? static_cast<uint32_t>(*seed_p) : 0u;
  for (int m = warp; m < M; m += tpk::kLnWarps) {
    const size_t e = static_cast<size_t>(m) * O + o;
    float z = tpk::ln_affine(ys[m * tpk::kFilt + lane] - mu, r, gt[e], bt[e]);
    if (relu) z = fmaxf(z, 0.0f);
    if (drop_on) {
      z = tpk::drop_keep(static_cast<uint32_t>(e), seed,
                         static_cast<uint32_t>(n), threshold) ? z * scale : 0.0f;
    }
    out[win + e] = z;
  }
  if (stats != nullptr && warp == 0) {
    stats[static_cast<size_t>(n) * 2 * O + o] = mu;
    stats[static_cast<size_t>(n) * 2 * O + O + o] = s;
  }
}

}  // namespace

// The shared memory a block needs for a window of L samples.
extern "C" long tpk_conv_ln_smem_bytes(int L, int K, int pool) {
  return static_cast<long>(tpk::ln_smem_bytes(L, K, pool));
}

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.  idx, stats and
// ypool are all null (inference) or none is (training).
extern "C" int tpk_conv_ln_fwd(const float* x, const float* w,
                               const float* bias, const float* gt,
                               const float* bt, const int* seed, float* out,
                               int8_t* idx, float* stats, float* ypool, int N,
                               int L, int K, int O, int pool, float eps,
                               int relu, unsigned threshold, float scale,
                               int drop_on, cudaStream_t stream) {
  if (!tpk::geometry_ok(N, L, K, O, pool)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tpk::ln_smem_bytes(L, K, pool);
  if (smem > tpk::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_ln_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = (L - K + 1) / pool;
  const dim3 grid(N, (O + tpk::kFilt - 1) / tpk::kFilt);
  conv_ln_fwd_kernel<<<grid, tpk::kLnWarps * 32, smem, stream>>>(
      x, w, bias, gt, bt, seed, out, idx, stats, ypool, L, K, O, M, pool, eps,
      relu, threshold, scale, drop_on);
  return static_cast<int>(cudaGetLastError());
}
