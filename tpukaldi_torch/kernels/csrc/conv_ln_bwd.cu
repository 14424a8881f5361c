// Backward of the fused layer 0 (K6f), for Hopper (sm_90a): K6b.
//
// Replaces tpukaldi/kernels/conv1d.py::_fused_bwd_kernel (launched from
// _fused_bwd).  From the output gradient dz (N, M, O), the forward's idx,
// stats (mu, s) and pooled pre-bias conv value ypool (N, M, O), and x, w,
// bias, gt, bt, per window n and filter o:
//
//     y    = ypool + bias
//     c    = y - mu,  r = 1 / (s + eps),  xhat = c * r
//     dz   = keep ? dz * scale : 0  (drop_on);  dz = 0 where z <= 0 (relu)
//     dgt  = sum_n dz * xhat,  dbt = sum_n dz            (M, O)
//     dzg  = dz * gt,  A = sum_m dzg,  B = sum_m dzg * c
//     dy   = r dzg - c (B r r) / (max(M-1, 1) max(s, 1e-30)) - (r / M) A
//
// then dx and dw from dy through idx, as K5b (conv_pool_bwd.cuh), dx only
// where it is asked for (a null dx skips the pass, for an input that needs
// no gradient).  dbias is the exact zero (the layer norm's mean cancels the
// bias), which the wrapper writes.
//
// Design: four passes.  (1) The layer norm's backward: one block per
// (window n, tile of 32 filters), 16 warps over the rows, lane = filter.
// y is K6f's own ypool + bias, so c, the relu gate and the rebuilt hash
// mask are the forward's bit for bit; dzg in the dy buffer, A and B summed
// per lane then over the warps in order; a second sweep turns dzg into dy,
// reading ypool again for c (keeping c in shared memory instead, M x 32
// floats a block, allows one block an SM and was 2-4% slower).  The per-window terms of dgt
// and dbt go to scratch (dgp, dbp).  (2) K5b's dX (where asked) and
// per-window dW passes on dy.  (3) The windows of dw, dgt and dbt summed
// 32 at a time.  No atomics: a replayed step gives the same bits, and dw,
// dgt and dbt are the same with or without dx.  tpukaldi recomputes y
// from the window at the saved argmax to keep its VMEM free; here K6f
// writes it in training (67 MB at the training batch (128, 3200, 129,
// 128), about 0.02 ms each way at 3.35 TB/s), and pass (1) is elementwise.
//
// What bounds it: dW's 2 N M K O flops (4.3 GFLOP at the training batch,
// 0.06 ms at 67 TFLOP/s), as many again for dX where it is asked for;
// pass (1) moves dz and ypool in and dy, dgp and dbp out (335 MB there,
// 0.1 ms at 3.35 TB/s), and the window sums read dgp and dbp again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_pool_bwd.cuh"

namespace {

__global__ void __launch_bounds__(tpk::kLnWarps * 32)
conv_ln_bwd_kernel(const float* __restrict__ ypool,
                   const float* __restrict__ bias, const float* __restrict__ gt,
                   const float* __restrict__ bt, const int* __restrict__ seed_p,
                   const float* __restrict__ stats,
                   const float* __restrict__ dz, float* __restrict__ dy,
                   float* __restrict__ dgp, float* __restrict__ dbp, int O,
                   int M, float eps, int relu, uint32_t threshold, float scale,
                   int drop_on) {
  __shared__ float red[2 * tpk::kLnWarps * tpk::kFilt];
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * tpk::kFilt;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int o = o0 + lane;
  const bool active = o < O;
  const size_t win = static_cast<size_t>(n) * M * O;

  float mu = 0.0f, s = 1.0f, b0 = 0.0f;
  if (active) {
    mu = stats[static_cast<size_t>(n) * 2 * O + o];
    s = stats[static_cast<size_t>(n) * 2 * O + O + o];
    b0 = bias[o];
  }
  const float r = 1.0f / (s + eps);
  const uint32_t seed = drop_on ? static_cast<uint32_t>(*seed_p) : 0u;
  float a_part = 0.0f, b_part = 0.0f;
  if (active) {
#pragma unroll 4
    for (int m = warp; m < M; m += tpk::kLnWarps) {
      const size_t e = static_cast<size_t>(m) * O + o;
      const float c = (ypool[win + e] + b0) - mu;
      const float xhat = c * r;
      float d = dz[win + e];
      if (drop_on) {
        d = tpk::drop_keep(static_cast<uint32_t>(e), seed,
                           static_cast<uint32_t>(n), threshold) ? d * scale
                                                                : 0.0f;
      }
      const float g = gt[e];
      if (relu && !(tpk::ln_affine(c, r, g, bt[e]) > 0.0f)) d = 0.0f;
      dgp[win + e] = d * xhat;
      dbp[win + e] = d;
      const float dzg = d * g;
      a_part += dzg;
      b_part += dzg * c;
      dy[win + e] = dzg;
    }
  }
  const float A = tpk::warp_sum(a_part, red);
  const float B = tpk::warp_sum(b_part, red + tpk::kLnWarps * tpk::kFilt);
  if (!active) return;
  const float fac = (B * r * r) /
                    (static_cast<float>(max(M - 1, 1)) * fmaxf(s, 1e-30f));
  const float rm = r / static_cast<float>(M);
#pragma unroll 4
  for (int m = warp; m < M; m += tpk::kLnWarps) {
    const size_t e = win + static_cast<size_t>(m) * O + o;
    const float c = (ypool[e] + b0) - mu;
    dy[e] = r * dy[e] - c * fac - rm * A;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.  dy, dgp and dbp are
// scratch of N * M * O floats, dw_part of N * K * O; dx may be null (no dX
// pass).
extern "C" int tpk_conv_ln_bwd(const float* x, const float* w,
                               const float* bias, const float* gt,
                               const float* bt, const int* seed,
                               const int8_t* idx, const float* stats,
                               const float* ypool, const float* dz, float* dy,
                               float* dgp, float* dbp, float* dw_part,
                               float* dx, float* dw, float* dgt, float* dbt,
                               int N, int L, int K, int O, int pool, float eps,
                               int relu, unsigned threshold, float scale,
                               int drop_on, cudaStream_t stream) {
  if (!tpk::geometry_ok(N, L, K, O, pool)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = (L - K + 1) / pool;
  const dim3 grid(N, (O + tpk::kFilt - 1) / tpk::kFilt);
  conv_ln_bwd_kernel<<<grid, tpk::kLnWarps * 32, 0, stream>>>(
      ypool, bias, gt, bt, seed, stats, dz, dy, dgp, dbp, O, M, eps, relu,
      threshold, scale, drop_on);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tpk::launch_conv_pool_bwd(x, dy, idx, w, dw_part, dx, dw, N, L, K, O,
                                  pool, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mo = static_cast<size_t>(M) * O;
  err = tpk::launch_reduce(dgp, N, mo, dgt, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tpk::launch_reduce(dbp, N, mo, dbt, stream));
}
