// Backward of the fused layer 0 (K6f), for Hopper (sm_90a): K6b.
//
// Replaces tpukaldi/kernels/conv1d.py::_fused_bwd_kernel (launched from
// _fused_bwd).  From the output gradient dz (N, M, O), the forward's idx and
// stats (mu, s), and x, w, bias, gt, bt, per window n and filter o:
//
//     y    = conv(x, w)[m * pool + idx] + bias   (recomputed through idx)
//     c    = y - mu,  r = 1 / (s + eps),  xhat = c * r
//     dz   = keep ? dz * scale : 0  (drop_on);  dz = 0 where z <= 0 (relu)
//     dgt  = sum_n dz * xhat,  dbt = sum_n dz            (M, O)
//     dzg  = dz * gt,  A = sum_m dzg,  B = sum_m dzg * c
//     dy   = r dzg - c (B r r) / (max(M-1, 1) max(s, 1e-30)) - (r / M) A
//
// then dx and dw from dy through idx, as K5b (conv_pool_bwd.cuh).  dbias
// is the exact zero (the layer norm's mean cancels the bias), which the
// wrapper writes.
//
// Design: four passes.  (1) One block per (window n, tile of 32 filters),
// 16 warps: the window and the filter tile in shared memory, the pooled
// pre-norm value recomputed at the saved argmax with the forward's own fmaf
// chain (conv_tile.cuh::conv_at), so c, the relu gate and the rebuilt hash
// mask are the forward's bit for bit; c kept in shared memory, dzg in the dy
// buffer, A and B summed per lane then over the warps in order; a second
// sweep turns dzg into dy.  The per-window terms of dgt and dbt go to
// scratch (dgp, dbp).  (2) K5b's dX and per-window dW passes on dy.  (3)
// The windows of dw, dgt and dbt summed 32 at a time.  No atomics: a
// replayed step gives the same bits.  Recomputing y costs K fmaf per
// pooled element, a third of one forward conv; storing it would cost a
// 67 MB round trip at the training batch.
//
// What bounds it: the dX pass's N L K O fmaf at two shared words each (as
// K5b), then the remat; the scratch (3 N M O floats, 201 MB at the training
// batch (128, 3200, 129, 128)) is written and read once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_pool_bwd.cuh"

namespace {

__global__ void __launch_bounds__(tpk::kLnWarps * 32)
conv_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ gt,
                   const float* __restrict__ bt, const int* __restrict__ seed_p,
                   const int8_t* __restrict__ idx,
                   const float* __restrict__ stats,
                   const float* __restrict__ dz, float* __restrict__ dy,
                   float* __restrict__ dgp, float* __restrict__ dbp, int L,
                   int K, int O, int M, int pool, float eps, int relu,
                   uint32_t threshold, float scale, int drop_on) {
  extern __shared__ float smem[];
  const int Kp = tpk::padded_taps(K);
  const int span = tpk::run_span(tpk::ln_runs(M, pool), pool, Kp);
  float* xs = smem;                   // the window
  float* ws = xs + span;              // Kp x kFilt
  float* cs = ws + Kp * tpk::kFilt;   // M x kFilt: c = y - mu
  float* red = cs + M * tpk::kFilt;   // 2 x kLnWarps x kFilt
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
    for (int m = warp; m < M; m += tpk::kLnWarps) {
      const size_t e = static_cast<size_t>(m) * O + o;
      const int sp = m * pool + idx[win + e];
      const float c = (tpk::conv_at(xs, ws, sp, lane, Kp) + b0) - mu;
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
      cs[m * tpk::kFilt + lane] = c;
      dy[win + e] = dzg;
    }
  }
  const float A = tpk::warp_sum(a_part, red);
  const float B = tpk::warp_sum(b_part, red + tpk::kLnWarps * tpk::kFilt);
  if (!active) return;
  const float fac = (B * r * r) /
                    (static_cast<float>(max(M - 1, 1)) * fmaxf(s, 1e-30f));
  const float rm = r / static_cast<float>(M);
  for (int m = warp; m < M; m += tpk::kLnWarps) {
    const size_t e = win + static_cast<size_t>(m) * O + o;
    dy[e] = r * dy[e] - cs[m * tpk::kFilt + lane] * fac - rm * A;
  }
}

}  // namespace

// The shared memory the layer-norm pass needs for a window of L samples.
extern "C" long tpk_conv_ln_smem_bytes(int L, int K, int pool) {
  return static_cast<long>(tpk::ln_smem_bytes(L, K, pool));
}

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.  dy, dgp and dbp are
// scratch of N * M * O floats, dw_part of N * K * O.
extern "C" int tpk_conv_ln_bwd(const float* x, const float* w,
                               const float* bias, const float* gt,
                               const float* bt, const int* seed,
                               const int8_t* idx, const float* stats,
                               const float* dz, float* dy, float* dgp,
                               float* dbp, float* dw_part, float* dx, float* dw,
                               float* dgt, float* dbt, int N, int L, int K,
                               int O, int pool, float eps, int relu,
                               unsigned threshold, float scale, int drop_on,
                               cudaStream_t stream) {
  if (!tpk::geometry_ok(N, L, K, O, pool)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tpk::ln_smem_bytes(L, K, pool);
  if (smem > tpk::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_ln_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = (L - K + 1) / pool;
  const dim3 grid(N, (O + tpk::kFilt - 1) / tpk::kFilt);
  conv_ln_bwd_kernel<<<grid, tpk::kLnWarps * 32, smem, stream>>>(
      x, w, bias, gt, bt, seed, idx, stats, dz, dy, dgp, dbp, L, K, O, M, pool,
      eps, relu, threshold, scale, drop_on);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tpk::launch_conv_pool_bwd(x, dy, idx, w, dw_part, dx, dw, N, L, K, O,
                                  pool, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mo = static_cast<size_t>(M) * O;
  err = tpk::launch_reduce(dgp, N, mo, dgt, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tpk::launch_reduce(dbp, N, mo, dbt, stream));
}
