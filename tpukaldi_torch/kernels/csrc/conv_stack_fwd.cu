// The upper layers of the raw-waveform conv stack, for Hopper (sm_90a): K7f.
//
// Replaces tpukaldi/kernels/conv_stack.py::_stack_fwd_kernel (launched from
// _stack_fwd), which runs the whole stack for 8 windows in one program with
// every activation in VMEM.  Here layer 0 is K6f (conv_ln_fwd.cu) and this
// kernel runs once per upper layer i >= 1, per window n and filter o, over
// the layer's input h (N, lin, C), the previous layer's output:
//
//     c[t]  = sum_{c, k} h[n, t + k, c] * W[o, c, k]     t < M * pool
//     y     = max-pool(c)[m] + bias[o],  idx = the first argmax
//     mu    = sum_m y / M,  s = sqrt(sum_m (y - mu)^2 / max(M - 1, 1))
//     z     = ((y - mu) * r) * gt[m, o] + bt[m, o],  r = 1 / (s + eps)
//     z     = relu(z) if relu;  z = keep ? z * scale : 0 if drop_on
//
// keep = tpukaldi's hash of (seed, window id wid0 + n, element m * 128 + o)
// below the threshold (conv_tile.cuh::drop_keep), wid0 = i * 2^20.  Writes
// out (N, M, O), the next layer's input, and, when they are not null
// (training), idx (N, M, O) int8 and stats (N, 2, O) = (mu, s), which K7b
// reads.  float32 throughout; seed is an int32 on the device.
//
// Design: one block per (window n, tile of 32 filters), 16 warps, as K6f.
// A Hopper block has 227 KB of shared memory, so the VMEM-resident stack
// does not carry over: layer 0's pooled map alone is 512 KB a window.  The
// layer norm is per filter over time, so each filter tile is independent:
// the block keeps its tile's weights (C K 32 floats, 80 KB at C = 128, K =
// 5) and its pooled rows (M x 32) in shared memory and reads h from global
// memory (L1 and L2) as broadcasts.  A warp takes runs of 12 conv positions
// (stack_tile.cuh::upper_run: per channel 12 + K - 1 loads of h and K of
// weights for 12 K fmaf), max-pools them in registers, and the moments and
// the normalised, activated, dropped rows follow as in K6f.
//
// What bounds it: the conv's 2 N ct C K O flops (10.0 GFLOP for CNN_raw's
// layer 1 at the training batch of 128 windows, 0.15 ms at 67 TFLOP/s);
// the bytes of h, out, idx and stats are 81 MB there (0.02 ms).  Each
// fmaf also costs (12 + 2K - 1) / (12 K) of a load from L1 or shared
// memory; the kernel runs at about a tenth of the float32 peak (PERF.md,
// section 6), which staging h in shared memory or an implicit GEMM on the
// tensor cores would lift.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stack_tile.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(tpk::kLnWarps * 32)
stack_upper_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ gt,
                       const float* __restrict__ bt,
                       const int* __restrict__ seed_p, float* __restrict__ out,
                       int8_t* __restrict__ idx, float* __restrict__ stats,
                       int lin, int C, int O, int M, int pool, uint32_t wid0,
                       float eps, int relu, uint32_t threshold, float scale,
                       int drop_on) {
  extern __shared__ float smem[];
  float* ws = smem;                        // C K x kFilt
  float* ys = ws + C * K * tpk::kFilt;     // M x kFilt pooled rows + bias
  float* red = ys + M * tpk::kFilt;        // 2 x kLnWarps x kFilt
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * tpk::kFilt;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int o = o0 + lane;
  const bool active = o < O;
  const size_t win = static_cast<size_t>(n) * M * O;
  const float* hn = h + static_cast<size_t>(n) * lin * C;
  tpk::load_upper_filters(w, C, K, O, o0, ws);
  __syncthreads();

  const float b0 = active ? bias[o] : 0.0f;
  const int R = tpk::run_rows(pool);
  const int runs = tpk::ln_runs(M, pool);
  for (int g = warp; g < runs; g += tpk::kLnWarps) {
    float acc[tpk::kRun];
    tpk::upper_run<K>(hn, ws, g * R * pool, lin, C, lane, acc);
    tpk::pool_run(acc, pool, [&](int r, float m, int arg) {
      const int row = g * R + r;
      if (row < M) {
        ys[row * tpk::kFilt + lane] = m + b0;
        if (idx != nullptr && active) {
          idx[win + static_cast<size_t>(row) * O + o] = static_cast<int8_t>(arg);
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
      z = tpk::drop_keep(static_cast<uint32_t>(m) * tpk::kMaskLanes + o, seed,
                         wid0 + static_cast<uint32_t>(n), threshold)
              ? z * scale : 0.0f;
    }
    out[win + e] = z;
  }
  if (stats != nullptr && warp == 0) {
    stats[static_cast<size_t>(n) * 2 * O + o] = mu;
    stats[static_cast<size_t>(n) * 2 * O + O + o] = s;
  }
}

struct FwdArgs {
  const float *h, *w, *bias, *gt, *bt;
  const int* seed;
  float* out;
  int8_t* idx;
  float* stats;
  int N, lin, C, O, pool, M;
  uint32_t wid0;
  float eps;
  int relu;
  uint32_t threshold;
  float scale;
  int drop_on;
  size_t smem;
};

template <int K>
struct FwdLaunch {
  static cudaError_t run(const FwdArgs& a, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        stack_upper_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(a.N, (a.O + tpk::kFilt - 1) / tpk::kFilt);
    stack_upper_fwd_kernel<K><<<grid, tpk::kLnWarps * 32, a.smem, stream>>>(
        a.h, a.w, a.bias, a.gt, a.bt, a.seed, a.out, a.idx, a.stats, a.lin,
        a.C, a.O, a.M, a.pool, a.wid0, a.eps, a.relu, a.threshold, a.scale,
        a.drop_on);
    return cudaGetLastError();
  }
};

}  // namespace

// One upper layer.  Launches on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and only this return value reports it
// (tpk::kErrSmem where the layer needs too much shared memory).  idx and
// stats may be null (inference).
extern "C" int tpk_stack_upper_fwd(const float* h, const float* w,
                                   const float* bias, const float* gt,
                                   const float* bt, const int* seed,
                                   float* out, int8_t* idx, float* stats,
                                   int N, int lin, int C, int K, int O,
                                   int pool, int M, unsigned wid0, float eps,
                                   int relu, unsigned threshold, float scale,
                                   int drop_on, cudaStream_t stream) {
  if (!tpk::upper_geometry_ok(N, lin, C, K, O, pool, M)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tpk::upper_smem_bytes(C, K, M);
  if (smem > tpk::kMaxSmem) return tpk::kErrSmem;
  const FwdArgs a{h, w, bias, gt, bt, seed, out, idx, stats, N, lin, C, O,
                  pool, M, wid0, eps, relu, threshold, scale, drop_on, smem};
  return static_cast<int>(tpk::dispatch_taps<FwdLaunch>(K, a, stream));
}
