// The upper layers of the raw-waveform conv stack, for Hopper (sm_90a): K7f.
//
// Replaces tpukaldi/kernels/conv_stack.py::_stack_fwd_kernel (launched from
// _stack_fwd), which runs the whole stack for 8 windows in one program with
// every activation in VMEM.  Here layer 0 is K6f (conv_ln_fwd.cu) and this
// entry runs once per upper layer i >= 1, per window n and filter o, over
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
// out (N, M, O), the next layer's input, and y (N, M, O), the pooled value
// plus bias; in training also idx (N, M, O) int8 and stats (N, 2, O) = (mu,
// s), which K7b reads with y.  Serving passes y == out (the epilogue
// normalises in place) and null idx and stats.  float32 throughout; seed is
// an int32 on the device.
//
// Design: three launches.  (1) The weights into the GEMM's layout (C K rows
// of the padded filters, stack_tile.cuh::prep_weights_kernel).  (2) The conv
// and max-pool as stack_tile.cuh's register-tiled implicit GEMM: block
// (span of pooled rows, 64 filters, window), 8 conv positions x 8 filters a
// thread, the channels staged 16 at a time by cp.async, double-buffered;
// the conv rows then go through shared memory to be pooled, and y and idx
// to global memory.  Each conv value is the one chain of fmaf (c outer, k
// inner) of the kernel before it, so y and idx are its bits.  (3) The layer
// norm over time couples a (window, filter)'s M pooled rows, so it is a
// second kernel: block (window, 32 filters), 16 warps, y read into shared
// memory, then the moments, the affine map, relu and dropout with the code
// and sum order of the kernel before it, so stats and out keep their bits.
// One kernel that held a window's whole conv would need a block of 4x the
// positions for CNN_raw's layer 1 and leave the card a quarter full.
//
// What bounds it: the conv's 2 N ct C K O flops (10.0 GFLOP for CNN_raw's
// layer 1 at the training batch of 128 windows, 0.15 ms at 67 TFLOP/s);
// the bytes of h, out, y, idx and stats are 91 MB there (0.03 ms).  The
// tile needs 22 shared loads a thread for 320 fmaf; 60 filters pad to 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stack_tile.cuh"

namespace {

__global__ void __launch_bounds__(tpk::kLnWarps * 32)
stack_ln_fwd_kernel(const float* y, const float* __restrict__ gt,
                    const float* __restrict__ bt,
                    const int* __restrict__ seed_p, float* out,
                    float* __restrict__ stats, int O, int M, uint32_t wid0,
                    float eps, int relu, uint32_t threshold, float scale,
                    int drop_on) {
  extern __shared__ float smem[];
  float* ys = smem;                  // M x kFilt pooled rows + bias
  float* red = ys + M * tpk::kFilt;  // 2 x kLnWarps x kFilt
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * tpk::kFilt;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int o = o0 + lane;
  const bool active = o < O;
  const size_t win = static_cast<size_t>(n) * M * O;
  // every read of y precedes the barrier, every write of out follows it:
  // y may be out
  for (int i = threadIdx.x; i < M * tpk::kFilt; i += blockDim.x) {
    const int oo = o0 + i % tpk::kFilt;
    ys[i] = oo < O ? y[win + static_cast<size_t>(i / tpk::kFilt) * O + oo]
                   : 0.0f;
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

struct ConvArgs {
  tpk::GemmArgs g;
  int N;
};

template <int K>
struct ConvLaunch {
  static cudaError_t run(const ConvArgs& a, cudaStream_t stream) {
    return tpk::launch_gemm<K, true>(a.g, a.N, stream);
  }
};

}  // namespace

// Floats of scratch the entry takes: the weights in the GEMM's layout
extern "C" long tpk_stack_upper_fwd_scratch(int C, int K, int O) {
  return static_cast<long>(C) * K * tpk::gemm_cols_pad(O);
}

// One upper layer.  Launches on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and only this return value reports it
// (tpk::kErrSmem where the layer needs too much shared memory).  y may be
// out, and idx and stats null (inference); scratch holds
// tpk_stack_upper_fwd_scratch floats.
extern "C" int tpk_stack_upper_fwd(const float* h, const float* w,
                                   const float* bias, const float* gt,
                                   const float* bt, const int* seed, float* y,
                                   float* out, int8_t* idx, float* stats,
                                   float* scratch, int N, int lin, int C,
                                   int K, int O, int pool, int M,
                                   unsigned wid0, float eps, int relu,
                                   unsigned threshold, float scale,
                                   int drop_on, cudaStream_t stream) {
  if (!tpk::upper_geometry_ok(N, lin, C, K, O, pool, M)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t ln_smem = tpk::ln_smem_bytes(M);
  if (ln_smem > tpk::kMaxSmem) return tpk::kErrSmem;
  cudaError_t err = tpk::launch_prep(w, O, C, K, 0, scratch, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ConvArgs a{{h, lin, C, scratch, 0, 0, M * pool, y, idx, bias, O,
                    pool, M},
                   N};
  err = tpk::dispatch_taps<ConvLaunch>(K, a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tpk::allow_smem(stack_ln_fwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N, (O + tpk::kFilt - 1) / tpk::kFilt);
  stack_ln_fwd_kernel<<<grid, tpk::kLnWarps * 32, ln_smem, stream>>>(
      y, gt, bt, seed, out, stats, O, M, wid0, eps, relu, threshold, scale,
      drop_on);
  return static_cast<int>(cudaGetLastError());
}
