// Backward of the valid single-channel conv + max-pool, for Hopper (sm_90a):
// K5b.
//
// Replaces tpukaldi/kernels/conv1d.py::_bwd_kernel (launched from
// _conv_pool_bwd).  From the pooled gradient dy (N, M, O) and the forward's
// argmax idx (N, M, O) int8, with dconv the gradient scattered through idx
// onto the conv rows (the tail past M * pool gets none):
//
//     dx[n, t] = sum_o sum_k dconv[n, t - k, o] * w[k, o]
//     dw[k, o] = sum_n sum_m x[n, m * pool + idx[n, m, o] + k] * dy[n, m, o]
//
// in float32, three passes (conv_pool_bwd.cuh): dX in gather form, only
// where the caller asks for it (a null dx skips it, for an input that
// needs no gradient, such as a waveform fed in as it is), each thread
// kDxRun consecutive samples over a shared tile of the scattered gradient
// (no atomics); each window's share of dW, a block per group of up to 136
// taps, summed in levels of at most 32 terms (16 rows, 32 stages,
// blocks), into dw_part (N, K, O); then the
// windows, 32 at a time.  A replayed step gives the same bits, and dw is
// the same with or without dx.  The Pallas kernel keeps dW in an output
// block resident over its sequential grid; Hopper's blocks run in no
// order, hence the partials and the second pass.
//
// What bounds it: dW's 2 N M K O flops (2.7 GFLOP at the training batch
// (128, 3200, 129, 80), 0.04 ms at 67 TFLOP/s) and, where dX is asked for,
// as many again (a third of the dense N L K O fmaf the gather form runs).
// The dX pass runs the dense form at a quarter of a shared load per fmaf
// (a sliding window of kTapChunk new samples and two 16-byte weight
// broadcasts per kDxRun x kTapChunk fmaf); the dW pass at about one
// shared word per fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_pool_bwd.cuh"

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.  dw_part is scratch
// of N * K * O floats; dx may be null (no dX pass).
extern "C" int tpk_conv_pool_bwd(const float* x, const float* dy,
                                 const int8_t* idx, const float* w,
                                 float* dw_part, float* dx, float* dw, int N,
                                 int L, int K, int O, int pool,
                                 cudaStream_t stream) {
  if (!tpk::geometry_ok(N, L, K, O, pool)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(tpk::launch_conv_pool_bwd(
      x, dy, idx, w, dw_part, dx, dw, N, L, K, O, pool, stream));
}
