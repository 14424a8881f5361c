// The gate function of the bf16-U LSTM kernels: K4f (lstm_lean_fwd.cu)
// and K4b's remat (lstm_lean_bwd.cu) apply lean_sigmoid and tanhf to the
// same float32 sums of exact bf16 products, as tpukaldi's Pallas kernels
// (kernels/lstm.py, _lstm_lean_kernel and the phase-1 remat of
// _lstm_lean_bwd_kernel) apply jax.nn.sigmoid and jnp.tanh.

#pragma once

#include <cuda_runtime.h>

namespace tpk {

__device__ __forceinline__ float lean_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

}  // namespace tpk
