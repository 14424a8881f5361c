// The LSTM cell step with a bf16 recurrent weight: the backward kernel's
// gate remat (lstm_lean_bwd.cu, K4b) calls lean_gates, and the forward
// kernel (lstm_lean_fwd.cu, K4f) applies the same gate functions
// (lean_sigmoid, tanhf) to its tensor-core sums.
//
// For batch row b and hidden unit j it computes
//
//     a_g = ff[t, b, gH + j] + sum_k bf16(h_prev[k]) * bf16(U[k, gH + j])
//     f, i, o = sigmoid(a_f, a_i, a_o),  cand = tanh(a_c)
//
// with every product exact in float32 (the product of two bf16 values fits
// in float32's mantissa) and the sum accumulated in float32, k ascending.
// tpukaldi's Pallas kernels (kernels/lstm.py, _lstm_lean_kernel and the
// phase-1 remat of _lstm_lean_bwd_kernel) compute the same products.  K4f
// sums them in the tensor cores' order and then across warps, so K4b's
// remat gates agree with K4f's to the float32 sum order, not bit for bit;
// the operands are the same (the bf16 rounding of the h that K4f wrote).
//
// U arrives packed, once per call, as upk (H, H) of 8-byte words:
// upk[k * H + j] = (U[k, j], U[k, H + j], U[k, 2H + j], U[k, 3H + j]) in
// bf16, so thread j reads its four gate weights of row k with one 8-byte
// load and a warp reads 256 neighbouring bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpk {

// the bf16 operand of a float32 value (round to nearest even, as torch's
// and XLA's casts), kept as the float32 it represents
__device__ __forceinline__ float bf16_operand(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the float32 values of the low and high bf16 of a 32-bit word (exact)
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float lean_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct LeanGates {
  float f, i, o, cand;
};

// The gates of hidden unit j at one step.  h_op holds the H bf16 operands
// of h_prev as float32 (shared memory); ff_t points at ff[t, b, :].
__device__ __forceinline__ LeanGates lean_gates(
    const uint2* __restrict__ upk, const float* h_op,
    const float* __restrict__ ff_t, int H, int j) {
  float acc_f = 0.0f;
  float acc_i = 0.0f;
  float acc_o = 0.0f;
  float acc_c = 0.0f;
  const uint2* col = upk + j;
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float hk = h_op[k];
    const uint2 w = col[static_cast<size_t>(k) * H];
    acc_f = fmaf(hk, bf16_lo(w.x), acc_f);
    acc_i = fmaf(hk, bf16_hi(w.x), acc_i);
    acc_o = fmaf(hk, bf16_lo(w.y), acc_o);
    acc_c = fmaf(hk, bf16_hi(w.y), acc_c);
  }
  LeanGates g;
  g.f = lean_sigmoid(ff_t[j] + acc_f);
  g.i = lean_sigmoid(ff_t[H + j] + acc_i);
  g.o = lean_sigmoid(ff_t[2 * H + j] + acc_o);
  g.cand = tanhf(ff_t[3 * H + j] + acc_c);
  return g;
}

}  // namespace tpk
