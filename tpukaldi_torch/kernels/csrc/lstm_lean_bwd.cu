// LSTM backward recurrence with a bf16 recurrent weight, for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/lstm.py::_lstm_lean_bwd_kernel (the Pallas
// backward of the "lean" LSTM, launched from _lstm_lean_bwd_impl).  Given
// the forward's inputs ff (T, B, 4H), U (H, 4H) and mask (B, H), its
// outputs h and c (T, B, H) and the gradient g of h (T, B, H), it returns
//
//     dff (T, B, 4H)   dA_t = [da_f | da_i | da_o | da_c] of every step
//     dmask (B, H)     sum over t of dc * i * cand
//
// walking time backwards with h_prev[t] = h[t - 1], c_prev[t] = c[t - 1]
// (zeros at t = 0), the gates recomputed from h_prev with the forward's
// bf16 products as one sequential float32 chain (lstm_lean_cell.cuh; K4f
// sums them on the tensor cores, so the two agree to the sum order):
//
//     gh   = g[t] + dh                            dh, dc carried from t + 1
//     da_o = gh * tanh(c) * o * (1 - o)
//     dc   = gh * o * (1 - tanh(c)^2) + dc
//     da_f = dc * c_prev * f * (1 - f)
//     da_i = dc * cand * m * i * (1 - i)
//     da_c = dc * i * m * (1 - cand^2)
//     dh   = bf16(dA) @ bf16(U)^T,  dc = dc * f       for step t - 1
//
// The dh products are exact in float32 and summed in float32, as the Pallas
// kernel's bf16 dot with float32 accumulation.  dU = h_prev^T dff is not
// formed here: like tpukaldi's _lean_bwd, the wrapper contracts it as one
// float32 GEMM over the T * B rows afterwards.  ff, h, c, g, mask, dff and
// dmask are float32.  The wrapper passes U packed twice, once per call:
// upk for the remat (lstm_lean_cell.cuh) and utp (H, H) of 8-byte words,
// utp[k * H + j] = (U[j, k], U[j, H + k], U[j, 2H + k], U[j, 3H + k]) in
// bf16, the transpose for the dh chain, so that thread j reads the four
// weights that meet dA[., k] with one 8-byte load, coalesced across the warp.
//
// Design: the float32 LSTM backward's sequential pass (lstm_bwd.cu) with
// half its weight bytes and no dU pass.  One CTA per batch row and one
// thread per hidden unit; the time loop runs backwards inside the block.
// Each step thread j puts the bf16 operand of h_prev[j] in shared memory,
// recomputes its four gates, forms dA, writes dff[t] and puts the bf16
// operands of dA in shared memory, (k, gate)-interleaved.  After
// __syncthreads() it forms dh[j] from them and utp.  dc_j stays in a
// register, dmask[b, j] accumulates in one and is written once.  Two
// barriers per step; every step of T runs (the Pallas kernel pads T to its
// time block; the padded steps carry zero gradient, so the outputs are the
// same).
//
// What bounds it.  Each step every CTA reads the bf16 U twice from L2 (upk
// for the gates, utp for the dh chain), 16 H^2 bytes (16 MB at H = 1024,
// inside the 50 MB L2), for 16 B H^2 flops across the B CTAs: one CTA's L2
// read rate sets the step.  K4f's persistent design (U resident in shared
// memory, lstm_lean_fwd.cu) is later work here.

#include <cuda_runtime.h>

#include "lstm_lean_cell.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__global__ void __launch_bounds__(kMaxHidden)
lstm_lean_bwd_kernel(const float* __restrict__ ff, const float* __restrict__ h,
                     const float* __restrict__ c, const float* __restrict__ g,
                     const uint2* __restrict__ upk,
                     const uint2* __restrict__ utp,
                     const float* __restrict__ mask, float* __restrict__ dff,
                     float* __restrict__ dmask, int T, int B, int H) {
  // the bf16 operands of dA (4H floats, at 4 k + gate; first, so that the
  // float4 reads are aligned), then of h_prev (H floats)
  extern __shared__ float4 smem4[];
  float* da = reinterpret_cast<float*>(smem4);
  float* hp = da + 4 * H;
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool active = j < H;
  const size_t four_h = 4 * static_cast<size_t>(H);

  const float m = active ? mask[static_cast<size_t>(b) * H + j] : 0.0f;
  float dh = 0.0f;  // dL/dh_t[j], carried from step t + 1
  float dc = 0.0f;  // dL/dc_t[j], carried from step t + 1
  float dm = 0.0f;  // dmask[b, j]

  for (int t = T - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    if (active) hp[j] = t > 0 ? tpk::bf16_operand(h[(row - B) * H + j]) : 0.0f;
    __syncthreads();  // h_prev complete; last step's dA reads are done
    if (active) {
      const float* ff_t = ff + row * four_h;
      const tpk::LeanGates gt = tpk::lean_gates(upk, hp, ff_t, H, j);
      const float tanh_c = tanhf(c[row * H + j]);
      const float c_prev = t > 0 ? c[(row - B) * H + j] : 0.0f;

      const float gh = g[row * H + j] + dh;
      const float da_o = gh * tanh_c * gt.o * (1.0f - gt.o);
      dc = gh * gt.o * (1.0f - tanh_c * tanh_c) + dc;
      const float da_f = dc * c_prev * gt.f * (1.0f - gt.f);
      const float da_i = dc * gt.cand * m * gt.i * (1.0f - gt.i);
      const float da_c = dc * gt.i * m * (1.0f - gt.cand * gt.cand);
      float* dff_t = dff + row * four_h;
      dff_t[j] = da_f;
      dff_t[H + j] = da_i;
      dff_t[2 * H + j] = da_o;
      dff_t[3 * H + j] = da_c;
      float4 ops;
      ops.x = tpk::bf16_operand(da_f);
      ops.y = tpk::bf16_operand(da_i);
      ops.z = tpk::bf16_operand(da_o);
      ops.w = tpk::bf16_operand(da_c);
      reinterpret_cast<float4*>(da)[j] = ops;
      dm = fmaf(dc * gt.i, gt.cand, dm);
      dc *= gt.f;
    }
    __syncthreads();  // dA complete; the gate reads of h_prev are done
    if (active) {
      const float4* da4 = reinterpret_cast<const float4*>(da);
      const uint2* col = utp + j;
      float acc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float4 a = da4[k];
        const uint2 w = col[static_cast<size_t>(k) * H];
        acc = fmaf(a.x, tpk::bf16_lo(w.x), acc);
        acc = fmaf(a.y, tpk::bf16_hi(w.x), acc);
        acc = fmaf(a.z, tpk::bf16_lo(w.y), acc);
        acc = fmaf(a.w, tpk::bf16_hi(w.y), acc);
      }
      dh = acc;
    }
  }
  if (active) dmask[static_cast<size_t>(b) * H + j] = dm;
}

}  // namespace

extern "C" int tpk_lstm_lean_bwd_max_hidden() { return kMaxHidden; }

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.
extern "C" int tpk_lstm_lean_bwd(const float* ff, const float* h,
                                 const float* c, const float* g,
                                 const void* upk, const void* utp,
                                 const float* mask, float* dff, float* dmask,
                                 int T, int B, int H, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = 5 * static_cast<size_t>(H) * sizeof(float);
  lstm_lean_bwd_kernel<<<B, threads, smem, stream>>>(
      ff, h, c, g, static_cast<const uint2*>(upk),
      static_cast<const uint2*>(utp), mask, dff, dmask, T, B, H);
  return static_cast<int>(cudaGetLastError());
}
