// LSTM forward recurrence with a bf16 recurrent weight, for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/lstm.py::_lstm_lean_kernel (the Pallas forward
// of the "lean" LSTM, launched from _lstm_lean_fwd_impl), the QLSTM's
// recurrence.  For every batch row b it runs
//
//     r  = bf16(h) @ bf16(U)           U = [Uf | Ui | Uo | Uc], (H, 4H)
//     f, i, o = sigmoid(ff_{f,i,o} + r_{f,i,o}),  cand = tanh(ff_c + r_c)
//     c  = i * cand * mask[b] + f * c
//     h  = o * tanh(c)                 h_0 = c_0 = 0
//
// with exact float32 products and float32 sums (lstm_lean_cell.cuh), and
// writes h and c for every step in float32: h stays float32 and is rounded
// to bf16 only as the product's operand.  ff (T, B, 4H), mask (B, H), h and
// c (T, B, H) are float32; U arrives packed as upk (H, H) of 8-byte bf16
// quadruples (lstm_lean_cell.cuh), made once per call by the wrapper.
//
// Design: the float32 LSTM kernel's (lstm_fwd.cu) with half its weight
// bytes.  One CTA per batch row, one thread per hidden unit, the time loop
// inside the block; the h operands of the row live in shared memory, double
// buffered, so one __syncthreads() per step separates the reads of h_{t-1}
// from the writes of h_t; c_j stays in thread j's register.  Every step of
// T runs (the Pallas kernel pads T to its time block; the padding sits at
// the end of time, so the outputs are the same).
//
// What bounds it.  Each step every CTA reads all of the bf16 U from L2,
// 8 H^2 bytes (8 MB at H = 1024, half of K2f's float32 16 MB, and inside
// the 50 MB L2), for 8 B H^2 flops across the B CTAs: at one CTA per batch
// row a step costs one CTA's L2 read rate, not the card's tensor cores.
// The persistent design that keeps a column slice of U resident in each
// CTA's shared memory (Sparse Persistent RNNs, arXiv 1804.10223; ROADMAP)
// removes the re-reads; it is later work.

#include <cuda_runtime.h>

#include "lstm_lean_cell.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__global__ void __launch_bounds__(kMaxHidden)
lstm_lean_fwd_kernel(const float* __restrict__ ff,
                     const uint2* __restrict__ upk,
                     const float* __restrict__ mask, float* __restrict__ h_out,
                     float* __restrict__ c_out, int T, int B, int H) {
  extern __shared__ float h_smem[];  // 2 * H bf16 operands: h_{t-1}, h_t
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool active = j < H;
  const size_t four_h = 4 * static_cast<size_t>(H);

  float c_j = 0.0f;
  const float m = active ? mask[static_cast<size_t>(b) * H + j] : 0.0f;
  if (active) h_smem[j] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h_prev = h_smem + (t & 1) * H;
    float* h_next = h_smem + ((t + 1) & 1) * H;
    if (active) {
      const size_t row = static_cast<size_t>(t) * B + b;
      const tpk::LeanGates g =
          tpk::lean_gates(upk, h_prev, ff + row * four_h, H, j);
      c_j = g.i * g.cand * m + g.f * c_j;
      const float h_j = g.o * tanhf(c_j);
      h_next[j] = tpk::bf16_operand(h_j);
      h_out[row * H + j] = h_j;
      c_out[row * H + j] = c_j;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tpk_lstm_lean_fwd_max_hidden() { return kMaxHidden; }

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// (too many threads, too much shared memory) never runs, and only this
// return value reports it.
extern "C" int tpk_lstm_lean_fwd(const float* ff, const void* upk,
                                 const float* mask, float* h_out, float* c_out,
                                 int T, int B, int H, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(H) * sizeof(float);
  lstm_lean_fwd_kernel<<<B, threads, smem, stream>>>(
      ff, static_cast<const uint2*>(upk), mask, h_out, c_out, T, B, H);
  return static_cast<int>(cudaGetLastError());
}
