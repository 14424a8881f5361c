// LSTM forward recurrence for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/lstm.py::_lstm_kernel (the Pallas forward,
// launched from _lstm_pallas_fwd_impl).  For every batch row b it runs
//
//     r  = h @ U                       U = [Uf | Ui | Uo | Uc], (H, 4H)
//     f  = sigmoid(ff[t, b, 0:H]   + r[0:H])
//     i  = sigmoid(ff[t, b, H:2H]  + r[H:2H])
//     o  = sigmoid(ff[t, b, 2H:3H] + r[2H:3H])
//     c  = i * tanh(ff[t, b, 3H:] + r[3H:]) * mask[b] + f * c
//     h  = o * tanh(c)                 h_0 = c_0 = 0
//
// and writes h and c for every step (the backward recomputes the gates from
// them).  All tensors are float32 and contiguous: ff (T, B, 4H), U (H, 4H),
// mask (B, H), h and c (T, B, H).
//
// Design: the liGRU forward kernel's (ligru_fwd.cu) with four gate columns.
// One CTA per batch row, one thread per hidden unit; the time loop runs
// inside the block.  h of the row lives in shared memory, double buffered,
// so one __syncthreads() per step separates the reads of h_{t-1} from the
// writes of h_t; c_j stays in thread j's register.  Thread j accumulates
// columns j, H + j, 2H + j and 3H + j of h @ U in float32, reading U row by
// row, so a warp reads 32 neighbouring floats four times per row
// (coalesced).  Every step of T runs; nothing is padded to a time block.
//
// What bounds it.  Each step every CTA re-reads all of U (4H * H floats,
// 4.84 MB at H = 550) from L2, twice K1f's bytes: T * B * 16 H^2 bytes of
// L2 traffic for 8 T B H^2 flops.  Only B CTAs run (B <= 132 fills at most
// one wave).  The persistent design that keeps a column slice of U resident
// in each CTA's shared memory and exchanges h across CTAs every step
// (Sparse Persistent RNNs, PAPERS.md, arXiv 1804.10223) removes the L2
// re-reads; it is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kMaxHidden)
lstm_fwd_kernel(const float* __restrict__ ff, const float* __restrict__ u,
                const float* __restrict__ mask, float* __restrict__ h_out,
                float* __restrict__ c_out, int T, int B, int H) {
  extern __shared__ float h_smem[];  // 2 * H floats: h_{t-1}, h_t
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
      float acc_f = 0.0f;
      float acc_i = 0.0f;
      float acc_o = 0.0f;
      float acc_c = 0.0f;
      const float* u_col = u + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = h_prev[k];
        const float* u_row = u_col + k * four_h;
        acc_f = fmaf(hk, u_row[0], acc_f);
        acc_i = fmaf(hk, u_row[H], acc_i);
        acc_o = fmaf(hk, u_row[2 * H], acc_o);
        acc_c = fmaf(hk, u_row[3 * H], acc_c);
      }
      const size_t row = static_cast<size_t>(t) * B + b;
      const float* ff_t = ff + row * four_h;
      const float f = sigmoidf(ff_t[j] + acc_f);
      const float i = sigmoidf(ff_t[H + j] + acc_i);
      const float o = sigmoidf(ff_t[2 * H + j] + acc_o);
      const float cand = tanhf(ff_t[3 * H + j] + acc_c);
      c_j = i * cand * m + f * c_j;
      const float h_j = o * tanhf(c_j);
      h_next[j] = h_j;
      h_out[row * H + j] = h_j;
      c_out[row * H + j] = c_j;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tpk_lstm_fwd_max_hidden() { return kMaxHidden; }

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// (too many threads, too much shared memory) never runs, and only this
// return value reports it.
extern "C" int tpk_lstm_fwd(const float* ff, const float* u, const float* mask,
                            float* h_out, float* c_out, int T, int B, int H,
                            cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(H) * sizeof(float);
  lstm_fwd_kernel<<<B, threads, smem, stream>>>(ff, u, mask, h_out, c_out, T,
                                                B, H);
  return static_cast<int>(cudaGetLastError());
}
