// LSTM backward recurrence for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/lstm.py::_lstm_bwd_kernel (the Pallas backward,
// launched from _lstm_pallas_bwd_impl).  Given the forward's inputs ff
// (T, B, 4H), U = [Uf | Ui | Uo | Uc] (H, 4H), mask (B, H), its outputs h
// and c (T, B, H) and the gradient g of h (T, B, H), it returns
//
//     dff (T, B, 4H)   dA_t = [da_f | da_i | da_o | da_c] of every step
//     dU  (H, 4H)      sum over t, b of h_prev[t, b]^T dA[t, b]
//     dmask (B, H)     sum over t of dc * i * cand
//
// walking time backwards with h_prev[t] = h[t - 1], c_prev[t] = c[t - 1]
// (zeros at t = 0), the gates recomputed from h_prev:
//
//     a = ff + h_prev @ U;  f, i, o = sigmoid(a_f, a_i, a_o);  cand = tanh(a_c)
//     gh   = g[t] + dh                            dh, dc carried from t + 1
//     da_o = gh * tanh(c) * o * (1 - o)
//     dc   = gh * o * (1 - tanh(c)^2) + dc
//     da_f = dc * c_prev * f * (1 - f)
//     da_i = dc * cand * m * i * (1 - i)
//     da_c = dc * i * m * (1 - cand^2)
//     dh   = dA @ U^T,  dc = dc * f                   for step t - 1
//
// All tensors are float32 and contiguous; the caller also passes U^T
// (4H, H), made once per call.
//
// Design: the liGRU backward's (ligru_bwd.cu) with four gates and the
// c chain.  Two kernels on one stream.
//
// 1. lstm_bwd_seq_kernel, the sequential pass: one CTA per batch row and
//    one thread per hidden unit; the time loop runs backwards inside the
//    block.  Each step thread j puts h_prev[j] in shared memory, recomputes
//    its four gate columns from it as the forward kernel does (reading U
//    row by row: a warp reads 32 neighbouring floats), forms dA, writes
//    dff[t] and puts dA in shared memory.  After __syncthreads() it forms
//    dh[j] = sum_c dA[c] * U^T[c, j], reading U^T row by row, again
//    coalesced.  dc_j stays in a register, dmask[b, j] accumulates in one
//    and is written once.  Two barriers per step; every step of T runs (the
//    Pallas kernel pads T to its 4-step time block and runs the padded
//    steps first).
// 2. dU = h_prev^T dff over the T * B rows: the deterministic tiled pass of
//    du_tile.cuh.
//
// What bounds it.  The sequential pass reads U twice per step from L2 (as
// U for the gates and as U^T for the dh chain), 32 H^2 bytes per CTA per
// step, 9.7 MB at H = 550, with only B CTAs running.  The persistent design
// (each CTA of the whole grid keeping a column slice of U and of U^T
// resident in shared memory and exchanging h and dA through a grid-wide
// barrier every step; Sparse Persistent RNNs, PAPERS.md, arXiv 1804.10223)
// is later work.

#include <cuda_runtime.h>

#include "du_tile.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kMaxHidden)
lstm_bwd_seq_kernel(const float* __restrict__ ff, const float* __restrict__ h,
                    const float* __restrict__ c, const float* __restrict__ g,
                    const float* __restrict__ u, const float* __restrict__ ut,
                    const float* __restrict__ mask, float* __restrict__ dff,
                    float* __restrict__ dmask, int T, int B, int H) {
  extern __shared__ float smem[];  // h_prev (H floats), then dA (4H floats)
  float* hp = smem;
  float* da = smem + H;
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
    if (active) hp[j] = t > 0 ? h[(row - B) * H + j] : 0.0f;
    __syncthreads();  // h_prev complete; last step's dA reads are done
    if (active) {
      float acc_f = 0.0f;
      float acc_i = 0.0f;
      float acc_o = 0.0f;
      float acc_c = 0.0f;
      const float* u_col = u + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = hp[k];
        const float* u_row = u_col + k * four_h;
        acc_f = fmaf(hk, u_row[0], acc_f);
        acc_i = fmaf(hk, u_row[H], acc_i);
        acc_o = fmaf(hk, u_row[2 * H], acc_o);
        acc_c = fmaf(hk, u_row[3 * H], acc_c);
      }
      const float* ff_t = ff + row * four_h;
      const float f = sigmoidf(ff_t[j] + acc_f);
      const float i = sigmoidf(ff_t[H + j] + acc_i);
      const float o = sigmoidf(ff_t[2 * H + j] + acc_o);
      const float cand = tanhf(ff_t[3 * H + j] + acc_c);
      const float tanh_c = tanhf(c[row * H + j]);
      const float c_prev = t > 0 ? c[(row - B) * H + j] : 0.0f;

      const float gh = g[row * H + j] + dh;
      const float da_o = gh * tanh_c * o * (1.0f - o);
      dc = gh * o * (1.0f - tanh_c * tanh_c) + dc;
      const float da_f = dc * c_prev * f * (1.0f - f);
      const float da_i = dc * cand * m * i * (1.0f - i);
      const float da_c = dc * i * m * (1.0f - cand * cand);
      float* dff_t = dff + row * four_h;
      dff_t[j] = da_f;
      dff_t[H + j] = da_i;
      dff_t[2 * H + j] = da_o;
      dff_t[3 * H + j] = da_c;
      da[j] = da_f;
      da[H + j] = da_i;
      da[2 * H + j] = da_o;
      da[3 * H + j] = da_c;
      dm = fmaf(dc * i, cand, dm);
      dc *= f;
    }
    __syncthreads();  // dA complete; the gate reads of h_prev are done
    if (active) {
      float acc = 0.0f;
      const float* ut_col = ut + j;
#pragma unroll 8
      for (int k = 0; k < 4 * H; ++k) {
        acc = fmaf(da[k], ut_col[static_cast<size_t>(k) * H], acc);
      }
      dh = acc;
    }
  }
  if (active) dmask[static_cast<size_t>(b) * H + j] = dm;
}

}  // namespace

extern "C" int tpk_lstm_bwd_max_hidden() { return kMaxHidden; }

// Launches both kernels on `stream` and returns cudaGetLastError() after
// each: a refused launch never runs, and only this return value reports it.
extern "C" int tpk_lstm_bwd(const float* ff, const float* h, const float* c,
                            const float* g, const float* u, const float* ut,
                            const float* mask, float* dff, float* du,
                            float* dmask, int T, int B, int H,
                            cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = 5 * static_cast<size_t>(H) * sizeof(float);
  lstm_bwd_seq_kernel<<<B, threads, smem, stream>>>(ff, h, c, g, u, ut, mask,
                                                    dff, dmask, T, B, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tpk::launch_du(h, B, dff, 4 * H, 0, 4 * H, du, T * B, H, stream));
}
