// GRU forward recurrence for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/gru.py::_gru_kernel (the Pallas forward,
// launched from _gru_pallas_fwd_impl).  For every batch row b it runs
//
//     [uz | ur] = h @ Uzr                       Uzr (H, 2H), Uh (H, H)
//     z  = sigmoid(ff[t, b, H:2H] + uz)
//     r  = sigmoid(ff[t, b, 2H:]  + ur)
//     a  = ff[t, b, 0:H] + (r * h) @ Uh
//     h  = z * h + (1 - z) * act(a) * mask[b]   h_0 = 0
//
// with act = relu (kAct 0) or tanh (kAct 1), and writes h for every step.
// ff is in tpukaldi's gate order [h | z | r].  All tensors are float32 and
// contiguous: ff (T, B, 3H), Uzr (H, 2H), Uh (H, H), mask (B, H), out
// (T, B, H).
//
// Design: the liGRU forward kernel's (ligru_fwd.cu), with the GRU's second,
// dependent product.  One CTA per batch row, one thread per hidden unit;
// the time loop runs inside the block.  Each step thread j accumulates
// columns j and H + j of h @ Uzr (reading Uzr row by row: coalesced), forms
// z_j and r_j, and puts r_j * h_j in shared memory; after a barrier it
// accumulates column j of (r * h) @ Uh, forms a_j and the new h_j, and
// writes it to shared memory and to out.  A second barrier ends the step:
// two per step, against the liGRU's one.  h_j stays in thread j's register
// too.  Every step of T runs; nothing is padded to a time block.
//
// What bounds it.  Each step every CTA re-reads Uzr and Uh (3H * H floats,
// 3.63 MB at H = 550) from L2, 1.5 times K1f's bytes.  Only B CTAs run.
// The persistent design (Sparse Persistent RNNs, PAPERS.md, arXiv
// 1804.10223) that keeps slices of both resident is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int kAct>
__global__ void __launch_bounds__(kMaxHidden)
gru_fwd_kernel(const float* __restrict__ ff, const float* __restrict__ uzr,
               const float* __restrict__ uh, const float* __restrict__ mask,
               float* __restrict__ out, int T, int B, int H) {
  extern __shared__ float smem[];  // h (H floats), then r * h (H floats)
  float* hs = smem;
  float* rh = smem + H;
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool active = j < H;
  const size_t two_h = 2 * static_cast<size_t>(H);
  const size_t three_h = 3 * static_cast<size_t>(H);

  float h_j = 0.0f;
  float z = 0.0f;
  const float m = active ? mask[static_cast<size_t>(b) * H + j] : 0.0f;
  if (active) hs[j] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    const float* ff_t = ff + row * three_h;
    if (active) {
      float acc_z = 0.0f;
      float acc_r = 0.0f;
      const float* u_col = uzr + j;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = hs[k];
        acc_z = fmaf(hk, u_col[k * two_h], acc_z);
        acc_r = fmaf(hk, u_col[k * two_h + H], acc_r);
      }
      z = sigmoidf(ff_t[H + j] + acc_z);
      const float r = sigmoidf(ff_t[2 * H + j] + acc_r);
      rh[j] = r * h_j;
    }
    __syncthreads();  // r * h complete; the reads of h are done
    if (active) {
      float acc = 0.0f;
      const float* uh_col = uh + j;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        acc = fmaf(rh[k], uh_col[static_cast<size_t>(k) * H], acc);
      }
      const float a = ff_t[j] + acc;
      const float act = kAct == 0 ? fmaxf(a, 0.0f) : tanhf(a);
      h_j = z * h_j + (1.0f - z) * (act * m);
      hs[j] = h_j;
      out[row * H + j] = h_j;
    }
    __syncthreads();  // h complete; the reads of r * h are done
  }
}

}  // namespace

extern "C" int tpk_gru_fwd_max_hidden() { return kMaxHidden; }

// act: 0 relu, 1 tanh.  Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this return
// value reports it.
extern "C" int tpk_gru_fwd(const float* ff, const float* uzr, const float* uh,
                           const float* mask, float* out, int T, int B, int H,
                           int act, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > kMaxHidden || act < 0 || act > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(H) * sizeof(float);
  if (act == 0) {
    gru_fwd_kernel<0><<<B, threads, smem, stream>>>(ff, uzr, uh, mask, out, T,
                                                    B, H);
  } else {
    gru_fwd_kernel<1><<<B, threads, smem, stream>>>(ff, uzr, uh, mask, out, T,
                                                    B, H);
  }
  return static_cast<int>(cudaGetLastError());
}
