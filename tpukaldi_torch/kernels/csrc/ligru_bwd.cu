// Li-GRU backward recurrence for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/ligru.py::_ligru_bwd_kernel (the Pallas
// backward, launched from _ligru_pallas_bwd_impl).  Given the forward's
// inputs ff (T, B, 2H), U = [Uh | Uz] (H, 2H), mask (B, H), its output h
// (T, B, H) and the gradient g of h (T, B, H), it returns
//
//     dff (T, B, 2H)   dA_t = [da_h | da_z] of every step
//     dU  (H, 2H)      sum over t, b of h_prev[t, b]^T dA[t, b]
//     dmask (B, H)     sum over t of dhc * relu(a_h)
//
// walking time backwards with h_prev[t] = h[t - 1] (zeros at t = 0):
//
//     a_h  = ff_h + h_prev @ Uh,  z = sigmoid(ff_z + h_prev @ Uz)
//     gh   = g[t] + dh                        dh carried from step t + 1
//     da_z = gh * (h_prev - relu(a_h) * m) * z * (1 - z)
//     dhc  = gh * (1 - z),  da_h = dhc * m * [a_h > 0]
//     dh   = gh * z + dA @ U^T                dh of step t - 1
//
// All tensors are float32 and contiguous; the caller also passes U^T
// (2H, H), made once per call.
//
// Design.  Two kernels on one stream.
//
// 1. ligru_bwd_seq_kernel, the sequential pass: one CTA per batch row
//    (rows are independent, as in the forward kernel ligru_fwd.cu) and one
//    thread per hidden unit; the time loop runs backwards inside the block.
//    Each step thread j puts h_prev[j] in shared memory, recomputes its two
//    gate columns from it exactly as the forward kernel does (reading U row
//    by row: a warp reads 32 neighbouring floats), forms dA, writes dff[t]
//    and puts dA in shared memory.  After __syncthreads() it forms
//    dh[j] = gh * z + sum_c dA[c] * U^T[c, j], reading U^T row by row, so
//    again a warp's reads are neighbouring floats (U's own rows are 2H
//    apart).  dmask[b, j] accumulates in a register and is written once.
//    Two barriers per step; every step of T runs (the Pallas kernel pads T
//    to its 16-step time block).
// 2. dU = h_prev^T dff over the T * B rows: the deterministic tiled pass of
//    du_tile.cuh, shared with the LSTM and GRU backward kernels.
//
// What bounds it.  The sequential pass reads U twice per step from L2
// (once as U for the gates, once as U^T for the dh chain), 16 H^2 bytes
// per CTA per step against the forward kernel's 8 H^2: on an H100 80GB HBM3
// (700 W) it takes ~62 us per step at H = 550, B = 16, against the forward
// kernel's ~39 us.  Only B
// CTAs run, so at the training batch (B' = 16 after the bidirectional
// flip) 116 of the 132 SMs idle during it.  The later design is the
// persistent one (ROADMAP.md section 2): each CTA of the whole grid keeps a
// column slice of U (and of U^T) resident in shared memory for all T steps
// and exchanges h and dA through a grid-wide barrier every step
// (Sparse Persistent RNNs, PAPERS.md, arXiv 1804.10223).

#include <cuda_runtime.h>

#include "du_tile.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__global__ void ligru_bwd_seq_kernel(const float* __restrict__ ff,
                                     const float* __restrict__ h,
                                     const float* __restrict__ g,
                                     const float* __restrict__ u,
                                     const float* __restrict__ ut,
                                     const float* __restrict__ mask,
                                     float* __restrict__ dff,
                                     float* __restrict__ dmask,
                                     int T, int B, int H) {
  extern __shared__ float smem[];  // h_prev (H floats), then dA (2H floats)
  float* hp = smem;
  float* da = smem + H;
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool active = j < H;
  const size_t two_h = 2 * static_cast<size_t>(H);

  const float m = active ? mask[static_cast<size_t>(b) * H + j] : 0.0f;
  float dh = 0.0f;  // dL/dh_t[j], carried from step t + 1
  float dm = 0.0f;  // dmask[b, j]

  for (int t = T - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    float hp_j = 0.0f;
    if (active) {
      hp_j = t > 0 ? h[(row - B) * H + j] : 0.0f;
      hp[j] = hp_j;
    }
    __syncthreads();  // h_prev complete; last step's dA reads are done
    float gh = 0.0f;
    float zt = 0.0f;
    if (active) {
      float acc_h = 0.0f;
      float acc_z = 0.0f;
      const float* u_col = u + j;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = hp[k];
        acc_h = fmaf(hk, u_col[k * two_h], acc_h);
        acc_z = fmaf(hk, u_col[k * two_h + H], acc_z);
      }
      const float* ff_t = ff + row * two_h;
      const float a_h = ff_t[j] + acc_h;
      zt = 1.0f / (1.0f + expf(-(ff_t[H + j] + acc_z)));
      const float relu_ah = fmaxf(a_h, 0.0f);
      gh = g[row * H + j] + dh;
      const float da_z = gh * (hp_j - relu_ah * m) * zt * (1.0f - zt);
      const float dhc = gh * (1.0f - zt);
      const float da_h = a_h > 0.0f ? dhc * m : 0.0f;
      dff[row * two_h + j] = da_h;
      dff[row * two_h + H + j] = da_z;
      da[j] = da_h;
      da[H + j] = da_z;
      dm = fmaf(dhc, relu_ah, dm);
    }
    __syncthreads();  // dA complete; the gate reads of h_prev are done
    if (active) {
      float acc = gh * zt;
      const float* ut_col = ut + j;
#pragma unroll 8
      for (int c = 0; c < 2 * H; ++c) {
        acc = fmaf(da[c], ut_col[static_cast<size_t>(c) * H], acc);
      }
      dh = acc;
    }
  }
  if (active) dmask[static_cast<size_t>(b) * H + j] = dm;
}

}  // namespace

extern "C" int tpk_ligru_bwd_max_hidden() { return kMaxHidden; }

// Launches both kernels on `stream` and returns cudaGetLastError() after
// each: a refused launch never runs, and only this return value reports it.
extern "C" int tpk_ligru_bwd(const float* ff, const float* h, const float* g,
                             const float* u, const float* ut,
                             const float* mask, float* dff, float* du,
                             float* dmask, int T, int B, int H,
                             cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = 3 * static_cast<size_t>(H) * sizeof(float);
  ligru_bwd_seq_kernel<<<B, threads, smem, stream>>>(ff, h, g, u, ut, mask,
                                                     dff, dmask, T, B, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tpk::launch_du(h, B, dff, 2 * H, 0, 2 * H, du, T * B, H, stream));
}
