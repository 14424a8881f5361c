// GRU backward recurrence for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/gru.py::_gru_bwd_kernel (the Pallas backward,
// launched from _gru_pallas_bwd_impl).  Given the forward's inputs ff
// (T, B, 3H) in gate order [h | z | r], Uzr (H, 2H), Uh (H, H), mask
// (B, H), its output h (T, B, H) and the gradient g of h (T, B, H), it
// returns
//
//     dff  (T, B, 3H)  [da | da_z | da_r] of every step, in ff's order
//     dUzr (H, 2H)     sum over t, b of h_prev^T [da_z | da_r]
//     dUh  (H, H)      sum over t, b of (r * h_prev)^T da
//     dmask (B, H)     sum over t of dhc * act(a)
//
// walking time backwards with h_prev[t] = h[t - 1] (zeros at t = 0), the
// gates recomputed from h_prev:
//
//     z, r = sigmoid(ff_z, ff_r + h_prev @ Uzr),  a = ff_h + (r h_prev) @ Uh
//     gh   = g[t] + dh                            dh carried from step t + 1
//     da_z = gh * (h_prev - act(a) * m) * z * (1 - z)
//     dhc  = gh * (1 - z),  da = dhc * m * act'(a)
//     drh  = da @ Uh^T,  da_r = drh * h_prev * r * (1 - r)
//     dh   = gh * z + drh * r + [da_z | da_r] @ Uzr^T     for step t - 1
//
// with act = relu (kAct 0, act' = [a > 0]) or tanh (kAct 1, act' =
// 1 - tanh(a)^2, recomputed).  All tensors are float32 and contiguous; the
// caller also passes Uh^T (H, H) and Uzr^T (2H, H), made once per call, and
// a scratch rh (T, B, H) for r * h_prev.
//
// Design: the liGRU backward's (ligru_bwd.cu), with the GRU's chain of
// three dependent products per step.  Three launches on one stream.
//
// 1. gru_bwd_seq_kernel, the sequential pass: one CTA per batch row and one
//    thread per hidden unit; the time loop runs backwards inside the block.
//    Per step thread j forms z_j and r_j from h_prev @ Uzr, puts r_j *
//    h_prev[j] in shared memory (and in the scratch rh, for dUh); barrier;
//    forms a_j from (r * h_prev) @ Uh, then da_j and da_z, and puts da_j in
//    shared memory; barrier; forms drh_j = da @ Uh^T[:, j] and da_r, puts
//    [da_z | da_r] in shared memory, and puts the next step's h_prev[j] in
//    the other half of a double buffer; barrier; forms dh_j from
//    [da_z | da_r] @ Uzr^T[:, j].  Three barriers per step.  Every product
//    reads its matrix row by row, so a warp reads 32 neighbouring floats.
//    dmask[b, j] accumulates in a register and is written once.  Every step
//    of T runs (the Pallas kernel pads T to its 8-step time block and runs
//    the padded steps first).
// 2. dUzr = h_prev^T dff[..., H:] and dUh = rh^T dff[..., :H] over the T * B
//    rows: two calls of the deterministic tiled pass of du_tile.cuh.
//
// What bounds it.  The sequential pass reads Uzr, Uh, Uh^T and Uzr^T from L2
// every step, 24 H^2 bytes per CTA per step (7.26 MB at H = 550), with only
// B CTAs running.  The persistent design (Sparse Persistent RNNs, PAPERS.md,
// arXiv 1804.10223) that keeps slices of all four resident is later work.

#include <cuda_runtime.h>

#include "du_tile.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int kAct>
__global__ void __launch_bounds__(kMaxHidden)
gru_bwd_seq_kernel(const float* __restrict__ ff, const float* __restrict__ h,
                   const float* __restrict__ g, const float* __restrict__ uzr,
                   const float* __restrict__ uh, const float* __restrict__ uht,
                   const float* __restrict__ uzrt,
                   const float* __restrict__ mask, float* __restrict__ dff,
                   float* __restrict__ rh_out, float* __restrict__ dmask,
                   int T, int B, int H) {
  // h_prev double buffer (2H floats), r * h_prev (H), da (H), [da_z|da_r] (2H)
  extern __shared__ float smem[];
  float* hpb = smem;
  float* rh = smem + 2 * H;
  float* da_s = smem + 3 * H;
  float* dzr = smem + 4 * H;
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool active = j < H;
  const size_t two_h = 2 * static_cast<size_t>(H);
  const size_t three_h = 3 * static_cast<size_t>(H);

  const float m = active ? mask[static_cast<size_t>(b) * H + j] : 0.0f;
  float dh = 0.0f;  // dL/dh_t[j], carried from step t + 1
  float dm = 0.0f;  // dmask[b, j]

  if (active) {
    hpb[((T - 1) & 1) * H + j] =
        T > 1 ? h[(static_cast<size_t>(T - 2) * B + b) * H + j] : 0.0f;
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    const float* hp = hpb + (t & 1) * H;
    const float* ff_t = ff + row * three_h;
    float* dff_t = dff + row * three_h;
    float hp_j = 0.0f;
    float z = 0.0f;
    float r = 0.0f;
    if (active) {
      hp_j = hp[j];
      float acc_z = 0.0f;
      float acc_r = 0.0f;
      const float* u_col = uzr + j;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = hp[k];
        acc_z = fmaf(hk, u_col[k * two_h], acc_z);
        acc_r = fmaf(hk, u_col[k * two_h + H], acc_r);
      }
      z = sigmoidf(ff_t[H + j] + acc_z);
      r = sigmoidf(ff_t[2 * H + j] + acc_r);
      const float rh_j = r * hp_j;
      rh[j] = rh_j;
      rh_out[row * H + j] = rh_j;
    }
    __syncthreads();  // r * h_prev complete
    float gh = 0.0f;
    float da_z = 0.0f;
    if (active) {
      float acc = 0.0f;
      const float* uh_col = uh + j;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        acc = fmaf(rh[k], uh_col[static_cast<size_t>(k) * H], acc);
      }
      const float a = ff_t[j] + acc;
      const float act = kAct == 0 ? fmaxf(a, 0.0f) : tanhf(a);
      const float dact = kAct == 0 ? (a > 0.0f ? 1.0f : 0.0f)
                                   : 1.0f - act * act;
      gh = g[row * H + j] + dh;
      da_z = gh * (hp_j - act * m) * z * (1.0f - z);
      const float dhc = gh * (1.0f - z);
      const float da = dhc * m * dact;
      dff_t[j] = da;
      dff_t[H + j] = da_z;
      da_s[j] = da;
      dm = fmaf(dhc, act, dm);
    }
    __syncthreads();  // da complete
    float drh = 0.0f;
    if (active) {
      const float* uht_col = uht + j;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        drh = fmaf(da_s[k], uht_col[static_cast<size_t>(k) * H], drh);
      }
      const float da_r = drh * hp_j * r * (1.0f - r);
      dff_t[2 * H + j] = da_r;
      dzr[j] = da_z;
      dzr[H + j] = da_r;
      if (t > 0) {  // the next step's h_prev, into the other buffer
        hpb[((t - 1) & 1) * H + j] = t > 1 ? h[(row - 2 * B) * H + j] : 0.0f;
      }
    }
    __syncthreads();  // [da_z | da_r] and the next h_prev complete
    if (active) {
      float acc = gh * z + drh * r;
      const float* uzrt_col = uzrt + j;
#pragma unroll 8
      for (int k = 0; k < 2 * H; ++k) {
        acc = fmaf(dzr[k], uzrt_col[static_cast<size_t>(k) * H], acc);
      }
      dh = acc;
    }
  }
  if (active) dmask[static_cast<size_t>(b) * H + j] = dm;
}

}  // namespace

extern "C" int tpk_gru_bwd_max_hidden() { return kMaxHidden; }

// act: 0 relu, 1 tanh.  Launches the three kernels on `stream` and returns
// cudaGetLastError() after each: a refused launch never runs, and only this
// return value reports it.
extern "C" int tpk_gru_bwd(const float* ff, const float* h, const float* g,
                           const float* uzr, const float* uh, const float* uht,
                           const float* uzrt, const float* mask, float* dff,
                           float* duzr, float* duh, float* dmask,
                           float* rh_scratch, int T, int B, int H, int act,
                           cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > kMaxHidden || act < 0 || act > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = 6 * static_cast<size_t>(H) * sizeof(float);
  if (act == 0) {
    gru_bwd_seq_kernel<0><<<B, threads, smem, stream>>>(
        ff, h, g, uzr, uh, uht, uzrt, mask, dff, rh_scratch, dmask, T, B, H);
  } else {
    gru_bwd_seq_kernel<1><<<B, threads, smem, stream>>>(
        ff, h, g, uzr, uh, uht, uzrt, mask, dff, rh_scratch, dmask, T, B, H);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tpk::launch_du(h, B, dff, 3 * H, H, 2 * H, duzr, T * B, H, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tpk::launch_du(rh_scratch, 0, dff, 3 * H, 0, H, duh, T * B, H, stream));
}
