// The GRU backward's gate rematerialisation as two parallel passes over all
// R = T * B rows (gru_bwd.cu's first two launches):
//
//     [z | r] = sigmoid(ff_zr + h_prev @ Uzr)      (R, 2H)
//     rh      = r * h_prev                         (R, H), into rh
//     a       = ff_h + rh @ Uh                     (R, H)
//
// with ff (R, 3H) in gate order [h | z | r] and h_prev the forward's h read
// B rows back (zeros for the first B rows, t = 0).  a, z and r go into
// `out` (R, 3H) in ff's order, which the chain then overwrites in place
// with [da | da_z | da_r]; rh is what dUh = rh^T da reads.  The second pass
// reads the first's rh, so they are two launches on one stream.
//
// Nothing here depends on the dh chain.  Both passes are float32 tiled
// GEMMs on K2b's tiling (lstm_remat.cuh::remat_tile: a 128 x 64 output
// tile a block, depth stages of 16, 8 x 4 outputs a thread; TF32 stays
// off), each output one fmaf chain over k in ascending order, so two calls
// give the same bits.  That sum order differs from K3f's and from the
// plain version's, so z, r and a agree with theirs to the sum order (for
// relu, act'(a) = [a > 0] flips only where a is within that of 0).
// 2 R H 2H + 2 R H H flops (22.6 GFLOP at R = 12,448, H = 550).

#pragma once

#include <cuda_runtime.h>

#include "lstm_remat.cuh"

namespace tpk {

// out[r, H + c] = sigmoid(ff[r, H + c] + (h_prev @ uzr)[r, c]) for c < 2H,
// and for the r half (c >= H) also rh[r, c - H] = that * h_prev[r, c - H];
// h is (R - shift, H), uzr (H, 2H), ff and out (R, 3H), rh (R, H).
__global__ void __launch_bounds__(kRematThreads, 2)
gru_remat_zr_kernel(const float* __restrict__ h, int shift,
                    const float* __restrict__ uzr,
                    const float* __restrict__ ff, float* __restrict__ out,
                    float* __restrict__ rh, int R, int H) {
  __shared__ __align__(16) float a_tile[kRematDepth][kRematALd];
  __shared__ __align__(16) float b_tile[kRematDepth][kRematBLd];
  const int N = 2 * H;
  const int r0 = blockIdx.y * kRematRows;
  const int c0 = blockIdx.x * kRematCols;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][4];
  remat_tile(h, shift, uzr, N, R, H, a_tile, b_tile, acc);

  const size_t three_h = 3 * static_cast<size_t>(H);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= R) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 4 * tx + q;
      if (c >= N) continue;
      const size_t at = static_cast<size_t>(r) * three_h + H + c;
      const float v = remat_sigmoid(ff[at] + acc[i][q]);
      out[at] = v;
      if (c >= H) {
        const float hp = r >= shift
            ? h[static_cast<size_t>(r - shift) * H + c - H] : 0.0f;
        rh[static_cast<size_t>(r) * H + c - H] = v * hp;
      }
    }
  }
}

// out[r, c] = ff[r, c] + (rh @ uh)[r, c] for c < H: the candidate's
// pre-activation a, in the h columns of out (R, 3H); rh and uh are (R, H)
// and (H, H).
__global__ void __launch_bounds__(kRematThreads, 2)
gru_remat_a_kernel(const float* __restrict__ rh, const float* __restrict__ uh,
                   const float* __restrict__ ff, float* __restrict__ out,
                   int R, int H) {
  __shared__ __align__(16) float a_tile[kRematDepth][kRematALd];
  __shared__ __align__(16) float b_tile[kRematDepth][kRematBLd];
  const int r0 = blockIdx.y * kRematRows;
  const int c0 = blockIdx.x * kRematCols;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][4];
  remat_tile(rh, 0, uh, H, R, H, a_tile, b_tile, acc);

  const size_t three_h = 3 * static_cast<size_t>(H);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= R) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 4 * tx + q;
      if (c >= H) continue;
      const size_t at = static_cast<size_t>(r) * three_h + c;
      out[at] = ff[at] + acc[i][q];
    }
  }
}

// Launches the two passes on `stream` and returns the first error
// cudaGetLastError() reports.
inline cudaError_t launch_gru_remat(const float* h, int shift,
                                    const float* uzr, const float* uh,
                                    const float* ff, float* out, float* rh,
                                    int R, int H, cudaStream_t stream) {
  const int row_tiles = (R + kRematRows - 1) / kRematRows;
  gru_remat_zr_kernel<<<dim3((2 * H + kRematCols - 1) / kRematCols, row_tiles),
                        kRematThreads, 0, stream>>>(h, shift, uzr, ff, out, rh,
                                                    R, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gru_remat_a_kernel<<<dim3((H + kRematCols - 1) / kRematCols, row_tiles),
                       kRematThreads, 0, stream>>>(rh, uh, ff, out, R, H);
  return cudaGetLastError();
}

}  // namespace tpk
