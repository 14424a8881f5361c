// The weight-gradient pass shared by the recurrence backward kernels
// (ligru_bwd.cu, lstm_bwd.cu, gru_bwd.cu):
//
//     dU[i, c] = sum over r < R of A[r, i] * D[r, off + c]
//
// for i < H, c < ncols, with R = T * B flattened rows.  A is (R - shift, H)
// row-major, read shifted by `shift` rows (zeros above): shift = B turns the
// forward's output h into h_prev; shift = 0 reads A as it is.  D is (R,
// stride) row-major, of which columns off .. off + ncols - 1 are summed.
//
// The Pallas kernels accumulate dU in an output block that stays resident
// across their sequential grid, but Hopper's blocks run in no order and
// carry nothing between them.  So dU is a second pass: a shared-memory tiled
// reduction in which each block owns a 64 x 64 tile of dU and sums all rows
// in a fixed order.  No float atomics, so a replayed chunk gives the same
// bits.  The sum runs in three levels: each stage of 16 rows into its own
// accumulator, 32 stages (512 rows) into a block accumulator, the blocks
// into the total.  A single float32 chain over the R = 8,000-16,000 rows of
// a training batch drifts ~1e-5 of max|dU| from float64 where the terms
// cancel (seen in an LSTM's recurrent weights), several times the error of
// cuBLAS's blocked sums; with no chain longer than 32 terms it stays at
// theirs.  A plain float32 GEMM of 2 R H ncols flops; a wgmma tile pipeline
// would make it faster, but it is small next to the sequential passes.

#pragma once

#include <cuda_runtime.h>

namespace tpk {

constexpr int kDuTile = 64;       // dU tile edge (rows i and columns c)
constexpr int kDuTileRows = 16;   // rows r of A and D per stage
constexpr int kDuThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kDuBlockStages = 32;  // stages summed before joining the total

__global__ void du_tile_kernel(const float* __restrict__ a, int shift,
                               const float* __restrict__ d, int stride,
                               int off, int ncols, float* __restrict__ du,
                               int R, int H) {
  __shared__ float a_tile[kDuTileRows][kDuTile];  // A[r0 + k - shift, i0 + col]
  __shared__ float b_tile[kDuTileRows][kDuTile];  // D[r0 + k, off + c0 + col]
  const int i0 = blockIdx.y * kDuTile;
  const int c0 = blockIdx.x * kDuTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};  // over blocks of kDuBlockStages stages
  float blk[4][4] = {};  // over the stages of the current block
  int stage = 0;

  for (int r0 = 0; r0 < R; r0 += kDuTileRows) {
    for (int l = threadIdx.x; l < kDuTileRows * kDuTile; l += kDuThreads) {
      const int k = l / kDuTile;
      const int col = l % kDuTile;
      const int r = r0 + k;
      const int i = i0 + col;
      const int c = c0 + col;
      a_tile[k][col] = (r < R && r >= shift && i < H)
                           ? a[static_cast<size_t>(r - shift) * H + i] : 0.0f;
      b_tile[k][col] = (r < R && c < ncols)
                           ? d[static_cast<size_t>(r) * stride + off + c] : 0.0f;
    }
    __syncthreads();
    float part[4][4] = {};  // over the rows of this stage
#pragma unroll
    for (int k = 0; k < kDuTileRows; ++k) {
      float av[4];
      float bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        av[q] = a_tile[k][ty + 16 * q];
        bv[q] = b_tile[k][tx + 16 * q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) part[p][q] = fmaf(av[p], bv[q], part[p][q]);
      }
    }
    const bool flush = ++stage == kDuBlockStages;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        blk[p][q] += part[p][q];
        if (flush) {
          acc[p][q] += blk[p][q];
          blk[p][q] = 0.0f;
        }
      }
    }
    if (flush) stage = 0;
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx + 16 * q;
      if (i < H && c < ncols) {
        du[static_cast<size_t>(i) * ncols + c] = acc[p][q] + blk[p][q];
      }
    }
  }
}

// Launches du_tile_kernel on `stream` and returns cudaGetLastError().
inline cudaError_t launch_du(const float* a, int shift, const float* d,
                             int stride, int off, int ncols, float* du, int R,
                             int H, cudaStream_t stream) {
  const dim3 grid((ncols + kDuTile - 1) / kDuTile, (H + kDuTile - 1) / kDuTile);
  du_tile_kernel<<<grid, kDuThreads, 0, stream>>>(a, shift, d, stride, off,
                                                  ncols, du, R, H);
  return cudaGetLastError();
}

}  // namespace tpk
