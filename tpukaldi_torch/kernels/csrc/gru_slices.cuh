// The GRU's recurrent weights as the persistent GRU kernels keep them: each
// CTA of K3f's launch (gru_fwd.cu) and of K3b's chain (gru_bwd.cu) owns u
// consecutive hidden units S_q and keeps the column slices Uh[:, S_q] and
// [Uz | Ur][:, S_q] in shared memory for all T steps, packed once per call
// straight from Uh (H, H) and Uzr = [Uz | Ur] (H, 2H), with no transpose:
//
//     row k:  Uh[k, j] for j in S_q            gru_uh_words(u) 16-byte words
//             Uz[k, j], Ur[k, j] side by side  gru_uzr_words(u) words
//             zeros up to an odd number of words (gru_row_floats(u) floats)
//
// so that 8 rows read at one column fall in 8 distinct groups of 4 banks.
// The forward multiplies h by a row's words (depth H); the backward
// multiplies its cells' gradients by them (depth u).  44 KB at H = 550,
// u = 5; 115 KB at H = 1024, u = 8.

#pragma once

#include <cuda_runtime.h>

#include "persist_grid.cuh"

namespace tpk {

// 16-byte words of a row's Uh part and of its [Uz, Ur] part
__host__ __device__ constexpr int gru_uh_words(int u) { return (u + 3) / 4; }
__host__ __device__ constexpr int gru_uzr_words(int u) { return (2 * u + 3) / 4; }
// a row's floats: both parts, padded to an odd number of words
__host__ __device__ constexpr int gru_row_floats(int u) {
  return 4 * ((gru_uh_words(u) + gru_uzr_words(u)) | 1);
}

// The block's slices of the up units from unit0 (the last CTA may own fewer
// than u) into us: the first `zero_rows` rows of gru_row_floats(u) floats
// zeroed, then the first n_rows real rows (-1: all H) copied with 4-byte
// cp.async.  Every thread of the block calls it; it returns with the
// copies landed and visible to the block.
__device__ inline void load_gru_slices(float* us, int zero_rows,
                                       const float* uh, const float* uzr,
                                       int H, int u, int unit0, int up,
                                       int n_rows = -1) {
  const int ld = gru_row_floats(u);
  const int zr0 = 4 * gru_uh_words(u);  // a row's first [Uz, Ur] float
  for (int i = threadIdx.x; i < zero_rows * ld; i += blockDim.x) us[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < (n_rows < 0 ? H : n_rows) * up;
       i += blockDim.x) {
    const int k = i / up;
    const int jj = i - k * up;
    const size_t j = static_cast<size_t>(unit0) + jj;
    float* row = us + static_cast<size_t>(k) * ld;
    const float* uzr_k = uzr + static_cast<size_t>(k) * 2 * H;
    cp_async4(row + jj, uh + static_cast<size_t>(k) * H + j);
    cp_async4(row + zr0 + 2 * jj, uzr_k + j);
    cp_async4(row + zr0 + 2 * jj + 1, uzr_k + H + j);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Stage rows [r0, r1) of one part of the block's slices, in the layout
// above, into `rows` (row r at rows + (r - r0) * gru_row_floats(u)) with
// 4-byte cp.async, for K3f's streamed chunks (u_stream.cuh): the Uh part
// (uzr_part false) or the [Uz, Ur] part, the up units' floats of each;
// rows from H on, the zero rows that pad the depth, as zeros.  Every
// thread of the block calls it; the caller commits the group.
__device__ inline void stage_gru_rows(float* rows, const float* uh,
                                      const float* uzr, bool uzr_part, int H,
                                      int u, int unit0, int up, int r0,
                                      int r1) {
  const int ld = gru_row_floats(u);
  const int per_row = uzr_part ? 2 * up : up;
  const int n = (r1 - r0) * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int dr = i / per_row;
    const int v = i - dr * per_row;
    const int k = r0 + dr;
    float* row = rows + static_cast<size_t>(dr) * ld;
    // [Uz, Ur] pairs: v = 2 jj + (0: Uz, 1: Ur)
    float* to = uzr_part ? row + 4 * gru_uh_words(u) + v : row + v;
    if (k >= H) {
      *to = 0.0f;
    } else if (uzr_part) {
      cp_async4(to, uzr + static_cast<size_t>(k) * 2 * H + (v & 1) * H +
                        unit0 + v / 2);
    } else {
      cp_async4(to, uh + static_cast<size_t>(k) * H + unit0 + v);
    }
  }
}

}  // namespace tpk
