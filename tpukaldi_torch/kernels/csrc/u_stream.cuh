// The streamed share of U in the persistent forward recurrences (K1f
// ligru_fwd.cu, K2f lstm_fwd.cu, K3f gru_fwd.cu, K4f lstm_lean_fwd.cu).
//
// Each CTA of those launches owns u hidden units and multiplies h_{t-1} by
// its slice of U, one row of the slice per row k of h's depth.  Up to
// H = 1024 the whole slice stays in shared memory for all T steps.  Past
// that it does not fit (at H = 2048, u = 16: 288 KB for K1f, 544 KB for
// K2f, against the 227 KB a block may opt in to), and the whole U is
// larger than all the card's shared memory (132 x 227 KB, about 30 MB,
// against 33.6 MB for the liGRU's U), so no grid keeps it on chip.  The
// plan then splits each CTA's slice by rows:
//
// - rows k < k_res stay resident, copied once per call as before;
// - rows k_res <= k < kp are streamed: the step's loop over h's columns
//   runs in chunks of kc columns, double-buffered with cp.async; a chunk
//   past k_res stages the chunk's kc rows of U into a buffer of two chunks
//   beside h's chunk, in the same cp.async group, and its product reads
//   them there instead of from the resident rows.
//
// k_res is a whole number of chunks, so a chunk is either resident or
// streamed, and the product's loop is the resident design's: each thread
// sums its k-steps in ascending order, so a call gives the same bits
// every time.  Where the whole slice fits, k_res = kp: no chunk is
// streamed and the kernel runs the resident design's loads and loop, bit
// for bit (one kernel serves both: a chunk streams where k0 >= k_res, a
// test the whole block takes the same way; on an H100 at 700 W it gives
// a resident-only kernel's bits and 0.98-1.03x its time at H <= 1024,
// tpukaldi_torch/tools/recurrence_envelope.py).
//
// U never changes within a launch, so the streamed rows come through L2
// (18.9 MB a step over the grid for K1f at B' = 16, H = 2048: within the
// 50 MB L2 only if nothing else evicts them).

#pragma once

#include <cuda_runtime.h>

#include "persist_grid.cuh"

namespace tpk {

// h columns (and U rows) of a streamed chunk, before the plan halves it to
// fit: 128 keeps a chunk's stream of U (18-35 KB a CTA at H = 2048) near
// one round trip to device memory while leaving most of the shared memory
// to the resident rows
constexpr int kStreamChunk = 128;

// The streamed design's plan, where a CTA's slice of U does not fit: the
// chunk kc (kStreamChunk, halved as far as 16 rows while the rest of the
// shared memory does not fit) and k_res, the rows that stay resident: the
// most whole chunks of rows of `row_bytes` that fit in `optin` bytes
// beside the rest, fewer than H (a resident row is a real row, so the
// streamed chunks hold the zero rows past H).  smem(rows, kc) is the
// kernel's shared bytes with `rows` rows resident and kc-row chunks;
// returns false where nothing fits.
template <typename Smem>
inline bool stream_plan(Smem smem, size_t optin, size_t row_bytes, int H,
                        int* kc, int* k_res) {
  *kc = kStreamChunk;
  while (smem(0, *kc) > optin && *kc > 16) *kc /= 2;
  const size_t rest = smem(0, *kc);
  if (rest > optin) return false;
  const int fit = static_cast<int>((optin - rest) / row_bytes) / *kc * *kc;
  const int below = (H - 1) / *kc * *kc;
  *k_res = fit < below ? fit : below;
  return true;
}

template <int kBytes>
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    cp_async16_cg(dst, src);
  } else if constexpr (kBytes == 8) {
    cp_async8(dst, src);
  } else {
    cp_async4(dst, src);
  }
}

template <int kBytes>
__device__ __forceinline__ void zero_piece(void* dst) {
  if constexpr (kBytes == 16) {
    *static_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if constexpr (kBytes == 8) {
    *static_cast<uint2*>(dst) = make_uint2(0u, 0u);
  } else {
    *static_cast<unsigned*>(dst) = 0u;
  }
}

// Stage rows [r0, r1) of a CTA's slice of U into `dst` (row r at
// dst + (r - r0) * dst_ld bytes): `pieces` copies of kBytes a row, piece v
// of row r from src + r * src_ld + v * kBytes bytes, issued with cp.async
// by every thread of the block (the caller commits the group).  Rows from
// H on are the zero rows that pad the depth: their pieces are stored as
// zeros, since a stale or unwritten word times h's zero padding could be a
// NaN.
template <int kBytes>
__device__ __forceinline__ void stage_rows(void* dst, int dst_ld,
                                           const void* src, size_t src_ld,
                                           int pieces, int r0, int r1, int H) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const int n = (r1 - r0) * pieces;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int dr = i / pieces;
    const int v = i - dr * pieces;
    void* to = d + static_cast<size_t>(dr) * dst_ld + v * kBytes;
    if (r0 + dr < H) {
      cp_async_piece<kBytes>(to, s + (r0 + dr) * src_ld + v * kBytes);
    } else {
      zero_piece<kBytes>(to);
    }
  }
}

}  // namespace tpk
