// The LSTM backward's gate rematerialisation as one parallel pass over all
// T * B rows (lstm_bwd.cu's first launch):
//
//     a     = ff + h_prev @ U                 (R, 4H), R = T * B rows
//     gates = [sigmoid(a_f) | sigmoid(a_i) | sigmoid(a_o) | tanh(a_c)]
//
// with h_prev the forward's h read B rows back (zeros for the first B
// rows, t = 0).  The gates go into `out`, which the sequential pass then
// overwrites in place with dA.
//
// tpukaldi's Pallas backward forms a block-wide product of 4 steps before
// its chain (tpukaldi/kernels/lstm.py, phase 1); nothing in it depends on
// the chain, so here it runs over the whole sequence at once, off the
// chain.  A float32 tiled GEMM on the CUDA cores (TF32 stays off): each
// block owns a 128 x 64 tile of the output and walks the depth H in stages
// of 16, staged through shared memory with the next stage's words loaded
// into registers while the current one is multiplied.  A thread owns 8 rows
// (two runs of 4, 64 apart) x 4 columns: per depth step 3 float4 loads
// from shared memory to 32 fmaf.  Held to 128 registers, two blocks run on
// an SM: 3-4% faster than one block of 153 registers (lstm_bwd_phases.py).
// Each output is one fmaf chain over k in ascending order, so two calls
// give the same bits; the sum order differs from K2f's (per depth slice,
// then across slices), so the gates agree with the forward's to the sum
// order.  2 R H 4H flops (30.1 GFLOP at R = 12,448, H = 550): about 0.45
// ms at the card's float32 peak.

#pragma once

#include <cuda_runtime.h>

namespace tpk {

constexpr int kRematRows = 128;    // output rows r of a block's tile
constexpr int kRematCols = 64;     // output columns of a block's tile
constexpr int kRematDepth = 16;    // depth k of a stage
constexpr int kRematThreads = 256;  // 16 x 16 threads, 8 x 4 outputs each
// shared row lengths: padded by 4 floats against bank conflicts on the
// transposed stores, still a multiple of 16 bytes for the float4 loads
constexpr int kRematALd = kRematRows + 4;
constexpr int kRematBLd = kRematCols;

__device__ __forceinline__ float remat_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[i][q] = sum over k < K, in ascending order, of a[r - shift, k] *
// b[k, c] for the block's tile: rows r = r0 + 4 ty + i (i < 4) and r0 + 64
// + 4 ty + i - 4 (i >= 4), columns c = c0 + 4 tx + q, with r0 and c0 the
// block's tile corner; a is (R - shift, K) (zeros above), b (K, N).  The
// tiling of lstm_remat_kernel, shared with the GRU's remat (gru_remat.cuh).
__device__ __forceinline__ void remat_tile(
    const float* __restrict__ a, int shift, const float* __restrict__ b,
    int N, int R, int K, float (&a_tile)[kRematDepth][kRematALd],
    float (&b_tile)[kRematDepth][kRematBLd], float (&acc)[8][4]) {
  const int r0 = blockIdx.y * kRematRows;
  const int c0 = blockIdx.x * kRematCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4 tx .. 4 tx + 3
  const int ty = tid / 16;  // rows 4 ty .. + 3 and 64 + 4 ty .. + 3

  // the words a thread stages: of A, 8 (row l / 16, depth l % 16, so that
  // 16 neighbouring threads read 16 neighbouring floats of one row of a);
  // of B, 4 (depth l / 64, column l % 64)
  constexpr int kAPer = kRematRows * kRematDepth / kRematThreads;
  constexpr int kBPer = kRematCols * kRematDepth / kRematThreads;
  float a_reg[kAPer];
  float b_reg[kBPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kAPer; ++e) {
      const int l = tid + e * kRematThreads;
      const int r = r0 + l / kRematDepth;
      const int k = k0 + l % kRematDepth;
      a_reg[e] = (r >= shift && r < R && k < K)
                     ? a[static_cast<size_t>(r - shift) * K + k] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kBPer; ++e) {
      const int l = tid + e * kRematThreads;
      const int k = k0 + l / kRematCols;
      const int c = c0 + l % kRematCols;
      b_reg[e] = (k < K && c < N) ? b[static_cast<size_t>(k) * N + c] : 0.0f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int e = 0; e < kAPer; ++e) {
      const int l = tid + e * kRematThreads;
      a_tile[l % kRematDepth][l / kRematDepth] = a_reg[e];
    }
#pragma unroll
    for (int e = 0; e < kBPer; ++e) {
      const int l = tid + e * kRematThreads;
      b_tile[l / kRematCols][l % kRematCols] = b_reg[e];
    }
  };

#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  }
  load(0);
  for (int k0 = 0; k0 < K; k0 += kRematDepth) {
    store();
    __syncthreads();
    if (k0 + kRematDepth < K) load(k0 + kRematDepth);  // in flight meanwhile
#pragma unroll
    for (int k = 0; k < kRematDepth; ++k) {
      const float4 lo = *reinterpret_cast<const float4*>(&a_tile[k][4 * ty]);
      const float4 hi = *reinterpret_cast<const float4*>(&a_tile[k][64 + 4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_tile[k][4 * tx]);
      const float av[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
      }
    }
    __syncthreads();  // the tiles are staged again next stage
  }
}

// out[r, c] = gate_c(ff[r, c] + sum_k h[r - shift, k] * u[k, c]) for
// r < R, c < 4H; h is (R - shift, H), u (H, 4H), ff and out (R, 4H).
__global__ void __launch_bounds__(kRematThreads, 2)
lstm_remat_kernel(const float* __restrict__ h, int shift,
                  const float* __restrict__ u, const float* __restrict__ ff,
                  float* __restrict__ out, int R, int H) {
  __shared__ __align__(16) float a_tile[kRematDepth][kRematALd];  // [k][row]
  __shared__ __align__(16) float b_tile[kRematDepth][kRematBLd];  // [k][col]
  const int N = 4 * H;
  const int r0 = blockIdx.y * kRematRows;
  const int c0 = blockIdx.x * kRematCols;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][4];
  remat_tile(h, shift, u, N, R, H, a_tile, b_tile, acc);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= R) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 4 * tx + q;
      if (c >= N) continue;
      const size_t at = static_cast<size_t>(r) * N + c;
      const float a = ff[at] + acc[i][q];
      out[at] = c < 3 * H ? remat_sigmoid(a) : tanhf(a);
    }
  }
}

// Launches lstm_remat_kernel on `stream` and returns cudaGetLastError().
inline cudaError_t launch_remat(const float* h, int shift, const float* u,
                                const float* ff, float* out, int R, int H,
                                cudaStream_t stream) {
  const dim3 grid((4 * H + kRematCols - 1) / kRematCols,
                  (R + kRematRows - 1) / kRematRows);
  lstm_remat_kernel<<<grid, kRematThreads, 0, stream>>>(h, shift, u, ff, out,
                                                        R, H);
  return cudaGetLastError();
}

}  // namespace tpk
