// The conv-pool backward passes that K5b (conv_pool_bwd.cu) and K6b
// (conv_ln_bwd.cu) share: from the pooled gradient dy (N, M, O) and the
// forward's argmax idx (N, M, O) int8, dX (N, L) in gather form, where a
// caller asks for it, and dW (K, O) through per-window partials and a
// window sum.  No atomics: a replayed step gives the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace tpk {

// The dW pass takes the taps in groups of kDwGroup, a block a group (grid
// z); a warp of the block owns the taps k = group * kDwGroup + warp +
// kDwWarps * i, i < kDwTaps, in registers.  A group covers kDwGroupTaps
// taps or more, so a filter of up to that many taps is one group, as it
// was before there were groups.
constexpr int kDwWarps = 8;
constexpr int kDwGroupTaps = 129;
constexpr int kDwTaps = (kDwGroupTaps + kDwWarps - 1) / kDwWarps;
constexpr int kDwGroup = kDwWarps * kDwTaps;

inline int dw_groups(int K) { return (K + kDwGroup - 1) / kDwGroup; }

// The dX pass, register-tiled: a thread computes kDxRun consecutive
// samples.  kDxRun is odd, so the 32 lanes of a warp, kDxRun words apart,
// read 32 distinct shared-memory banks.
constexpr int kDxRun = 5;
constexpr int kDxThreads = 128;
constexpr int kDxSpan = kDxRun * kDxThreads;  // samples of dX per block
constexpr int kDxFilt = 8;                    // filters per shared tile

// conv positions a dX block reads: its samples and the Kp - 1 before them
inline __host__ __device__ int dx_width(int Kp) { return kDxSpan + Kp - 1; }

// dX of one window, in gather form (no atomics): block (n, span of kDxSpan
// samples), thread = kDxRun consecutive samples t.  Per tile of kDxFilt
// filters the pooled gradient is scattered through idx onto the conv
// positions the block's samples reach, dct[c][s - sbeg], and the tile's
// weights are staged transposed, wt[c][k]; then
//
//     dx[t] = sum over filters o, then taps k < Kp, of dconv[t - k, o] w[k, o]
//
// one fmaf chain per sample in that order (the taps K .. Kp - 1 carry zero
// weights and add exact zeros).  Per filter and chunk of kTapChunk taps a
// thread loads kTapChunk new dconv values into a sliding register window
// (the rest slide over from the chunk before) and the chunk's weights as
// two 16-byte broadcasts, for kDxRun * kTapChunk fmaf.
__global__ void __launch_bounds__(kDxThreads)
conv_pool_dx_tile_kernel(const float* __restrict__ dy,
                         const int8_t* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ dx,
                         int L, int K, int O, int M, int pool) {
  extern __shared__ float smem[];
  constexpr int kWin = kDxRun + kTapChunk - 1;
  const int Kp = padded_taps(K);
  const int width = dx_width(Kp);
  float* wt = smem;                 // kDxFilt x Kp, 32-byte rows
  float* dct = wt + kDxFilt * Kp;   // kDxFilt x width
  const int n = blockIdx.x;
  const int t0 = blockIdx.y * kDxSpan;
  const int sbeg = t0 - (Kp - 1);  // dct[c][i] is dconv at position sbeg + i
  const int send = t0 + kDxSpan;   // exclusive
  const int pbeg = sbeg > 0 ? sbeg / pool : 0;
  const int pend = min(M, (send - 1) / pool + 1);  // exclusive
  const size_t win = static_cast<size_t>(n) * M * O;
  const int tid = threadIdx.x;
  const int lt = tid * kDxRun;  // the thread's first sample, from t0
  float acc[kDxRun];
#pragma unroll
  for (int j = 0; j < kDxRun; ++j) acc[j] = 0.0f;
  for (int o0 = 0; o0 < O; o0 += kDxFilt) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kDxFilt * width; i += kDxThreads) dct[i] = 0.0f;
    for (int i = tid; i < kDxFilt * Kp; i += kDxThreads) {
      const int k = i % Kp;
      const int o = o0 + i / Kp;
      wt[i] = (k < K && o < O) ? w[static_cast<size_t>(k) * O + o] : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < (pend - pbeg) * kDxFilt; i += kDxThreads) {
      const int p = pbeg + i / kDxFilt;
      const int o = o0 + i % kDxFilt;
      if (o < O) {
        const size_t e = win + static_cast<size_t>(p) * O + o;
        const int s = p * pool + idx[e];
        if (s >= sbeg && s < send) dct[(i % kDxFilt) * width + s - sbeg] = dy[e];
      }
    }
    __syncthreads();
    for (int c = 0; c < kDxFilt; ++c) {
      // xr[i] = dct[c][lt + Kp - kTapChunk - k0 + i] for the chunk k0: the
      // product of sample lt + j and tap k0 + kk reads xr[j + 7 - kk]
      const float* col = dct + c * width + lt + Kp - kTapChunk;
      const float4* wc = reinterpret_cast<const float4*>(wt + c * Kp);
      float xr[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) xr[i] = col[i];
      for (int k0 = 0; k0 < Kp; k0 += kTapChunk) {
        const float4 wa = wc[k0 / 4];
        const float4 wb = wc[k0 / 4 + 1];
        const float wr[kTapChunk] = {wa.x, wa.y, wa.z, wa.w,
                                     wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int kk = 0; kk < kTapChunk; ++kk) {
#pragma unroll
          for (int j = 0; j < kDxRun; ++j) {
            acc[j] = fmaf(xr[j + kTapChunk - 1 - kk], wr[kk], acc[j]);
          }
        }
        if (k0 + kTapChunk < Kp) {
          // the next chunk's window starts kTapChunk positions earlier
#pragma unroll
          for (int i = kWin - 1; i >= kTapChunk; --i) xr[i] = xr[i - kTapChunk];
#pragma unroll
          for (int i = 0; i < kTapChunk; ++i) xr[i] = col[i - k0 - kTapChunk];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDxRun; ++j) {
    const int t = t0 + lt + j;
    if (t < L) dx[static_cast<size_t>(n) * L + t] = acc[j];
  }
}

inline size_t dx_smem_bytes(int K) {
  const int Kp = padded_taps(K);
  return static_cast<size_t>(kDxFilt) * (Kp + dx_width(Kp)) * sizeof(float);
}

// a dW block's window: its group's taps, up to kDwGroup - 1 past a row's
// argmax, from the row's first conv position
inline __host__ __device__ int dw_span(int M, int pool) {
  return M * pool + kDwGroup;
}

inline size_t dw_smem_bytes(int M, int pool) {
  return (static_cast<size_t>(dw_span(M, pool)) + 2 * 32 * kFilt) *
         sizeof(float);
}

// One window's share of dW: block (n, filter tile, tap group); lane c =
// filter, warp = taps k = k0 + warp + kDwWarps * i, k0 = group *
// kDwGroup, the window staged from sample k0.  Over the pooled rows p,
// dw[k, o] +=
// x[n, p * pool + idx + k] * dy[n, p, o] (the only nonzero conv gradient of
// the row).  No float chain is longer than 32 terms: 16 rows into a stage,
// 32 stages into a block, the blocks into the total (as du_tile.cuh);
// reduce_windows_kernel then sums the windows.
__global__ void __launch_bounds__(kDwWarps * 32)
conv_pool_dw_part_kernel(const float* __restrict__ x,
                         const float* __restrict__ dy,
                         const int8_t* __restrict__ idx,
                         float* __restrict__ dw_part, int L, int K, int O,
                         int M, int pool) {
  extern __shared__ float smem[];
  const int span = dw_span(M, pool);
  float* xs = smem;                    // span
  float* dys = xs + span;              // 32 rows x kFilt
  int* ids = reinterpret_cast<int*>(dys + 32 * kFilt);
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * kFilt;
  const int k0 = blockIdx.z * kDwGroup;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t win = static_cast<size_t>(n) * M * O;
  load_window(x + static_cast<size_t>(n) * L, L, k0, span, xs);
  float part[kDwTaps] = {};
  float blk[kDwTaps] = {};
  float tot[kDwTaps] = {};
  int rows = 0;
  int stages = 0;
  for (int p0 = 0; p0 < M; p0 += 32) {
    __syncthreads();  // xs is loaded; the previous rows are consumed
    for (int i = threadIdx.x; i < 32 * kFilt; i += blockDim.x) {
      const int p = p0 + i / kFilt;
      const int o = o0 + i % kFilt;
      const bool in = p < M && o < O;
      const size_t e = win + static_cast<size_t>(p) * O + o;
      dys[i] = in ? dy[e] : 0.0f;
      ids[i] = in ? static_cast<int>(idx[e]) : 0;
    }
    __syncthreads();
    const int np = min(32, M - p0);
    for (int pp = 0; pp < np; ++pp) {
      const float d = dys[pp * kFilt + lane];
      const int s = (p0 + pp) * pool + ids[pp * kFilt + lane] + warp;
#pragma unroll
      for (int i = 0; i < kDwTaps; ++i) {
        part[i] = fmaf(xs[s + kDwWarps * i], d, part[i]);
      }
      if (++rows == 16) {
        rows = 0;
        const bool flush = ++stages == 32;
#pragma unroll
        for (int i = 0; i < kDwTaps; ++i) {
          blk[i] += part[i];
          part[i] = 0.0f;
          if (flush) {
            tot[i] += blk[i];
            blk[i] = 0.0f;
          }
        }
        if (flush) stages = 0;
      }
    }
  }
  const int o = o0 + lane;
  if (o < O) {
#pragma unroll
    for (int i = 0; i < kDwTaps; ++i) {
      const int k = k0 + warp + kDwWarps * i;
      if (k < K) {
        dw_part[(static_cast<size_t>(n) * K + k) * O + o] =
            tot[i] + (blk[i] + part[i]);
      }
    }
  }
}

// out[e] = sum over windows n of part[n * E + e]: 32 windows into a block,
// the blocks into the total, in window order
__global__ void reduce_windows_kernel(const float* __restrict__ part, int N,
                                      size_t E, float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float tot = 0.0f;
  float blk = 0.0f;
  for (int n = 0; n < N; ++n) {
    blk += part[static_cast<size_t>(n) * E + e];
    if ((n + 1) % 32 == 0) {
      tot += blk;
      blk = 0.0f;
    }
  }
  out[e] = tot + blk;
}

inline cudaError_t launch_reduce(const float* part, int N, size_t E,
                                 float* out, cudaStream_t stream) {
  const int threads = 256;
  const size_t blocks = (E + threads - 1) / threads;
  reduce_windows_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      part, N, E, out);
  return cudaGetLastError();
}

// The conv-pool backward from the pooled gradient dy and idx: dx (N, L),
// skipped where dx is null (a caller whose input needs no gradient), and
// dw (K, O) through the per-window partials dw_part (N, K, O)
inline cudaError_t launch_conv_pool_bwd(const float* x, const float* dy,
                                        const int8_t* idx, const float* w,
                                        float* dw_part, float* dx, float* dw,
                                        int N, int L, int K, int O, int pool,
                                        cudaStream_t stream) {
  const int M = (L - K + 1) / pool;
  const int tiles = (O + kFilt - 1) / kFilt;
  const size_t dx_smem = dx_smem_bytes(K);
  const size_t dw_smem = dw_smem_bytes(M, pool);
  if (dx_smem > kMaxSmem || dw_smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dx != nullptr) {
    err = cudaFuncSetAttribute(conv_pool_dx_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dx_smem));
    if (err != cudaSuccess) return err;
    const dim3 dx_grid(N, (L + kDxSpan - 1) / kDxSpan);
    conv_pool_dx_tile_kernel<<<dx_grid, kDxThreads, dx_smem, stream>>>(
        dy, idx, w, dx, L, K, O, M, pool);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(conv_pool_dw_part_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dw_smem));
  if (err != cudaSuccess) return err;
  const dim3 dw_grid(N, tiles, dw_groups(K));
  conv_pool_dw_part_kernel<<<dw_grid, kDwWarps * 32, dw_smem, stream>>>(
      x, dy, idx, dw_part, L, K, O, M, pool);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(dw_part, N, static_cast<size_t>(K) * O, dw, stream);
}

}  // namespace tpk
