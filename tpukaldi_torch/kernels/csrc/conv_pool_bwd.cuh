// The conv-pool backward passes that K5b (conv_pool_bwd.cu) and K6b
// (conv_ln_bwd.cu) share: from the pooled gradient dy (N, M, O) and the
// forward's argmax idx (N, M, O) int8, dX (N, L) in gather form and dW (K,
// O) through per-window partials and a window sum.  No atomics: a replayed
// step gives the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace tpk {

// taps a warp of the dW pass owns: k = warp + kDwWarps * i, i < kDwTaps
constexpr int kDwWarps = 8;
constexpr int kDwTaps = (kMaxTaps + kTapChunk - 1) / kTapChunk * kTapChunk / kDwWarps;
constexpr int kDxSamples = 256;  // samples of dX per block, one per thread

// dX of one window, in gather form (no atomics): block (n, sample block),
// thread = sample t.  Per filter tile the pooled gradient is scattered
// through idx onto the conv positions the block's samples reach,
// dct[c][s - sbeg], then dx[t] = sum over filters c and taps k of
// dct[c][t - k] * w[k, c], in that order.
__global__ void __launch_bounds__(kDxSamples)
conv_pool_dx_kernel(const float* __restrict__ dy, const int8_t* __restrict__ idx,
                    const float* __restrict__ w, float* __restrict__ dx, int L,
                    int K, int O, int M, int pool) {
  extern __shared__ float smem[];
  const int Kp = padded_taps(K);
  const int width = kDxSamples + K - 1;  // conv positions t0 - K + 1 .. t0 + 255
  float* dct = smem;                      // kFilt * width
  float* ws = dct + kFilt * width;        // Kp * kFilt
  const int n = blockIdx.x;
  const int t0 = blockIdx.y * kDxSamples;
  const int sbeg = t0 - (K - 1);
  const int send = t0 + kDxSamples;  // exclusive
  const int pbeg = sbeg > 0 ? sbeg / pool : 0;
  const int pend = min(M, (send - 1) / pool + 1);  // exclusive
  const size_t win = static_cast<size_t>(n) * M * O;
  const int tid = threadIdx.x;
  float acc = 0.0f;
  for (int o0 = 0; o0 < O; o0 += kFilt) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kFilt * width; i += blockDim.x) dct[i] = 0.0f;
    load_filters(w, K, O, o0, Kp, ws);
    __syncthreads();
    for (int i = tid; i < (pend - pbeg) * kFilt; i += blockDim.x) {
      const int p = pbeg + i / kFilt;
      const int c = i % kFilt;
      const int o = o0 + c;
      if (o < O) {
        const size_t e = win + static_cast<size_t>(p) * O + o;
        const int s = p * pool + idx[e];
        if (s >= sbeg && s < send) dct[c * width + s - sbeg] = dy[e];
      }
    }
    __syncthreads();
    const float* col = dct + tid + K - 1;  // col[-k] = dconv at t0 + tid - k
    for (int c = 0; c < kFilt; ++c) {
      for (int k = 0; k < K; ++k) {
        acc = fmaf(col[c * width - k], ws[k * kFilt + c], acc);
      }
    }
  }
  const int t = t0 + tid;
  if (t < L) dx[static_cast<size_t>(n) * L + t] = acc;
}

inline size_t dx_smem_bytes(int K) {
  return (static_cast<size_t>(kFilt) * (kDxSamples + K - 1) +
          static_cast<size_t>(padded_taps(K)) * kFilt) * sizeof(float);
}

// the dW pass reads taps up to kDwWarps * kDwTaps - 1 past a row's argmax
inline __host__ __device__ int dw_span(int M, int pool) {
  return M * pool + kDwWarps * kDwTaps + kRun;
}

inline size_t dw_smem_bytes(int M, int pool) {
  return (static_cast<size_t>(dw_span(M, pool)) + 2 * 32 * kFilt) *
         sizeof(float);
}

// One window's share of dW: block (n, filter tile); lane c = filter, warp
// = taps k = warp + kDwWarps * i.  Over the pooled rows p, dw[k, o] +=
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
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t win = static_cast<size_t>(n) * M * O;
  load_window(x + static_cast<size_t>(n) * L, L, 0, span, xs);
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
      const int k = warp + kDwWarps * i;
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
  cudaError_t err = cudaFuncSetAttribute(
      conv_pool_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dx_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_pool_dw_part_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dw_smem));
  if (err != cudaSuccess) return err;
  const dim3 dx_grid(N, (L + kDxSamples - 1) / kDxSamples);
  conv_pool_dx_kernel<<<dx_grid, kDxSamples, dx_smem, stream>>>(
      dy, idx, w, dx, L, K, O, M, pool);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv_pool_dw_part_kernel<<<dim3(N, tiles), kDwWarps * 32, dw_smem, stream>>>(
      x, dy, idx, dw_part, L, K, O, M, pool);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(dw_part, N, static_cast<size_t>(K) * O, dw, stream);
}

}  // namespace tpk
