// Backward of an upper layer of the raw-waveform conv stack (K7f), for
// Hopper (sm_90a): K7b.
//
// Replaces tpukaldi/kernels/conv_stack.py::_stack_bwd_kernel (launched from
// _stack_bwd), which recomputes the whole stack per 8 windows in VMEM and
// sweeps back through it.  Here the wrapper calls this entry once per upper
// layer, from the top down, and then K6b (conv_ln_bwd.cu) for layer 0 from
// the cotangent of layer 1's input.  From the output gradient dz (N, M, O),
// the forward's idx, stats (mu, s) and pooled value y (N, M, O), the
// layer's input h (N, lin, C) that the forward kept, and W, gt, bt, per
// window n and filter o:
//
//     c    = y - mu,  r = 1 / (s + eps),  xhat = c * r
//     dz   = keep ? dz * scale : 0  (drop_on);  dz = 0 where z <= 0 (relu)
//     dgt  = sum_n dz * xhat,  dbt = sum_n dz            (M, O)
//     dzg  = dz * gt,  A = sum_m dzg,  B = sum_m dzg * c
//     dy   = r dzg - c (B r r) / (max(M-1, 1) max(s, 1e-30)) - (r / M) A
//     dW[o, c, k] = sum_{n, m} h[n, m pool + idx + k, c] * dy[n, m, o]
//     dh[n, t, c] = sum_{o, k} dconv[n, t - k, o] * W[o, c, k]
//
// with dconv (N, M pool, O) the pooled gradient scattered onto the conv rows
// through idx.  The mask is the forward's (window id wid0 + n, element m *
// 128 + o).  dbias is the exact zero (the layer norm's mean cancels the
// bias), which the wrapper writes.
//
// Design: no atomics, so a replayed step gives the same bits.  (1) The
// weights flipped into the GEMM's layout for dX (stack_tile.cuh).  (2)
// Layer norm: one block per (window n, tile of 32 filters), 16 warps, an
// elementwise pass on the forward's y (the kernel before it recomputed y at
// the argmax, a dependent chain of C K fmaf an element); A and B summed per
// lane then over the warps in order, as before, so dy keeps its bits; dy,
// dconv and the per-window terms of dgt and dbt written.  (3) dW per
// window as a GEMM over dconv's rows (the dense phase split, dW += X_j^T
// D_j over the pool phases j): block (window, 64 filters, 64 channels), a
// thread 4 filters x 4 channels x K taps, a ring of K h rows in registers.
// A sparse gather over the pooled rows (a lane a filter, a 16-byte shared
// load of h for 4 fmaf) does a third of the flops but ran slower on the
// card (PERF.md).  (4) dX as the forward's register-tiled GEMM
// over dconv with the taps flipped.  (5) The windows' terms of dW, dgt and
// dbt summed 32 at a time, in order, in one pass
// (conv_pool_bwd.cuh::launch_reduce).
//
// What bounds it: dW and dX each 2 N M C K O flops over the pooled rows
// (6.7 GFLOP for CNN_raw's layer 1 at the training batch, 0.10 ms at 67
// TFLOP/s).  Both run dense, `pool` times those flops on dconv's zeros:
// the sparse forms need a shared load for every 4 fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "conv_pool_bwd.cuh"
#include "stack_tile.cuh"

namespace {

__global__ void __launch_bounds__(tpk::kLnWarps * 32)
stack_ln_bwd_kernel(const float* __restrict__ y, const float* __restrict__ gt,
                    const float* __restrict__ bt,
                    const int* __restrict__ seed_p,
                    const int8_t* __restrict__ idx,
                    const float* __restrict__ stats,
                    const float* __restrict__ dz, float* __restrict__ dy,
                    float* __restrict__ dgp, float* __restrict__ dbp,
                    size_t ld, float* __restrict__ dconv, int O, int M,
                    int pool,
                    uint32_t wid0, float eps, int relu, uint32_t threshold,
                    float scale, int drop_on) {
  extern __shared__ float smem[];
  float* cs = smem;                  // M x kFilt: c = y - mu
  float* red = cs + M * tpk::kFilt;  // 2 x kLnWarps x kFilt
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * tpk::kFilt;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int o = o0 + lane;
  const bool active = o < O;
  const size_t win = static_cast<size_t>(n) * M * O;

  float mu = 0.0f, s = 1.0f;
  if (active) {
    mu = stats[static_cast<size_t>(n) * 2 * O + o];
    s = stats[static_cast<size_t>(n) * 2 * O + O + o];
  }
  const float r = 1.0f / (s + eps);
  const uint32_t seed = drop_on ? static_cast<uint32_t>(*seed_p) : 0u;
  float a_part = 0.0f, b_part = 0.0f;
  if (active) {
    for (int m = warp; m < M; m += tpk::kLnWarps) {
      const size_t e = static_cast<size_t>(m) * O + o;
      const float c = y[win + e] - mu;
      const float xhat = c * r;
      float d = dz[win + e];
      if (drop_on) {
        d = tpk::drop_keep(static_cast<uint32_t>(m) * tpk::kMaskLanes + o, seed,
                           wid0 + static_cast<uint32_t>(n), threshold)
                ? d * scale : 0.0f;
      }
      const float g = gt[e];
      if (relu && !(tpk::ln_affine(c, r, g, bt[e]) > 0.0f)) d = 0.0f;
      dgp[n * ld + e] = d * xhat;
      dbp[n * ld + e] = d;
      const float dzg = d * g;
      a_part += dzg;
      b_part += dzg * c;
      cs[m * tpk::kFilt + lane] = c;
      dy[win + e] = dzg;
    }
  }
  const float A = tpk::warp_sum(a_part, red);
  const float B = tpk::warp_sum(b_part, red + tpk::kLnWarps * tpk::kFilt);
  if (!active) return;
  const float fac = (B * r * r) /
                    (static_cast<float>(max(M - 1, 1)) * fmaxf(s, 1e-30f));
  const float rm = r / static_cast<float>(M);
  for (int m = warp; m < M; m += tpk::kLnWarps) {
    const size_t e = win + static_cast<size_t>(m) * O + o;
    const float v = r * dy[e] - cs[m * tpk::kFilt + lane] * fac - rm * A;
    dy[e] = v;
    const int j = idx[e];
    float* dc = dconv + (static_cast<size_t>(n) * M + m) * pool * O + o;
    for (int q = 0; q < pool; ++q) {
      dc[static_cast<size_t>(q) * O] = q == j ? v : 0.0f;
    }
  }
}

// A window's share of dW, a GEMM over dconv's rows (the dense phase split):
// dW[o, c, k] = sum over t < ct of dconv[t, o] h[t + k, c] (dW += X_j^T
// D_j over the pool phases j, D_j dconv's rows of phase j).  Block (n,
// 64 filters from o0, 64 channels from c0), 256 threads: filters 4 fq ..
// 4 fq + 3 (fq = threadIdx.x % 16, the lanes of a quad reading one
// float4) by channels 4 cq .. 4 cq + 3 by the K taps, 16 K sums a thread,
// each one chain over t in order (the pooled rows' chain with exact zeros
// between its terms).  A tile of dense_rows(K) conv rows of
// dconv and its dense_rows(K) + K - 1 rows of h staged by cp.async,
// double-buffered; a thread keeps its channels of K consecutive h rows in
// a ring of registers, so per conv row it loads one float4 of dconv and
// one of h for 16 K fmaf.  `pool` times the flops over the pooled rows,
// on dconv's zeros.
constexpr int kDwRows = 64;  // conv rows a tile, at most
constexpr int kDwCols = 64;

// conv rows of a tile: whole turns of the ring
__host__ __device__ inline int dense_rows(int K) {
  return kDwRows / K * K;
}
__host__ __device__ inline int dense_rows_words(int K) {
  return (2 * dense_rows(K) + K - 1) * kDwCols;
}

size_t dw_smem_bytes(int K) {
  return 2 * static_cast<size_t>(dense_rows_words(K)) * sizeof(float);
}

// dst[r][j] = src[(row0 + r) * ld + col0 + j] for r < rows, j < 64: zero
// for rows outside [0, len) and, where `zero_cols`, columns past cols
__device__ inline void stage_block(const float* __restrict__ src, int ld,
                                   int len, int row0, int rows, int col0,
                                   int cols, bool zero_cols, float* dst) {
  const bool wide = ld % 4 == 0 && cols % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int i = threadIdx.x; i < rows * (kDwCols / 4); i += blockDim.x) {
    const int r = i / (kDwCols / 4);
    const int j = i % (kDwCols / 4) * 4;
    const int t = row0 + r;
    float* d = dst + r * kDwCols + j;
    const float* from = src + static_cast<size_t>(t) * ld + col0 + j;
    if (t < 0 || t >= len) {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else if (wide && col0 + j + 3 < cols) {
      tpk::cp_async16_cg(d, from);
    } else {
      for (int q = 0; q < 4; ++q) {
        if (col0 + j + q < cols) {
          tpk::cp_async4(d + q, from + q);
        } else if (zero_cols) {
          d[q] = 0.0f;
        }
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(256)
stack_dw_kernel(const float* __restrict__ h,
                      const float* __restrict__ dconv,
                      float* __restrict__ dw_part, size_t ld, int lin, int C,
                      int O, int ct) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * kDwCols;
  const int c0 = blockIdx.z * kDwCols;
  const int fq = threadIdx.x % 16;
  const int cq = threadIdx.x / 16;
  const int words = dense_rows_words(K);
  const float* dn = dconv + static_cast<size_t>(n) * ct * O;
  const float* hn = h + static_cast<size_t>(n) * lin * C;
  // tile j: dconv's rows t0 .. t0 + 63 (zero past ct and past O: they meet
  // real h), then h's rows t0 .. t0 + 63 + K - 1 (zero past lin: they meet
  // dconv's zeros; columns past C only reach sums that are not written)
  const int rows = dense_rows(K);
  auto stage = [&](int j) {
    float* ds = smem + (j & 1) * words;
    const int t0 = j * rows;
    stage_block(dn, O, ct, t0, rows, o0, O, true, ds);
    stage_block(hn, C, lin, t0, rows + K - 1, c0, C, false,
                ds + rows * kDwCols);
    tpk::cp_async_commit();
  };
  float acc[4][4][K];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[f][c][k] = 0.0f;
    }
  }
  const int tiles = (ct + rows - 1) / rows;
  stage(0);
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      stage(j + 1);
      tpk::cp_async_wait<1>();
    } else {
      tpk::cp_async_wait<0>();
    }
    __syncthreads();
    const float4* d4 = reinterpret_cast<const float4*>(
        smem + (j & 1) * words) + fq;
    const float4* h4 = reinterpret_cast<const float4*>(
        smem + (j & 1) * words + rows * kDwCols) + cq;
    // ring[r % K] holds h row r of the tile, rows t .. t + K - 1 at row t
    float4 ring[K];
#pragma unroll
    for (int k = 0; k + 1 < K; ++k) ring[k] = h4[k * (kDwCols / 4)];
    for (int g = 0; g < rows; g += K) {
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int t = g + u;
        ring[(u + K - 1) % K] = h4[(t + K - 1) * (kDwCols / 4)];
        const float4 dv = d4[t * (kDwCols / 4)];
        const float d[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4 hv = ring[(u + k) % K];
          const float v[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int f = 0; f < 4; ++f) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[f][c][k] = fmaf(d[f], v[c], acc[f][c][k]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int o = o0 + 4 * fq + f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ch = c0 + 4 * cq + c;
      if (o < O && ch < C) {
        float* part =
            dw_part + n * ld + (static_cast<size_t>(o) * C + ch) * K;
#pragma unroll
        for (int k = 0; k < K; ++k) part[k] = acc[f][c][k];
      }
    }
  }
}

// the scratch's parts, in floats: dy (N M O), dconv (N M pool O), the
// per-window terms (N rows of ld = O C K + 2 M O: those of dW, dgt, dbt,
// summed over the windows in one pass), the flipped weights (O K x C
// padded)
struct Scratch {
  size_t dy, dconv, part, ld, wd, total;
};

Scratch scratch_of(int N, int C, int K, int O, int pool, int M) {
  const size_t nmo = static_cast<size_t>(N) * M * O;
  Scratch s{};
  s.dconv = nmo;
  s.part = s.dconv + nmo * pool;
  s.ld = static_cast<size_t>(O) * C * K + 2 * static_cast<size_t>(M) * O;
  s.wd = s.part + N * s.ld;
  s.total = s.wd + static_cast<size_t>(O) * K * tpk::gemm_cols_pad(C);
  return s;
}

struct BwdArgs {
  const float *h, *dconv, *wd;
  float *dw_part, *dh;
  size_t ld;
  int N, lin, C, O, M, pool;
};

template <int K>
struct BwdLaunch {
  static cudaError_t run(const BwdArgs& a, cudaStream_t stream) {
    cudaError_t err = tpk::allow_smem(stack_dw_kernel<K>);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.N, (a.O + kDwCols - 1) / kDwCols,
                    (a.C + kDwCols - 1) / kDwCols);
    stack_dw_kernel<K><<<grid, 256, dw_smem_bytes(K), stream>>>(
        a.h, a.dconv, a.dw_part, a.ld, a.lin, a.C, a.O, a.M * a.pool);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // dh[t, c] = sum over o, then k, of
    //     dconv[t - (K - 1) + k, o] wd[o K + k, c]
    const tpk::GemmArgs g{a.dconv, a.M * a.pool, a.O, a.wd, K - 1, 0, a.lin,
                          a.dh, nullptr, nullptr, a.C, 1, a.M};
    err = tpk::launch_gemm<K, false>(g, a.N, stream);
    return err;
  }
};

}  // namespace

// Floats of scratch the entry takes
extern "C" long tpk_stack_upper_bwd_scratch(int N, int C, int K, int O,
                                            int pool, int M) {
  return static_cast<long>(scratch_of(N, C, K, O, pool, M).total);
}

// One upper layer's backward.  Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this return
// value reports it (tpk::kErrSmem where one of the layer's passes needs
// too much shared memory).  scratch holds tpk_stack_upper_bwd_scratch
// floats, the pooled gradient dy (N, M, O) first; dh (N, lin, C) is the
// gradient of the layer's input, grads (O C K + 2 M O floats) those of W,
// gt and bt, one after the other.
extern "C" int tpk_stack_upper_bwd(
    const float* h, const float* w, const float* gt, const float* bt,
    const int* seed, const int8_t* idx, const float* stats, const float* y,
    const float* dz, float* scratch, float* dh, float* grads, int N, int lin,
    int C, int K, int O, int pool, int M, unsigned wid0, float eps, int relu,
    unsigned threshold, float scale, int drop_on, cudaStream_t stream) {
  if (!tpk::upper_geometry_ok(N, lin, C, K, O, pool, M)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t ln_smem = tpk::ln_smem_bytes(M);
  if (std::max(ln_smem, dw_smem_bytes(K)) > tpk::kMaxSmem) {
    return tpk::kErrSmem;
  }
  const Scratch s = scratch_of(N, C, K, O, pool, M);
  float* dy = scratch + s.dy;
  float* dconv = scratch + s.dconv;
  float* part = scratch + s.part;
  float* wd = scratch + s.wd;
  const size_t ock = static_cast<size_t>(O) * C * K;
  const size_t mo = static_cast<size_t>(M) * O;
  cudaError_t err = tpk::launch_prep(w, O, C, K, 1, wd, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tpk::allow_smem(stack_ln_bwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N, (O + tpk::kFilt - 1) / tpk::kFilt);
  stack_ln_bwd_kernel<<<grid, tpk::kLnWarps * 32, ln_smem, stream>>>(
      y, gt, bt, seed, idx, stats, dz, dy, part + ock, part + ock + mo, s.ld,
      dconv, O, M, pool, wid0, eps, relu, threshold, scale, drop_on);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{h, dconv, wd, part, dh, s.ld, N, lin, C, O, M,
                  pool};
  err = tpk::dispatch_taps<BwdLaunch>(K, a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tpk::launch_reduce(part, N, s.ld, grads, stream));
}
