// Backward of an upper layer of the raw-waveform conv stack (K7f), for
// Hopper (sm_90a): K7b.
//
// Replaces tpukaldi/kernels/conv_stack.py::_stack_bwd_kernel (launched from
// _stack_bwd), which recomputes the whole stack per 8 windows in VMEM and
// sweeps back through it.  Here the wrapper calls this entry once per upper
// layer, from the top down, and then K6b (conv_ln_bwd.cu) for layer 0 from
// the cotangent of layer 1's input.  From the output gradient dz (N, M, O),
// the forward's idx and stats (mu, s), the layer's input h (N, lin, C) that
// the forward kept, and W, bias, gt, bt, per window n and filter o:
//
//     y    = conv(h, W)[m * pool + idx] + bias   (recomputed through idx)
//     c    = y - mu,  r = 1 / (s + eps),  xhat = c * r
//     dz   = keep ? dz * scale : 0  (drop_on);  dz = 0 where z <= 0 (relu)
//     dgt  = sum_n dz * xhat,  dbt = sum_n dz            (M, O)
//     dzg  = dz * gt,  A = sum_m dzg,  B = sum_m dzg * c
//     dy   = r dzg - c (B r r) / (max(M-1, 1) max(s, 1e-30)) - (r / M) A
//     dW[o, c, k] = sum_{n, m} h[n, m pool + idx + k, c] * dy[n, m, o]
//     dh[n, t, c] = sum_{o, k} dconv[n, t - k, o] * W[o, c, k]
//
// with dconv the pooled gradient scattered onto the conv rows through idx.
// The mask is the forward's (window id wid0 + n, element m * 128 + o).
// dbias is the exact zero (the layer norm's mean cancels the bias), which
// the wrapper writes.
//
// Design: four passes, no atomics, so a replayed step gives the same bits.
// (1) Layer norm: one block per (window n, tile of 32 filters), 16 warps,
// as K6b's first pass: the tile's weights in shared memory, the pooled
// value recomputed at the saved argmax with the forward's own fmaf chain
// (stack_tile.cuh::upper_conv_at), so c, the relu gate and the rebuilt mask
// are the forward's bit for bit; c kept in shared memory, A and B summed per
// lane then over the warps in order, dy written.  The per-window terms of
// dgt and dbt go to scratch.  (2) dW: one block per (window, filter tile);
// a warp owns channels, a lane a filter, and keeps the K taps' sums in
// registers over the window's pooled rows (dy and idx staged in shared
// memory), 32 rows to a block sum; the per-window shares go to dw_part.
// (3) The windows of dW, dgt and dbt summed 32 at a time, in order
// (conv_pool_bwd.cuh::launch_reduce).  (4) dX in gather form: one block per
// (window, 96 rows, 32 channels), 8 warps; the block scatters the pooled
// gradient of the rows it reaches into shared memory, and a thread (lane =
// channel) keeps a run of 12 rows' sums in registers over the filters and
// taps, as upper_run does.
//
// What bounds it: the remat, dW and dX each 2 N M C K O flops (pooled rows
// only): 10.0 GFLOP for CNN_raw's layer 1 at the training batch, 0.15 ms at
// 67 TFLOP/s.  The remat and dW read h at one load per fmaf (the lanes of a
// warp read at most `pool` rows), and the remat of an element is one
// dependent chain of C K fmaf, which points to latency as what sets the
// layer-norm pass, the largest of the four (PERF.md, section 6): several
// rows' chains interleaved in a thread would hide it and keep each
// chain's order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "conv_pool_bwd.cuh"
#include "stack_tile.cuh"

namespace {

constexpr int kDxWarps = 8;
constexpr int kDxRows = kDxWarps * tpk::kRun;  // rows of dh per block

__global__ void __launch_bounds__(tpk::kLnWarps * 32)
stack_ln_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ gt,
                    const float* __restrict__ bt, const int* __restrict__ seed_p,
                    const int8_t* __restrict__ idx,
                    const float* __restrict__ stats,
                    const float* __restrict__ dz, float* __restrict__ dy,
                    float* __restrict__ dgp, float* __restrict__ dbp, int lin,
                    int C, int K, int O, int M, int pool, uint32_t wid0,
                    float eps, int relu, uint32_t threshold, float scale,
                    int drop_on) {
  extern __shared__ float smem[];
  float* ws = smem;                       // C K x kFilt
  float* cs = ws + C * K * tpk::kFilt;    // M x kFilt: c = y - mu
  float* red = cs + M * tpk::kFilt;       // 2 x kLnWarps x kFilt
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * tpk::kFilt;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int o = o0 + lane;
  const bool active = o < O;
  const size_t win = static_cast<size_t>(n) * M * O;
  const float* hn = h + static_cast<size_t>(n) * lin * C;
  tpk::load_upper_filters(w, C, K, O, o0, ws);
  __syncthreads();

  float mu = 0.0f, s = 1.0f, b0 = 0.0f;
  if (active) {
    mu = stats[static_cast<size_t>(n) * 2 * O + o];
    s = stats[static_cast<size_t>(n) * 2 * O + O + o];
    b0 = bias[o];
  }
  const float r = 1.0f / (s + eps);
  const uint32_t seed = drop_on ? static_cast<uint32_t>(*seed_p) : 0u;
  float a_part = 0.0f, b_part = 0.0f;
  if (active) {
    for (int m = warp; m < M; m += tpk::kLnWarps) {
      const size_t e = static_cast<size_t>(m) * O + o;
      const int sp = m * pool + idx[win + e];
      const float c = (tpk::upper_conv_at(hn, ws, sp, C, K, lane) + b0) - mu;
      const float xhat = c * r;
      float d = dz[win + e];
      if (drop_on) {
        d = tpk::drop_keep(static_cast<uint32_t>(m) * tpk::kMaskLanes + o, seed,
                           wid0 + static_cast<uint32_t>(n), threshold)
                ? d * scale : 0.0f;
      }
      const float g = gt[e];
      if (relu && !(tpk::ln_affine(c, r, g, bt[e]) > 0.0f)) d = 0.0f;
      dgp[win + e] = d * xhat;
      dbp[win + e] = d;
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
    dy[e] = r * dy[e] - cs[m * tpk::kFilt + lane] * fac - rm * A;
  }
}

// One window's share of dW: block (n, filter tile), lane = filter, warp =
// channels c = warp + kLnWarps * j; the K taps' sums in registers, 32 rows
// into a block sum, the blocks into the total
template <int K>
__global__ void __launch_bounds__(tpk::kLnWarps * 32)
stack_dw_part_kernel(const float* __restrict__ h, const float* __restrict__ dy,
                     const int8_t* __restrict__ idx,
                     float* __restrict__ dw_part, int lin, int C, int O, int M,
                     int pool) {
  extern __shared__ float smem[];
  float* dys = smem;                                         // M x kFilt
  int8_t* ids = reinterpret_cast<int8_t*>(dys + M * tpk::kFilt);  // M x kFilt
  const int n = blockIdx.x;
  const int o0 = blockIdx.y * tpk::kFilt;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int o = o0 + lane;
  const size_t win = static_cast<size_t>(n) * M * O;
  const float* hn = h + static_cast<size_t>(n) * lin * C;
  for (int i = threadIdx.x; i < M * tpk::kFilt; i += blockDim.x) {
    const int oo = o0 + i % tpk::kFilt;
    const size_t e = win + static_cast<size_t>(i / tpk::kFilt) * O + oo;
    dys[i] = oo < O ? dy[e] : 0.0f;
    ids[i] = oo < O ? idx[e] : 0;
  }
  __syncthreads();
  for (int c = warp; c < C; c += tpk::kLnWarps) {
    float tot[K];
    float blk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) tot[k] = blk[k] = 0.0f;
    for (int m = 0; m < M; ++m) {
      const float d = dys[m * tpk::kFilt + lane];
      const float* hs = hn + static_cast<size_t>(
          m * pool + ids[m * tpk::kFilt + lane]) * C + c;
#pragma unroll
      for (int k = 0; k < K; ++k) blk[k] = fmaf(__ldg(hs + k * C), d, blk[k]);
      if ((m & 31) == 31) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          tot[k] += blk[k];
          blk[k] = 0.0f;
        }
      }
    }
    if (o < O) {
      float* part = dw_part + ((static_cast<size_t>(n) * O + o) * C + c) * K;
#pragma unroll
      for (int k = 0; k < K; ++k) part[k] = tot[k] + blk[k];
    }
  }
}

// dh of one window in gather form: block (n, kDxRows rows from t0, 32
// channels from c0), lane = channel, warp = a run of kRun rows.  dcs holds
// the conv rows t0 - K + 1 .. t0 + kDxRows - 1 of dconv, ws the channels'
// weights ws[(o K + k) kFilt + col] = W[o, c0 + col, k]
template <int K>
__global__ void __launch_bounds__(kDxWarps * 32)
stack_dx_kernel(const float* __restrict__ dy, const int8_t* __restrict__ idx,
                const float* __restrict__ w, float* __restrict__ dh, int lin,
                int C, int O, int M, int pool) {
  extern __shared__ float smem[];
  const int span = kDxRows + K - 1;
  float* dcs = smem;               // span x O
  float* ws = dcs + span * O;      // O K x kFilt
  const int n = blockIdx.x;
  const int t0 = blockIdx.y * kDxRows;
  const int c0 = blockIdx.z * tpk::kFilt;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int base = t0 - (K - 1);
  const size_t win = static_cast<size_t>(n) * M * O;
  for (int i = threadIdx.x; i < span * O; i += blockDim.x) dcs[i] = 0.0f;
  for (int i = threadIdx.x; i < O * K * tpk::kFilt; i += blockDim.x) {
    const int c = c0 + i % tpk::kFilt;
    const int ok = i / tpk::kFilt;  // o K + k
    ws[i] = c < C ? w[(static_cast<size_t>(ok / K) * C + c) * K + ok % K] : 0.0f;
  }
  __syncthreads();
  const int pbeg = base > 0 ? base / pool : 0;
  const int pend = min(M, (t0 + kDxRows - 1) / pool + 1);  // exclusive
  for (int i = threadIdx.x; i < (pend - pbeg) * O; i += blockDim.x) {
    const int p = pbeg + i / O;
    const int oo = i % O;
    const size_t e = win + static_cast<size_t>(p) * O + oo;
    const int t = p * pool + idx[e];
    if (t >= base && t < t0 + kDxRows) dcs[(t - base) * O + oo] = dy[e];
  }
  __syncthreads();
  const int tw = warp * tpk::kRun;  // the run's first row, from t0
  float acc[tpk::kRun];
#pragma unroll
  for (int j = 0; j < tpk::kRun; ++j) acc[j] = 0.0f;
  for (int o = 0; o < O; ++o) {
    float xr[tpk::kRun + K - 1];  // xr[u] = dconv row t0 + tw - (K - 1) + u
    float wr[K];
#pragma unroll
    for (int u = 0; u < tpk::kRun + K - 1; ++u) xr[u] = dcs[(tw + u) * O + o];
#pragma unroll
    for (int k = 0; k < K; ++k) wr[k] = ws[(o * K + k) * tpk::kFilt + lane];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < tpk::kRun; ++j) {
        acc[j] = fmaf(xr[j - k + K - 1], wr[k], acc[j]);
      }
    }
  }
  const int c = c0 + lane;
  if (c >= C) return;
#pragma unroll
  for (int j = 0; j < tpk::kRun; ++j) {
    const int t = t0 + tw + j;
    if (t < lin) dh[(static_cast<size_t>(n) * lin + t) * C + c] = acc[j];
  }
}

size_t dw_smem_bytes(int M) {
  return static_cast<size_t>(M) * tpk::kFilt * (sizeof(float) + sizeof(int8_t));
}

size_t dx_smem_bytes(int K, int O) {
  return (static_cast<size_t>(kDxRows + K - 1) * O +
          static_cast<size_t>(O) * K * tpk::kFilt) * sizeof(float);
}

size_t bwd_smem_bytes(int C, int K, int O, int M) {
  return std::max(tpk::upper_smem_bytes(C, K, M),
                  std::max(dw_smem_bytes(M), dx_smem_bytes(K, O)));
}

struct BwdArgs {
  const float *h, *dy;
  const int8_t* idx;
  const float* w;
  float *dw_part, *dh;
  int N, lin, C, O, M, pool;
};

template <int K>
struct BwdLaunch {
  static cudaError_t run(const BwdArgs& a, cudaStream_t stream) {
    const size_t dw_smem = dw_smem_bytes(a.M);
    const size_t dx_smem = dx_smem_bytes(K, a.O);
    cudaError_t err = cudaFuncSetAttribute(
        stack_dw_part_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dw_smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(stack_dx_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dx_smem));
    if (err != cudaSuccess) return err;
    const int tiles = (a.O + tpk::kFilt - 1) / tpk::kFilt;
    stack_dw_part_kernel<K><<<dim3(a.N, tiles), tpk::kLnWarps * 32, dw_smem,
                              stream>>>(a.h, a.dy, a.idx, a.dw_part, a.lin,
                                        a.C, a.O, a.M, a.pool);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 dx_grid(a.N, (a.lin + kDxRows - 1) / kDxRows,
                       (a.C + tpk::kFilt - 1) / tpk::kFilt);
    stack_dx_kernel<K><<<dx_grid, kDxWarps * 32, dx_smem, stream>>>(
        a.dy, a.idx, a.w, a.dh, a.lin, a.C, a.O, a.M, a.pool);
    return cudaGetLastError();
  }
};

}  // namespace

// One upper layer's backward.  Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and only this return
// value reports it (tpk::kErrSmem where the largest of the layer's passes
// needs too much shared memory).  dy, dgp and dbp are scratch of N M O
// floats, dw_part of N O C K; dh (N, lin, C) is the gradient of the layer's
// input.
extern "C" int tpk_stack_upper_bwd(
    const float* h, const float* w, const float* bias, const float* gt,
    const float* bt, const int* seed, const int8_t* idx, const float* stats,
    const float* dz, float* dy, float* dgp, float* dbp, float* dw_part,
    float* dh, float* dw, float* dgt, float* dbt, int N, int lin, int C, int K,
    int O, int pool, int M, unsigned wid0, float eps, int relu,
    unsigned threshold, float scale, int drop_on, cudaStream_t stream) {
  if (!tpk::upper_geometry_ok(N, lin, C, K, O, pool, M)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bwd_smem_bytes(C, K, O, M) > tpk::kMaxSmem) return tpk::kErrSmem;
  const size_t ln_smem = tpk::upper_smem_bytes(C, K, M);
  cudaError_t err = cudaFuncSetAttribute(
      stack_ln_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ln_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N, (O + tpk::kFilt - 1) / tpk::kFilt);
  stack_ln_bwd_kernel<<<grid, tpk::kLnWarps * 32, ln_smem, stream>>>(
      h, w, bias, gt, bt, seed, idx, stats, dz, dy, dgp, dbp, lin, C, K, O, M,
      pool, wid0, eps, relu, threshold, scale, drop_on);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{h, dy, idx, w, dw_part, dh, N, lin, C, O, M, pool};
  err = tpk::dispatch_taps<BwdLaunch>(K, a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tpk::launch_reduce(dw_part, N, static_cast<size_t>(O) * C * K, dw,
                           stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mo = static_cast<size_t>(M) * O;
  err = tpk::launch_reduce(dgp, N, mo, dgt, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tpk::launch_reduce(dbp, N, mo, dbt, stream));
}
