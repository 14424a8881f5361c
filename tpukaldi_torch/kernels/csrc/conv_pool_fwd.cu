// Valid single-channel 1-D conv + max-pool, for Hopper (sm_90a): K5f.
//
// Replaces tpukaldi/kernels/conv1d.py::_fwd_kernel (launched from
// _conv_pool_fwd), layer 0 of the raw-waveform SincNet recipe:
//
//     c[n, s, o]   = sum_k x[n, s + k] * w[k, o]          k < K <= 512
//     y[n, m, o]   = max_q c[n, m * pool + q, o]          m < M = (L-K+1)/pool
//                                                         q < pool <= 32
//     idx[n, m, o] = the first q reaching it (int8; not written when null)
//
// x (N, L), w (K, O) and y (N, M, O) float32, products and sums in float32
// (tpukaldi multiplies bf16 only on a TPU).
//
// Design: conv_fwd.cuh's pipeline.  A persistent block (12 conv warps, 4
// epilogue warps; for a window of fewer than 384 pooled rows at pool 3, 3
// and 1, four blocks an SM) walks items (window n, tile of 16 filters, the whole
// window where it fits, else up to two conv passes of pooled rows); its
// conv warps stage the next item's span and weights by cp.async and run
// the register tile (a thread: 12 conv positions by 4 filters, 2 shared
// loads per 48 fmaf) into shared memory, while its epilogue warps write
// the item before out, a quad of filters at a time: a float4 of y and one
// 32-bit word of idx.
//
// What bounds it: 2 N (L-K+1) K O flops, 8.1 GFLOP at the training batch
// (128, 3200, 129, 80), against 55 MB of x, y and idx: the float32 FMA
// rate, 0.12 ms at 67 TFLOP/s.  The conv keeps every chain of the
// one-filter-per-lane design, so y and idx are its bits; a tensor-core
// implicit GEMM is faster but sums in another order (ROADMAP).

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_fwd.cuh"

namespace {

// a K5f block: 12 conv warps, 4 epilogue warps (its write-out is light);
// for a short window 3 and 1 (tpk::fwd_short)
using Warps = tpk::FwdWarps<12, 4>;
using Short = tpk::FwdWarps<3, 1>;

template <typename W>
__global__ void __launch_bounds__(W::kThreads, W::kBlocks)
conv_pool_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int8_t* __restrict__ idx, int L,
                     int K, int O, int M, int pool, tpk::FwdGeom g, int vec) {
  // the write-out: an epilogue thread takes one quad of filters and every
  // (W::kEpi / kQuads)-th row
  auto write = [&](const tpk::FwdItem& it, int m0, int rows, const float* ys,
                   const uint8_t* ids, float*) {
    const int t = threadIdx.x - W::kConv;
    const int q = t % tpk::kQuads;
    const int o = it.tile * tpk::kFwdFilt + q * 4;
    if (o >= O) return;
    const float4* ys4 = reinterpret_cast<const float4*>(ys);
    const uint32_t* ids4 = reinterpret_cast<const uint32_t*>(ids);
    const size_t base = (static_cast<size_t>(it.n) * M + m0) * O + o;
    for (int row = t / tpk::kQuads; row < rows;
         row += W::kEpi / tpk::kQuads) {
      const size_t e = base + static_cast<size_t>(row) * O;
      const float4 v4 = ys4[row * tpk::kQuads + q];
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      tpk::store_quad(y + e, v, O - o, vec);
      if (idx != nullptr) {
        tpk::store_quad_idx(idx + e, ids4[row * tpk::kQuads + q], O - o, vec);
      }
    }
  };
  tpk::fwd_pipeline<W>(x, w, L, K, O, M, pool, g, idx != nullptr, write);
}

using Kernel = decltype(&conv_pool_fwd_kernel<Warps>);

// A launch: the kernel of the long or the short block, its threads,
// geometry, shared bytes, grid and the blocks an SM holds
struct Launch {
  Kernel kernel;
  int threads;
  tpk::FwdGeom g;
  size_t smem;
  int grid, per_sm;
};

template <typename W>
bool plan_for(int N, int L, int K, int O, int pool, Launch* l) {
  l->kernel = conv_pool_fwd_kernel<W>;
  l->threads = W::kThreads;
  if (!tpk::fwd_geometry<W>(N, L, K, O, pool, false, &l->g)) return false;
  l->smem = tpk::fwd_smem_bytes(tpk::padded_taps(K), l->g);
  l->grid = tpk::fwd_grid<W>(l->kernel, l->g, l->smem, &l->per_sm);
  return l->grid > 0;
}

// the launch at a shape; false where it needs more shared memory than a
// block has
bool plan(int N, int L, int K, int O, int pool, Launch* l) {
  const int M = (L - K + 1) / pool;
  return tpk::fwd_short<Warps>(M, pool) ? plan_for<Short>(N, L, K, O, pool, l)
                                        : plan_for<Warps>(N, L, K, O, pool, l);
}

}  // namespace

// The launch at a shape: out[] = threads, filters a tile, conv positions
// and filters a conv thread computes, rows an item, row blocks a window,
// items, grid, shared bytes, blocks an SM holds, pooled-row buffers.
// Returns a CUDA error, 0 if none.
extern "C" int tpk_conv_pool_fwd_plan(int N, int L, int K, int O, int pool,
                                      int* out) {
  Launch l{};
  const bool ok =
      tpk::geometry_ok(N, L, K, O, pool) && plan(N, L, K, O, pool, &l);
  const int got[] = {l.threads, tpk::kFwdFilt, tpk::kFwdRun,
                     tpk::kTileF, l.g.rows, l.g.blocks, l.g.items, l.grid,
                     static_cast<int>(l.smem), l.per_sm, l.g.nbuf};
  for (int i = 0; i < 11; ++i) out[i] = got[i];
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.  idx may be null.
extern "C" int tpk_conv_pool_fwd(const float* x, const float* w, float* y,
                                 int8_t* idx, int N, int L, int K, int O,
                                 int pool, cudaStream_t stream) {
  Launch l;
  if (!tpk::geometry_ok(N, L, K, O, pool) ||
      !plan(N, L, K, O, pool, &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = (L - K + 1) / pool;
  const bool vec = O % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 4 == 0;
  const Kernel kernel = l.kernel;
  kernel<<<l.grid, l.threads, l.smem, stream>>>(x, w, y, idx, L, K, O, M,
                                                 pool, l.g, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
