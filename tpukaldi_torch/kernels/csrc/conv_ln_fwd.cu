// Layer 0 of the raw-waveform CNN, fused, for Hopper (sm_90a): K6f.
//
// Replaces tpukaldi/kernels/conv1d.py::_fused_fwd_kernel (launched from
// _fused_fwd).  Per window n and filter o, from the valid conv + max-pool
// of K5 (conv_fwd.cuh), over the M pooled rows:
//
//     y     = max-pool(conv)[m, o] + bias[o]
//     mu    = sum_m y / M,  c = y - mu,  s = sqrt(sum_m c^2 / max(M - 1, 1))
//     z     = ((c * r) * gt[m, o]) + bt[m, o],  r = 1 / (s + eps)
//     z     = relu(z) if relu;  z = keep ? z * scale : 0 if drop_on
//
// keep = tpukaldi's hash of (seed, window n, element m * O + o) below the
// threshold (conv_tile.cuh::drop_keep).  Writes out (N, M, O) and, when
// they are not null (training), idx (N, M, O) int8, stats (N, 2, O) = (mu,
// s) and ypool (N, M, O), the pooled conv value before the bias, which K6b
// reads.  float32 throughout; seed is an int32 on the device.
//
// Design: conv_fwd.cuh's pipeline over items (window n, tile of 16
// filters), a persistent block of 8 conv warps and 8 epilogue warps on
// each SM (a window of fewer than 256 pooled rows at pool 3, such as
// CNN_fbank's 143, goes to a block of 2 + 2 warps, four an SM).  The conv
// warps stage the next item's window and weights by
// cp.async and run the register tile (a thread: 12 conv positions by 4
// filters, 2 shared loads per 48 fmaf) into the item's pooled rows in
// shared memory (M x 16 floats and argmax bytes, 80 KB at the recipe's M =
// 1023; two such buffers), while the epilogue warps normalise the item
// before: the moments in the order of the one-filter-per-lane design (row
// m's term in slot m mod kLnWarps, summed in increasing m, then the slots
// in order), so out, stats and ypool are its bits; then out, ypool and idx
// a quad of filters at a time (float4s and one 32-bit word).  The separate
// layer norm, relu and dropout passes over the 64 MB activation (and a
// mask tensor) never touch device memory.
//
// What bounds it: the conv's 2 N (L-K+1) K O flops (13 GFLOP at the
// training batch (128, 3200, 129, 128), 0.19 ms at 67 TFLOP/s) against the
// bytes of x, gt, bt, out, idx, stats and ypool (153 MB there, 0.05 ms);
// serving writes out alone.  The conv phase of an item runs at about two
// thirds of the float32 FMA rate and the epilogue takes about as long
// beside it (PERF.md); a tensor-core implicit GEMM is faster but sums in
// another order (ROADMAP).

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_fwd.cuh"

namespace {

constexpr int kSlots = tpk::kLnWarps;  // partial sums a filter
// a K6f block: 8 conv warps, 8 epilogue warps (its layer norm is the
// heavier epilogue); for a short window 2 and 2 (tpk::fwd_short)
using Warps = tpk::FwdWarps<8, 8>;
using Short = tpk::FwdWarps<2, 2>;

// 4 filters' values of gt or bt at element e through the read-only path:
// one 16-byte load where `vec`, else the `left` filters below O word by
// word (0 past them)
__device__ __forceinline__ float4 load_quad(const float* __restrict__ src,
                                            int left, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  return make_float4(__ldg(src), left > 1 ? __ldg(src + 1) : 0.0f,
                     left > 2 ? __ldg(src + 2) : 0.0f,
                     left > 3 ? __ldg(src + 3) : 0.0f);
}

// The sum over the rows m = slot, slot + kSlots, ... < M, in increasing
// m, of y = ys[m][c] + bias (or of (y - mu)^2 where `square`), from 0: one
// chain, its loads kUnroll rows at a time
__device__ __forceinline__ float column_sum(const float* ys, int slot, int c,
                                            int M, float bias, float mu,
                                            bool square) {
  constexpr int kUnroll = 8;
  constexpr int F = tpk::kFwdFilt;
  float part = 0.0f;
  for (int m0 = slot; m0 < M; m0 += kUnroll * kSlots) {
    float y[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int m = m0 + i * kSlots;
      y[i] = m < M ? ys[m * F + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (m0 + i * kSlots < M) {
        if (square) {
          const float cm = (y[i] + bias) - mu;
          part += cm * cm;
        } else {
          part += y[i] + bias;
        }
      }
    }
  }
  return part;
}

// What the epilogue reads of one row of a quad of filters
struct QuadRow {
  float4 y;     // the pooled values (before the bias)
  float4 g, b;  // gt and bt
  uint32_t arg;  // the argmax bytes
};

// An epilogue thread's rows m = t / kQuads, + S, + 2 S, ... (S =
// W::kEpi / kQuads) of its quad of filters o .. o + 3 of window n: z =
// ((y + bias - mu) * r) * gt + bt, relu, dropout; out, and with residuals
// ypool and idx, a quad at a time (16-byte loads and stores where Vec: O a
// multiple of 4 and the pointers aligned).  The next two rows' reads are
// issued before the current two rows' stores, so they are in flight while
// those compute.
template <typename W, bool Vec>
__device__ __forceinline__ void norm_rows(
    const float4* ys4, const uint8_t* ids, const float* __restrict__ gt,
    const float* __restrict__ bt, float* __restrict__ out,
    float* __restrict__ ypool, int8_t* __restrict__ idx, int t, int n, int M,
    int O, int o, const float (&b0)[4], const float (&mu)[4],
    const float (&r)[4], int relu, int drop_on, const int* seed_p,
    uint32_t threshold, float scale) {
  constexpr int S = W::kEpi / tpk::kQuads;  // row stride
  const uint32_t seed = drop_on ? static_cast<uint32_t>(*seed_p) : 0u;
  const size_t win = static_cast<size_t>(n) * M * O;
  const uint32_t* ids4 = reinterpret_cast<const uint32_t*>(ids);
  const int q = (o % tpk::kFwdFilt) / 4;
  auto read = [&](int m) {
    QuadRow row{};
    if (m < M) {
      const size_t e = static_cast<size_t>(m) * O + o;
      row.y = ys4[m * tpk::kQuads + q];
      row.arg = ids != nullptr ? ids4[m * tpk::kQuads + q] : 0u;
      row.g = load_quad(gt + e, O - o, Vec);
      row.b = load_quad(bt + e, O - o, Vec);
    }
    return row;
  };
  auto write = [&](int m, const QuadRow& row) {
    if (m >= M) return;
    const size_t e = static_cast<size_t>(m) * O + o;
    const float yp[4] = {row.y.x, row.y.y, row.y.z, row.y.w};
    const float g[4] = {row.g.x, row.g.y, row.g.z, row.g.w};
    const float b[4] = {row.b.x, row.b.y, row.b.z, row.b.w};
    float z[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      float v = tpk::ln_affine((yp[f] + b0[f]) - mu[f], r[f], g[f], b[f]);
      if (relu) v = fmaxf(v, 0.0f);
      if (drop_on) {
        v = tpk::drop_keep(static_cast<uint32_t>(e + f), seed,
                           static_cast<uint32_t>(n), threshold) ? v * scale
                                                                : 0.0f;
      }
      z[f] = v;
    }
    tpk::store_quad(out + win + e, z, O - o, Vec);
    if (ids != nullptr) {
      tpk::store_quad(ypool + win + e, yp, O - o, Vec);
      tpk::store_quad_idx(idx + win + e, row.arg, O - o, Vec);
    }
  };
  const int m0 = t / tpk::kQuads;
  QuadRow a = read(m0), b = read(m0 + S);
  for (int m = m0; m < M; m += 2 * S) {
    const QuadRow c = read(m + 2 * S), d = read(m + 3 * S);
    write(m, a);
    write(m + S, b);
    a = c;
    b = d;
  }
}

template <typename W>
__global__ void __launch_bounds__(W::kThreads, W::kBlocks)
conv_ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ gt,
                   const float* __restrict__ bt, const int* __restrict__ seed_p,
                   float* __restrict__ out, int8_t* __restrict__ idx,
                   float* __restrict__ stats, float* __restrict__ ypool, int L,
                   int K, int O, int M, int pool, float eps, int relu,
                   uint32_t threshold, float scale, int drop_on,
                   tpk::FwdGeom g, int vec) {
  constexpr int F = tpk::kFwdFilt;
  constexpr int E = W::kEpi;
  static_assert(E >= F, "an epilogue thread a filter for the moments");
  // the layer norm of an item (a whole window), on the epilogue threads
  auto norm = [&](const tpk::FwdItem& it, int, int, const float* ys,
                  const uint8_t* ids, float* red) {
    const int t = threadIdx.x - W::kConv;
    const int o0 = it.tile * F;
    const float4* ys4 = reinterpret_cast<const float4*>(ys);
    float* mus = red + 2 * kSlots * F;  // per filter: the mean,
    float* rs = mus + F;                // and 1 / (std + eps)
    // the moments, thread p = (slot, filter c) for p = t, t + E, ... <
    // kSlots x F: y = ys + bias over the rows m = slot mod kSlots in
    // increasing m; then over the slots in order
    for (int p = t; p < kSlots * F; p += E) {
      const int c = p % F;
      const float bc = o0 + c < O ? bias[o0 + c] : 0.0f;
      red[p] = column_sum(ys, p / F, c, M, bc, 0.0f, false);
    }
    tpk::named_barrier(1, E);
    for (int p = t; p < kSlots * F; p += E) {
      const int c = p % F;
      const float bc = o0 + c < O ? bias[o0 + c] : 0.0f;
      float tot = 0.0f;
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) tot += red[sl * F + c];
      const float mu = tot / static_cast<float>(M);
      red[kSlots * F + p] = column_sum(ys, p / F, c, M, bc, mu, true);
      if (p < F) mus[c] = mu;
    }
    tpk::named_barrier(1, E);
    if (t < F) {
      float ss = 0.0f;
      for (int sl = 0; sl < kSlots; ++sl) ss += red[kSlots * F + sl * F + t];
      const float s = sqrtf(ss / static_cast<float>(max(M - 1, 1)));
      rs[t] = 1.0f / (s + eps);
      if (stats != nullptr && o0 + t < O) {
        stats[static_cast<size_t>(it.n) * 2 * O + o0 + t] = mus[t];
        stats[static_cast<size_t>(it.n) * 2 * O + O + o0 + t] = s;
      }
    }
    tpk::named_barrier(1, E);
    // a thread takes one quad of filters, c0 .. c0 + 3, and every
    // (E / kQuads)-th row
    const int c0 = t % tpk::kQuads * 4;
    const int o = o0 + c0;
    if (o >= O) return;
    float b0[4], mq[4], r[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      b0[f] = o + f < O ? bias[o + f] : 0.0f;
      mq[f] = mus[c0 + f];
      r[f] = rs[c0 + f];
    }
    if (vec) {
      norm_rows<W, true>(ys4, ids, gt, bt, out, ypool, idx, t, it.n, M, O, o,
                      b0, mq, r, relu, drop_on, seed_p, threshold, scale);
    } else {
      norm_rows<W, false>(ys4, ids, gt, bt, out, ypool, idx, t, it.n, M, O,
                          o, b0, mq, r, relu, drop_on, seed_p, threshold,
                          scale);
    }
  };
  tpk::fwd_pipeline<W>(x, w, L, K, O, M, pool, g, idx != nullptr, norm);
}

using Kernel = decltype(&conv_ln_fwd_kernel<Warps>);

// A launch: the kernel of the long or the short block, its threads,
// geometry (whole windows), shared bytes, grid and the blocks an SM holds
struct Launch {
  Kernel kernel;
  int threads;
  tpk::FwdGeom g;
  size_t smem;
  int grid, per_sm;
};

template <typename W>
bool plan_for(int N, int L, int K, int O, int pool, Launch* l) {
  l->kernel = conv_ln_fwd_kernel<W>;
  l->threads = W::kThreads;
  if (!tpk::fwd_geometry<W>(N, L, K, O, pool, true, &l->g)) return false;
  l->smem = tpk::fwd_smem_bytes(tpk::padded_taps(K), l->g);
  l->grid = tpk::fwd_grid<W>(l->kernel, l->g, l->smem, &l->per_sm);
  return l->grid > 0;
}

// the launch at a shape; false where a window needs more shared memory
// than a block has
bool plan(int N, int L, int K, int O, int pool, Launch* l) {
  const int M = (L - K + 1) / pool;
  return tpk::fwd_short<Warps>(M, pool) ? plan_for<Short>(N, L, K, O, pool, l)
                                        : plan_for<Warps>(N, L, K, O, pool, l);
}

}  // namespace

// The shared memory a block needs for a window of L samples, with one
// pooled-row buffer (a second where it fits); past tpk::kMaxSmem the
// launch is refused.
extern "C" long tpk_conv_ln_smem_bytes(int L, int K, int pool) {
  tpk::FwdGeom g{};
  if (!tpk::fwd_geometry<Warps>(1, L, K, 1, pool, true, &g)) {
    return static_cast<long>(tpk::kMaxSmem) + 1;
  }
  g.nbuf = 1;
  return static_cast<long>(tpk::fwd_smem_bytes(tpk::padded_taps(K), g));
}

// The launch at a shape: out[] = threads, filters a tile, conv positions
// and filters a conv thread computes, items, grid, shared bytes, blocks an
// SM holds, pooled-row buffers.  Returns a CUDA error, 0 if none.
extern "C" int tpk_conv_ln_fwd_plan(int N, int L, int K, int O, int pool,
                                    int* out) {
  Launch l{};
  const bool ok =
      tpk::geometry_ok(N, L, K, O, pool) && plan(N, L, K, O, pool, &l);
  const int got[] = {l.threads, tpk::kFwdFilt, tpk::kFwdRun,
                     tpk::kTileF, l.g.items, l.grid, static_cast<int>(l.smem),
                     l.per_sm, l.g.nbuf};
  for (int i = 0; i < 9; ++i) out[i] = got[i];
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.  idx, stats and
// ypool are all null (inference) or none is (training).
extern "C" int tpk_conv_ln_fwd(const float* x, const float* w,
                               const float* bias, const float* gt,
                               const float* bt, const int* seed, float* out,
                               int8_t* idx, float* stats, float* ypool, int N,
                               int L, int K, int O, int pool, float eps,
                               int relu, unsigned threshold, float scale,
                               int drop_on, cudaStream_t stream) {
  Launch l;
  if (!tpk::geometry_ok(N, L, K, O, pool) ||
      !plan(N, L, K, O, pool, &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = (L - K + 1) / pool;
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = O % 4 == 0 && a16(gt) && a16(bt) && a16(out) &&
                   a16(ypool) && reinterpret_cast<uintptr_t>(idx) % 4 == 0;
  const Kernel kernel = l.kernel;
  kernel<<<l.grid, l.threads, l.smem, stream>>>(
      x, w, bias, gt, bt, seed, out, idx, stats, ypool, L, K, O, M, pool, eps,
      relu, threshold, scale, drop_on, l.g, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
