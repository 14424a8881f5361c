// The forwards' register tile and pipeline, which K5f (conv_pool_fwd.cu)
// and K6f (conv_ln_fwd.cu) share.
//
// Each conv value is one chain of fmaf over the taps k = 0 .. Kp - 1 in
// order (conv_tile), Kp = K padded to a multiple of kTapChunk: taps K ..
// Kp - 1 carry zero weights and the window is zero-padded past L, so they
// add exact zeros.  These are the chains of the one-filter-per-lane design
// before it, so the pooled values and their argmax are its bits.
//
// The tile.  A block takes kFwdFilt filters; a conv thread computes a run
// of kFwdRun conv positions for kTileF consecutive filters, kFwdRun x
// kTileF chains in registers.  Per tap it loads one sample (the run's
// samples slide through a ring of registers) and its filters' weights as
// one 16-byte load: 2 shared loads for 48 fmaf, against 27 for 96 in the
// one-filter-per-lane design (0.04 a fmaf against 0.28).  A warp's lanes
// are kTileLanes filter lanes times kTileGroups position groups (runs);
// the lanes of a group read the same sample, a broadcast.
//
// The pipeline.  A persistent block walks items (window n, filter tile,
// block of pooled rows) with a kernel's conv warps and epilogue warps
// (FwdWarps).  In each phase the conv warps stage the next item's window
// span and weights with cp.async and compute the current item's conv and
// max-pool into shared memory, while the epilogue warps write out (K5f) or
// normalise and write out (K6f) the item before; one __syncthreads ends
// the phase.  With two pooled-row buffers (nbuf 2) the two overlap; where
// only one fits, conv and epilogue take turns.
//
// Long filters and pools.  A filter of any K in the entries' envelope
// (conv_tile.cuh) is one more trip of the tap loop: the weight tile holds
// the Kp taps it is given.  A pool longer than kFwdRun is one pooled row
// a run, its conv positions kFwdRun at a time, the max and its first index
// carried from one to the next; the chains and comparisons are the same,
// so a pool that fits a run gives the bits it gave before.
//
// Two blocks.  A window whose runs fill the long block's conv warps once
// or more goes to that block, one an SM; a shorter window's item would idle
// part of them and its phases are short, so it goes to a block of a
// quarter the threads, four an SM, whose items run side by side
// (fwd_short).  Both keep every chain and sum order, so their outputs are
// the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "conv_tile.cuh"
#include "persist_grid.cuh"

namespace tpk {

constexpr int kFwdRun = 12;   // conv positions a conv thread computes
constexpr int kTileF = 4;     // filters a conv thread computes: 2 or 4
constexpr int kFwdFilt = 16;  // filters a block tile: no idle lane at 80
constexpr int kMaxBufs = 2;   // pooled-row buffers, where they fit
constexpr bool kPersistent = true;  // a block walks items; else one each
constexpr int kTileLanes = kFwdFilt / kTileF;
constexpr int kTileGroups = 32 / kTileLanes;
constexpr int kQuads = kFwdFilt / 4;                // float4s of a row
constexpr int kTapsPerLoad = 4 / kTileF;  // taps a 16-byte weight load holds
static_assert((kTileF == 2 || kTileF == 4) && kFwdRun % kTapsPerLoad == 0 &&
                  kFwdFilt % 4 == 0 && 32 % kTileLanes == 0,
              "a weight load holds whole taps, a warp whole position groups");

// A kernel's block: Conv conv warps (threads 0 .. kConv - 1), then Epi
// epilogue warps; kBlocks of them an SM at up to 128 registers a thread
template <int Conv, int Epi>
struct FwdWarps {
  static constexpr int kConv = Conv * 32;
  static constexpr int kEpi = Epi * 32;
  static constexpr int kThreads = kConv + kEpi;
  static constexpr int kRuns = Conv * kTileGroups;  // runs of a conv pass
  static constexpr int kBlocks = kThreads >= 512 ? 1 : 512 / kThreads;
  static_assert(kEpi % kQuads == 0, "epilogue threads take whole rows");
};

// pooled rows a run holds: whole pooling windows of its kFwdRun conv
// positions, or one window of a longer pool, which the run then computes
// kFwdRun positions at a time (conv_pool_runs); and the window words of
// `runs` runs
__host__ __device__ inline int fwd_rows(int pool) {
  return pool <= kFwdRun ? kFwdRun / pool : 1;
}
__host__ __device__ inline int fwd_span(int runs, int pool, int Kp) {
  return (runs * fwd_rows(pool) * pool + Kp + kFwdRun + 3) / 4 * 4;
}

// The launch's shape, computed on the host (fwd_geometry) and passed to
// the kernel.
struct FwdGeom {
  int rows;    // pooled rows an item computes (a window's last block fewer)
  int blocks;  // row blocks of a window
  int tiles;   // filter tiles
  int items;   // N x tiles x blocks, window by window
  int span;    // window words an item stages
  int nbuf;    // pooled-row buffers, 1 or 2
};

struct FwdItem {
  int n, tile, rb;
};

__device__ inline FwdItem fwd_item(const FwdGeom& g, int item) {
  const int rest = item / g.blocks;
  return {rest / g.tiles, rest % g.tiles, item % g.blocks};
}

// the block's shared memory: two weight tiles (the Kp taps and the group
// of kTapsPerLoad past them, x kFwdFilt), two window spans, nbuf
// pooled-row buffers (rows x kFwdFilt floats), the epilogue's slot sums
// and per-filter rows (2 x kLnWarps x kFwdFilt + 4 x kFwdFilt), then nbuf
// argmax buffers (rows x kFwdFilt bytes)
__host__ __device__ inline int fwd_weight_words(int Kp) {
  return (Kp + kTapsPerLoad) * kFwdFilt;
}
__host__ __device__ inline int fwd_words(int Kp, const FwdGeom& g) {
  return 2 * fwd_weight_words(Kp) + 2 * g.span + g.nbuf * g.rows * kFwdFilt +
         2 * kLnWarps * kFwdFilt + 4 * kFwdFilt;
}
inline size_t fwd_smem_bytes(int Kp, const FwdGeom& g) {
  return static_cast<size_t>(fwd_words(Kp, g)) * sizeof(float) +
         static_cast<size_t>(g.nbuf) * g.rows * kFwdFilt;
}

// The launch for N windows of M pooled rows: a whole window an item where
// it fits (K6f's layer norm needs it: `whole`), else two conv passes of
// rows, else one; two pooled-row buffers where they fit in a block's
// shared memory.  False where nothing fits.
template <typename W>
inline bool fwd_geometry(int N, int L, int K, int O, int pool, bool whole,
                         FwdGeom* g) {
  const int M = (L - K + 1) / pool;
  const int Kp = padded_taps(K);
  const int R = fwd_rows(pool);
  g->tiles = (O + kFwdFilt - 1) / kFwdFilt;
  for (int nbuf = kMaxBufs; nbuf >= 1; --nbuf) {
    // cut 0: the whole window; 1: two conv passes of rows; 2: one
    for (int cut = 0; cut <= (whole ? 0 : 2); ++cut) {
      g->rows = cut == 0 ? M : min(M, (3 - cut) * W::kRuns * R);
      g->nbuf = nbuf;
      g->span = fwd_span((g->rows + R - 1) / R, pool, Kp);
      g->blocks = (M + g->rows - 1) / g->rows;
      const long items = static_cast<long>(N) * g->tiles * g->blocks;
      if (fwd_smem_bytes(Kp, *g) <= kMaxSmem && items <= 0x7fffffffL) {
        g->items = static_cast<int>(items);
        return true;
      }
    }
  }
  return false;
}

// Whether a window of M pooled rows goes to the short block: its runs
// fill fewer than one conv pass of the long block W
template <typename W>
inline bool fwd_short(int M, int pool) {
  return (M + fwd_rows(pool) - 1) / fwd_rows(pool) < W::kRuns;
}

// a barrier among the `threads` threads (whole warps) that call it
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// By the conv threads: xs[i] = x_row[start + i] for i < count, zero outside
// [0, L), xs 16-byte aligned.  Where the row's samples from `start` are
// 16-byte aligned, the words inside [0, L) go as 16-byte cp.async copies;
// odd shapes take the plain per-thread load.
template <typename W>
__device__ inline void stage_window(const float* __restrict__ x_row, int L,
                                    int start, int count, float* xs) {
  const float* src = x_row + start;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = min(count, L - start) / 4 * 4;
    for (int i = threadIdx.x * 4; i < done; i += W::kConv * 4) {
      cp_async16_cg(xs + i, src + i);
    }
  }
  for (int i = done + threadIdx.x; i < count; i += W::kConv) {
    xs[i] = start + i < L ? src[i] : 0.0f;
  }
}

// The weight tile's layout: the float4 (k / T) * kTileLanes + fl holds
// w[k][o0 + fl * kTileF + f] at component (k % T) * kTileF + f, T =
// kTapsPerLoad: a conv thread's filters at T taps, one 16-byte load.
__host__ __device__ inline int ws_index(int k, int fl, int f) {
  return ((k / kTapsPerLoad) * kTileLanes + fl) * 4 +
         (k % kTapsPerLoad) * kTileF + f;
}

// By the conv threads: the weight tile for the taps k < Kp +
// kTapsPerLoad (conv_tile's last group loads the group past Kp) through
// cp.async, a thread's kTileF filters of a tap as one copy where O is a
// multiple of kTileF and w aligned to it, else word by word; zero for taps
// k >= K and filters >= O
template <typename W>
__device__ inline void stage_filters(const float* __restrict__ w, int K,
                                     int O, int o0, int Kp, float* ws) {
  const bool wide = O % kTileF == 0 &&
                    reinterpret_cast<uintptr_t>(w) % (4 * kTileF) == 0;
  for (int i = threadIdx.x; i < (Kp + kTapsPerLoad) * kTileLanes;
       i += W::kConv) {
    const int k = i / kTileLanes;
    const int fl = i % kTileLanes;
    const int o = o0 + fl * kTileF;
    float* dst = ws + ws_index(k, fl, 0);
    const float* src = w + static_cast<size_t>(k) * O + o;
    if (wide && k < K && o < O) {
      if constexpr (kTileF == 4) {
        cp_async16_cg(dst, src);
      } else {
        cp_async8(dst, src);
      }
    } else {
#pragma unroll
      for (int f = 0; f < kTileF; ++f) {
        if (k < K && o + f < O) {
          cp_async4(dst + f, src + f);
        } else {
          dst[f] = 0.0f;
        }
      }
    }
  }
}

// component i (a compile-time constant once inlined) of v
__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One tap k of conv_tile: acc[j][f] += x[s + j + k] * w[k, f] for the
// run's kFwdRun positions and the thread's kTileF filters, then the ring
// moves on.  ring[i] holds x[s + m] for the m = i mod kFwdRun in [k, k +
// kFwdRun), so with t = k mod kFwdRun position j's sample is ring[(j + t)
// % kFwdRun]; nx holds x[s + k + kFwdRun] and cur the weights of tap k's
// group of kTapsPerLoad taps.  The group's first tap loads the next
// group's weights into wv, and each tap the sample of the next, so both
// are in flight a tap or more before their use; then nx takes the slot of
// x[s + k].
template <int t>
__device__ __forceinline__ void conv_tap(const float4* w4, const float* xp,
                                         int k,
                                         float (&acc)[kFwdRun][kTileF],
                                         float (&ring)[kFwdRun], float4& cur,
                                         float4& wv, float& nx) {
  if constexpr (t % kTapsPerLoad == 0) {
    cur = wv;
    wv = w4[(k / kTapsPerLoad + 1) * kTileLanes];
  }
  float wk[kTileF];
#pragma unroll
  for (int f = 0; f < kTileF; ++f) {
    wk[f] = component(cur, (t % kTapsPerLoad) * kTileF + f);
  }
  const float enter = nx;
  nx = xp[k + kFwdRun + 1];
#pragma unroll
  for (int j = 0; j < kFwdRun; ++j) {
    const float xj = ring[(j + t) % kFwdRun];
#pragma unroll
    for (int f = 0; f < kTileF; ++f) acc[j][f] = fmaf(xj, wk[f], acc[j][f]);
  }
  ring[t] = enter;
}

// the taps t .. kFwdRun - 1 of the block of kFwdRun taps from k0, each
// only below Kp where `guard`
template <int t>
__device__ __forceinline__ void conv_taps(const float4* w4, const float* xp,
                                          int k0, int Kp, bool guard,
                                          float (&acc)[kFwdRun][kTileF],
                                          float (&ring)[kFwdRun],
                                          float4& cur, float4& wv,
                                          float& nx) {
  if constexpr (t < kFwdRun) {
    if (!guard || k0 + t < Kp) {
      conv_tap<t>(w4, xp, k0 + t, acc, ring, cur, wv, nx);
      conv_taps<t + 1>(w4, xp, k0, Kp, guard, acc, ring, cur, wv, nx);
    }
  }
}

// acc[j][f] = sum over k < Kp of xs[s + j + k] * w[k][fl * kTileF + f]
// (ws in ws_index's layout), for j < kFwdRun and f < kTileF, each one
// chain in k order: the taps in blocks of kFwdRun (the ring's period), the
// last guarded.  Per tap one shared load of a sample and, every
// kTapsPerLoad taps, one 16-byte load of weights.  ws is 16-byte aligned
// and holds the group past Kp; xs holds s + Kp + kFwdRun + 1 words.
__device__ __forceinline__ void conv_tile(const float* xs, const float* ws,
                                          int s, int fl, int Kp,
                                          float (&acc)[kFwdRun][kTileF]) {
#pragma unroll
  for (int j = 0; j < kFwdRun; ++j) {
#pragma unroll
    for (int f = 0; f < kTileF; ++f) acc[j][f] = 0.0f;
  }
  const float4* w4 = reinterpret_cast<const float4*>(ws) + fl;
  const float* xp = xs + s;
  float ring[kFwdRun];
#pragma unroll
  for (int i = 0; i < kFwdRun; ++i) ring[i] = xp[i];
  float4 cur, wv = w4[0];
  float nx = xp[kFwdRun];
  int k0 = 0;
  for (; k0 + kFwdRun <= Kp; k0 += kFwdRun) {
    conv_taps<0>(w4, xp, k0, Kp, false, acc, ring, cur, wv, nx);
  }
  conv_taps<0>(w4, xp, k0, Kp, true, acc, ring, cur, wv, nx);
}

// A run's max-pool state for the thread's kTileF filters: in the current
// pooling window, the max m[f] of filter f so far and the first index
// arg[f] reaching it, q the window's conv positions seen; row the windows
// done
struct PoolState {
  float m[kTileF];
  uint32_t arg[kTileF];
  int q = 0;
  int row = 0;
};

// Max-pool the first `used` conv positions of a tile into `st`: at the end
// of each pooling window, emit(row, m, word) with byte f of word the first
// index reaching m[f] (torch's and tpukaldi's first match), kTileF filters
// a step.  A window longer than the tile continues from the tile before.
template <typename Emit>
__device__ __forceinline__ void pool_tile(
    const float (&acc)[kFwdRun][kTileF], int pool, int used, PoolState& st,
    Emit emit) {
#pragma unroll
  for (int j = 0; j < kFwdRun; ++j) {
    if (j < used) {
#pragma unroll
      for (int f = 0; f < kTileF; ++f) {
        if (st.q == 0 || acc[j][f] > st.m[f]) {
          st.m[f] = acc[j][f];
          st.arg[f] = st.q;
        }
      }
      if (++st.q == pool) {
        uint32_t word = 0;
#pragma unroll
        for (int f = 0; f < kTileF; ++f) word |= st.arg[f] << (8 * f);
        emit(st.row, st.m, word);
        st.q = 0;
        ++st.row;
      }
    }
  }
}

// By the conv threads: the runs 0 .. runs - 1 of a staged span.  Run g
// covers the conv positions g * R * pool + j, j < R * pool, and the pooled
// rows g * R + r, r < R = fwd_rows(pool), its positions kFwdRun at a time
// (once, where the pool fits in kFwdRun).  Each row below `rows` goes to
// ys[row * kFwdFilt + c] (the max) and, where ids is not null, to
// ids[row * kFwdFilt + c] (the first index reaching it), c the filter in
// the tile: a thread's kTileF filters of a row as one store each.
template <typename W>
__device__ inline void conv_pool_runs(const float* xs, const float* ws,
                                      int runs, int rows, int pool, int Kp,
                                      float* ys, uint8_t* ids) {
  using Vals = typename std::conditional<kTileF == 4, float4, float2>::type;
  using Args =
      typename std::conditional<kTileF == 4, uint32_t, uint16_t>::type;
  const int lane = threadIdx.x % 32;
  const int fl = lane % kTileLanes;
  const int R = fwd_rows(pool);
  const int width = R * pool;  // conv positions of a run
  for (int g = threadIdx.x / 32 * kTileGroups + lane / kTileLanes; g < runs;
       g += W::kRuns) {
    auto store = [&](int r, const float (&m)[kTileF], uint32_t word) {
      const int row = g * R + r;
      if (row < rows) {
        const int at = row * kTileLanes + fl;
        Vals v;
        float* vf = reinterpret_cast<float*>(&v);
#pragma unroll
        for (int f = 0; f < kTileF; ++f) vf[f] = m[f];
        reinterpret_cast<Vals*>(ys)[at] = v;
        if (ids != nullptr) {
          reinterpret_cast<Args*>(ids)[at] = static_cast<Args>(word);
        }
      }
    };
    PoolState st;
    for (int c0 = 0; c0 < width; c0 += kFwdRun) {
      float acc[kFwdRun][kTileF];
      conv_tile(xs, ws, g * width + c0, fl, Kp, acc);
      pool_tile(acc, pool, min(kFwdRun, width - c0), st, store);
    }
  }
}

// Four filters' values of one row, v[f] for filter o + f, to dst[f]: one
// 16-byte store where `vec` (O a multiple of 4 and dst 16-byte aligned),
// else only the `left` filters below O, word by word
__device__ __forceinline__ void store_quad(float* dst, const float (&v)[4],
                                           int left, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (f < left) dst[f] = v[f];
    }
  }
}

// a quad's four argmax bytes, packed in one 32-bit word, to dst: one
// store where `vec`, else byte by byte
__device__ __forceinline__ void store_quad_idx(int8_t* dst, uint32_t word,
                                               int left, bool vec) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(dst) = word;
  } else {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (f < left) dst[f] = static_cast<int8_t>(word >> (8 * f));
    }
  }
}

// The pipeline over the block's items (blockIdx.x, + gridDim.x, ...).
// epi(item, m0, rows, ys, ids, red) runs on the epilogue threads (threadIdx.x
// >= W::kConv) for each item after its conv: ys and ids hold its rows
// m0 .. m0 + rows - 1, red 2 x kLnWarps x kFwdFilt + 4 x kFwdFilt floats of
// the epilogue's own.  ids is null where `want_ids` is false.
template <typename W, typename Epi>
__device__ __forceinline__ void fwd_pipeline(const float* __restrict__ x,
                                             const float* __restrict__ w,
                                             int L, int K, int O, int M,
                                             int pool, const FwdGeom& g,
                                             bool want_ids, Epi epi) {
  extern __shared__ __align__(16) float smem[];
  const int Kp = padded_taps(K);
  const int R = fwd_rows(pool);
  const int wsz = fwd_weight_words(Kp);
  const int ysz = g.rows * kFwdFilt;
  float* ws = smem;             // 2 weight tiles
  float* xs = ws + 2 * wsz;     // 2 spans
  float* ys = xs + 2 * g.span;  // nbuf pooled-row buffers
  float* red = ys + g.nbuf * ysz;
  uint8_t* ids = reinterpret_cast<uint8_t*>(red + 2 * kLnWarps * kFwdFilt +
                                            4 * kFwdFilt);
  const bool conv = threadIdx.x < W::kConv;
  const int grid = static_cast<int>(gridDim.x);
  const int mine = (g.items - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const int step = g.nbuf == 2 ? 1 : 2;  // phases between two convs
  auto item = [&](int j) {
    return fwd_item(g, static_cast<int>(blockIdx.x + j * gridDim.x));
  };
  auto stage = [&](int j) {
    const FwdItem it = item(j);
    stage_window<W>(x + static_cast<size_t>(it.n) * L, L,
                    it.rb * g.rows * pool, g.span, xs + (j & 1) * g.span);
    stage_filters<W>(w, K, O, it.tile * kFwdFilt, Kp, ws + (j & 1) * wsz);
    cp_async_commit();
  };
  if (conv && mine > 0) {
    stage(0);
    cp_async_wait<0>();
  }
  __syncthreads();
  const int phases = mine > 0 ? (mine - 1) * step + 2 : 0;
  for (int p = 0; p < phases; ++p) {
    if (conv) {
      const int j = p / step;
      if (p % step == 0 && j < mine) {
        if (j + 1 < mine) stage(j + 1);
        const int rows = min(g.rows, M - item(j).rb * g.rows);
        conv_pool_runs<W>(xs + (j & 1) * g.span, ws + (j & 1) * wsz,
                          (rows + R - 1) / R, rows, pool, Kp,
                          ys + (j % g.nbuf) * ysz,
                          want_ids ? ids + (j % g.nbuf) * ysz : nullptr);
        cp_async_wait<0>();
      }
    } else if (p >= 1 && (p - 1) % step == 0) {
      const int j = (p - 1) / step;
      const FwdItem it = item(j);
      const int m0 = it.rb * g.rows;
      epi(it, m0, min(g.rows, M - m0), ys + (j % g.nbuf) * ysz,
          want_ids ? ids + (j % g.nbuf) * ysz : nullptr, red);
    }
    __syncthreads();
  }
}

// The grid: what the card holds at once (persistent), at most an item a
// block; 0 if the runtime refuses the shared memory.  The SM count and the
// blocks an SM holds are asked of the runtime once per device, kernel and
// shared size (the kernel's limit raised to kMaxSmem first), not at every
// launch.
template <typename W, typename Kernel>
inline int fwd_grid(Kernel kernel, const FwdGeom& g, size_t smem,
                    int* per_sm) {
  *per_sm = 0;
  const int sms = sm_count();
  int fit = 0;
  if (sms == 0 || allow_smem(kernel) != cudaSuccess ||
      device_cached(
          std::make_pair(reinterpret_cast<const void*>(kernel), smem),
          [&](int, int* v) {
            return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                v, kernel, W::kThreads, smem);
          },
          &fit) != cudaSuccess) {
    return 0;
  }
  *per_sm = fit;
  if (*per_sm == 0) return 0;
  return kPersistent ? min(g.items, sms * *per_sm) : g.items;
}

}  // namespace tpk
