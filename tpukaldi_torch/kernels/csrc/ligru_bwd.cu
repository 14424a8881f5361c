// Li-GRU backward recurrence for Hopper (sm_90a), float32.
//
// Replaces tpukaldi/kernels/ligru.py::_ligru_bwd_kernel (the Pallas
// backward, launched from _ligru_pallas_bwd_impl).  Given the forward's
// inputs ff (T, B, 2H), U = [Uh | Uz] (H, 2H), mask (B, H), its output h
// (T, B, H) and the gradient g of h (T, B, H), it returns
//
//     dff (T, B, 2H)   dA_t = [da_h | da_z] of every step
//     dU  (H, 2H)      sum over t, b of h_prev[t, b]^T dA[t, b]
//     dmask (B, H)     sum over t of dhc * relu(a_h)
//
// walking time backwards with h_prev[t] = h[t - 1] (zeros at t = 0):
//
//     a_h  = ff_h + h_prev @ Uh,  z = sigmoid(ff_z + h_prev @ Uz)
//     gh   = g[t] + dh                        dh carried from step t + 1
//     da_z = gh * (h_prev - relu(a_h) * m) * z * (1 - z)
//     dhc  = gh * (1 - z),  da_h = dhc * m * [a_h > 0]
//     dh   = gh * z + dA @ U^T                dh of step t - 1
//
// All tensors are float32 and contiguous.  U also arrives packed by the
// wrapper (kernels/ligru.py::_pack_bwd), once per call, as upk (P, H, ld):
// CTA q's block holds, for each k < H, the pairs (Uh[j, k], Uz[j, k]) of
// its units j = q u, ..., q u + u - 1 side by side, two units to a 16-byte
// word, then zeros up to ld = row_floats(u) floats: K1f's operand
// (ligru_fwd.cu) built from U's rows instead of its columns.  Every step of
// T runs (the Pallas kernel pads T to its time block and runs the padded
// steps first, which adds nothing).
//
// Design: K2b's three launches (lstm_bwd.cu) on K1f's grid.
// 1. The gate remat, off the chain: nothing in [a_h | a_z] = ff + h_prev @ U
//    depends on the dh chain, so one parallel tiled float32 pass
//    (lstm_remat.cuh::remat_tile, K2b's and K3b's tiling) forms it for all
//    T * B rows and writes a_h as it is (the chain needs its sign and its
//    relu) and z = sigmoid(a_z) into dff.  The chain overwrites them in
//    place with dA: each element is read and then rewritten by the same
//    thread, so no (T, B, 2H) buffer is added.  Each output is one fmaf
//    chain over k in ascending order from 0, then ff added, so a_h and z
//    agree with K1f's (a sum per depth slice, then across slices) and the
//    plain version's to the sum order: relu's [a_h > 0] flips only where
//    a_h is within that of 0.
// 2. The dh chain, one persistent cooperative launch on K1f's grid: P CTAs,
//    CTA q owning u consecutive hidden units (K1f's u: the smallest even u
//    with P = ceil(H / u) <= the SM count; u = 6, P = 92 at H = 550; u = 8,
//    P = 128 at H = 1024; the last CTA may own fewer).  A grid the card
//    cannot hold at once is refused, not run.  CTA q keeps its units' rows
//    of [Uh | Uz] in shared memory for all T steps (26 KB at H = 550), the
//    transposed operand in K1f's pair layout, so that dh of its own units
//    needs no partial sum from any other CTA.  Per reverse step t:
//    (a) unless t = T - 1 (dA of step T is zero), it streams dA of step
//        t + 1 for all H units and the pass's rows from the global
//        ping-pong buffer dabuf[(t + 1) & 1][b][2k + (0: da_h, 1: da_z)]
//        (persist_grid.cuh), in chunks of up to 256 units' pairs,
//        double-buffered with cp.async.cg (L2 only, so no stale L1 line is
//        read), and forms its share of dA @ U^T on K1f's tiling: a thread
//        owns 4 batch rows (m / 4 apart) x one 16-byte word of the slice
//        rows, two units' (uh, uz) pairs; per word of dA (two k) it loads
//        4 float4 of dA and 2 of U and runs 32 fmaf.  Where tiles are
//        fewer than the 256 threads (12 at B' = 16, u = 6), the depth is
//        split too, and the slices' partial sums meet in shared memory;
//    (b) the cell: one thread per (batch row b, owned unit j) adds gh z of
//        the step before (kept in a register) and the slices' sums in
//        ascending order to g[t]: gh.  It reads a_h and z from dff[t] and
//        h_prev, g[t] (loaded when the step starts, in flight while dA is
//        staged and multiplied), forms dA and writes it to dabuf[t & 1];
//        dmask accumulates in a register;
//    (c) one grid barrier; the CTA writes dA to dff[t], which no other CTA
//        reads, between its arrival and its wait.
//    One barrier a step is enough: step t writes dabuf[t & 1], which
//    step t + 1 read, and every CTA's reads of step t + 1 end before it
//    arrives at step t + 1's barrier (K1f's argument for its hbuf).  A pass
//    holds at most 128 batch rows (and at most 1024 / u, so that a thread
//    holds at most 4 cells); more rows run as further passes in the same
//    launch, each from dh = 0, on their own rows of dabuf, so a pass's last
//    step needs no barrier.
// 3. dU = h_prev^T dff over the T * B rows: the deterministic tiled pass of
//    du_tile.cuh.
// Every sum runs in a fixed order (no float atomics), so two calls on the
// same inputs give the same bits.
//
// What bounds it.  The one-CTA-per-row design this replaces ran B CTAs
// (16 of 132 SMs at the training batch) and re-read U and U^T from L2
// every step (16 H^2 bytes per CTA per step).  Here U stays in shared
// memory, the remat and dU are two parallel GEMM passes (2 T B H 2H flops
// each), and a step of the chain costs the stream of dA (B x 2H floats a
// CTA: 70 KB at B = 16, H = 550, twice K1f's h), its share of the product
// (B x u x 2H fmaf: 106 K at B = 16, u = 6, K1f's count), the cell and one
// grid barrier.

#include <cuda_runtime.h>

#include "du_tile.cuh"
#include "lstm_remat.cuh"
#include "persist_grid.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // as K1f's limit
constexpr int kThreads = 256;
constexpr int kRows = 4;            // batch rows of a thread's tile
constexpr int kMaxRows = 128;       // batch rows of one pass
constexpr int kMaxUnits = 16;       // hidden units one CTA may own
constexpr int kMaxPos = 4;          // cells a thread holds: (b, j) pairs
constexpr int kMaxChunk = 256;      // units' dA pairs staged at a time
// partial sums in shared memory: slices x rows x the 2 units of a word, at
// most one float2 per thread of each of its tile's rows
constexpr int kPartialFloats = kThreads * kRows * 2;

// error code for a grid that cannot be resident at once
constexpr int kErrNotResident = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr int round_rows(int x) {
  return (x + kRows - 1) / kRows * kRows;
}

// 16-byte words of a row's u (uh, uz) pairs, two units a word
__host__ __device__ constexpr int pair_words(int u) { return (u + 1) / 2; }
// a row's floats: the pairs' words, padded to an odd number of words
__host__ __device__ constexpr int row_floats(int u) {
  return 4 * (pair_words(u) | 1);
}
// a row length of x floats padded to an odd number of 16-byte words, so
// that 8 rows read at one column fall in 8 distinct groups of 4 banks
__host__ __device__ constexpr int odd_words(int x) {
  return (x / 4) % 2 ? x : x + 4;
}

// out[r, c] = ff[r, c] + (h_prev @ u)[r, c] for c < H (a_h, as it is) and
// sigmoid of it for H <= c < 2H (z); h is (R - shift, H), u (H, 2H), ff
// and out (R, 2H).
__global__ void __launch_bounds__(tpk::kRematThreads, 2)
ligru_remat_kernel(const float* __restrict__ h, int shift,
                   const float* __restrict__ u, const float* __restrict__ ff,
                   float* __restrict__ out, int R, int H) {
  __shared__ __align__(16) float a_tile[tpk::kRematDepth][tpk::kRematALd];
  __shared__ __align__(16) float b_tile[tpk::kRematDepth][tpk::kRematBLd];
  const int N = 2 * H;
  const int r0 = blockIdx.y * tpk::kRematRows;
  const int c0 = blockIdx.x * tpk::kRematCols;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][4];
  tpk::remat_tile(h, shift, u, N, R, H, a_tile, b_tile, acc);

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
      out[at] = c < H ? a : tpk::remat_sigmoid(a);
    }
  }
}

struct Params {
  const float* h;
  const float* g;
  const float* upk;
  const float* mask;
  float* dff;     // in: [a_h | z]; out: dA
  float* dmask;
  float* dabuf;   // [2][bp][2 kp]: dA as (da_h, da_z) pairs
  unsigned* bar;  // grid barrier's arrival counter, zero at launch
  int T, B, H;
  int u;     // hidden units a CTA owns (the last CTA may own fewer)
  int kp;    // H padded to 4: U's rows in shared memory, dabuf's pairs a row
  int bp;    // B padded to kRows: dabuf's rows
  int rows;  // batch rows of a pass
  int mmax;  // rows of the largest pass, padded to kRows
  int kc;    // units' dA pairs staged at a time (a multiple of 4)
};

struct Plan {
  int u, ctas, kp, bp, rows, mmax, kc;
  size_t smem;
};

// U's slice, the two staged dA chunks, and the partial sums
inline size_t smem_bytes(int kp, int u, int mmax, int kc) {
  const size_t u_floats = static_cast<size_t>(kp) * row_floats(u);
  const size_t d_floats = 2 * static_cast<size_t>(mmax) * odd_words(2 * kc);
  return (u_floats + d_floats + kPartialFloats) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1)
ligru_bwd_seq_kernel(const Params p) {
  const int H = p.H, kp = p.kp, kc = p.kc;
  const int unit0 = blockIdx.x * p.u;
  const int up = min(p.u, H - unit0);  // units this CTA owns
  const int nw = pair_words(up);       // words of the product
  const int tid = threadIdx.x;
  const int ld = row_floats(p.u);
  const int dl = 2 * kp;               // dabuf's row
  const int ds_ld = odd_words(2 * kc);
  const size_t two_h = 2 * static_cast<size_t>(H);

  float* us = reinterpret_cast<float*>(tpk::dynamic_smem());  // kp x ld
  float* ds = us + static_cast<size_t>(kp) * ld;  // 2 x mmax x ds_ld
  float* gs = ds + 2 * static_cast<size_t>(p.mmax) * ds_ld;  // partial sums

  // U's slice: the block's H rows are one contiguous run of upk; the rows
  // up to kp are zeros
  for (int i = H * ld + tid; i < kp * ld; i += kThreads) us[i] = 0.0f;
  const float* blk = p.upk + static_cast<size_t>(blockIdx.x) * H * ld;
  for (int i = tid; i < H * ld / 4; i += kThreads) {
    tpk::cp_async16_cg(us + 4 * i, blk + 4 * static_cast<size_t>(i));
  }
  tpk::cp_async_commit();
  tpk::cp_async_wait<0>();
  __syncthreads();

  const size_t buf_elems = static_cast<size_t>(p.bp) * dl;
  const int nchunks = (kp + kc - 1) / kc;
  unsigned arrived = 0;  // the barrier counter's value at the last barrier

  for (int b0 = 0; b0 < p.B; b0 += p.rows) {
    const int rows = min(p.rows, p.B - b0);
    const int mp = round_rows(rows);
    // tiles of kRows rows x one word; slices of the depth where tiles are few
    const int tr_n = mp / kRows;
    const int ntile = tr_n * nw;
    const int S = max(1, kThreads / ntile);
    const bool active = tid < ntile * S;
    const int s_thr = tid / ntile;
    const int tile = tid - s_thr * ntile;
    const int tr = tile / nw;
    const int tw = tile - tr * nw;
    const int npos = rows * up;
    const size_t slice_ld = static_cast<size_t>(mp) * 2 * nw;  // one slice

    float m[kMaxPos], gz[kMaxPos], dm[kMaxPos];
#pragma unroll
    for (int i = 0; i < kMaxPos; ++i) {
      const int q = tid + i * kThreads;
      m[i] = 0.0f;
      gz[i] = 0.0f;
      dm[i] = 0.0f;
      if (q < npos) {
        const int b = q / up;
        m[i] = p.mask[static_cast<size_t>(b0 + b) * H + unit0 + q - b * up];
      }
    }

    for (int t = p.T - 1; t >= 0; --t) {
      const float* src =
          p.dabuf + ((t + 1) & 1) * buf_elems + static_cast<size_t>(b0) * dl;
      float* dst = p.dabuf + (t & 1) * buf_elems + static_cast<size_t>(b0) * dl;

      // stage the pairs of units [ch * kc, ch * kc + width) of the pass's rows
      auto stage = [&](int ch) {
        const int c0 = 2 * ch * kc;
        const int per_row = min(2 * kc, dl - c0) / 4;
        float* buf = ds + (ch & 1) * static_cast<size_t>(p.mmax) * ds_ld;
        for (int i = tid; i < mp * per_row; i += kThreads) {
          const int r = i / per_row;
          const int v = (i - r * per_row) * 4;
          tpk::cp_async16_cg(buf + r * ds_ld + v,
                             src + static_cast<size_t>(r) * dl + c0 + v);
        }
        tpk::cp_async_commit();
      };
      const bool product = t + 1 < p.T;
      if (product) stage(0);

      // this step's a_h, z, h_prev and g, in flight while dA is staged and
      // multiplied
      float av[kMaxPos], zv[kMaxPos], hp[kMaxPos], gv[kMaxPos];
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const int j = unit0 + q - b * up;
          const size_t row = static_cast<size_t>(t) * p.B + b0 + b;
          av[i] = p.dff[row * two_h + j];
          zv[i] = p.dff[row * two_h + H + j];
          hp[i] = t > 0 ? p.h[(row - p.B) * H + j] : 0.0f;
          gv[i] = p.g[row * H + j];
        }
      }

      if (product) {
        // acc[i] = (unit 2 tw, unit 2 tw + 1) of the even k, then of the odd
        float acc[kRows][4];
#pragma unroll
        for (int x = 0; x < kRows * 4; ++x) acc[x / 4][x % 4] = 0.0f;
        for (int ch = 0; ch < nchunks; ++ch) {
          if (ch + 1 < nchunks) {
            stage(ch + 1);
            tpk::cp_async_wait<1>();
          } else {
            tpk::cp_async_wait<0>();
          }
          __syncthreads();
          if (active) {
            const float* dc = ds + (ch & 1) * static_cast<size_t>(p.mmax) * ds_ld
                              + tr * ds_ld;
            const float* uc = us + static_cast<size_t>(ch) * kc * ld + 4 * tw;
            const int ksteps = min(2 * kc, dl - 2 * ch * kc) / 4;  // two k each
            for (int kk = s_thr; kk < ksteps; kk += S) {
              float4 dr[kRows];
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
                dr[i] = *reinterpret_cast<const float4*>(
                    dc + static_cast<size_t>(i) * tr_n * ds_ld + 4 * kk);
              }
              const float4 u0 = *reinterpret_cast<const float4*>(
                  uc + static_cast<size_t>(2 * kk) * ld);
              const float4 u1 = *reinterpret_cast<const float4*>(
                  uc + static_cast<size_t>(2 * kk + 1) * ld);
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
                acc[i][0] = fmaf(dr[i].x, u0.x, acc[i][0]);
                acc[i][0] = fmaf(dr[i].y, u0.y, acc[i][0]);
                acc[i][1] = fmaf(dr[i].x, u0.z, acc[i][1]);
                acc[i][1] = fmaf(dr[i].y, u0.w, acc[i][1]);
                acc[i][2] = fmaf(dr[i].z, u1.x, acc[i][2]);
                acc[i][2] = fmaf(dr[i].w, u1.y, acc[i][2]);
                acc[i][3] = fmaf(dr[i].z, u1.z, acc[i][3]);
                acc[i][3] = fmaf(dr[i].w, u1.w, acc[i][3]);
              }
            }
          }
          __syncthreads();  // the buffer is staged again two chunks on
        }
        // the partial sums: gs[s][row][unit of the CTA]
        if (active) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            float* o = gs + (static_cast<size_t>(s_thr) * mp + tr + i * tr_n) * 2 * nw
                       + 2 * tw;
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[i][0] + acc[i][2], acc[i][1] + acc[i][3]);
          }
        }
        __syncthreads();
      }

      // the cell: dA of (b, j) into dabuf now, into dff after the arrival
      float dah[kMaxPos], daz[kMaxPos];
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const int jj = q - b * up;
          float dh = 0.0f;
          if (product) {
            const float* x = gs + b * 2 * nw + jj;
            dh = x[0];
            for (int s = 1; s < S; ++s) dh += x[s * slice_ld];
          }
          const float gh = gv[i] + (gz[i] + dh);
          const float zt = zv[i];
          const float relu_ah = fmaxf(av[i], 0.0f);
          daz[i] = gh * (hp[i] - relu_ah * m[i]) * zt * (1.0f - zt);
          const float dhc = gh * (1.0f - zt);
          dah[i] = av[i] > 0.0f ? dhc * m[i] : 0.0f;
          dm[i] = fmaf(dhc, relu_ah, dm[i]);
          gz[i] = gh * zt;
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(b) * dl
                                     + 2 * (unit0 + jj)) =
              make_float2(dah[i], daz[i]);
        }
      }
      // the other CTAs read only dabuf: arrive, then write dff while they
      // catch up
      if (t > 0) tpk::grid_arrive(p.bar);
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          float* d = p.dff + (static_cast<size_t>(t) * p.B + b0 + b) * two_h
                     + unit0 + q - b * up;
          d[0] = dah[i];
          d[H] = daz[i];
        }
      }
      if (t > 0) {
        arrived += gridDim.x;
        tpk::grid_wait(p.bar, arrived);
      }
    }

#pragma unroll
    for (int i = 0; i < kMaxPos; ++i) {
      const int q = tid + i * kThreads;
      if (q < npos) {
        const int b = q / up;
        p.dmask[static_cast<size_t>(b0 + b) * H + unit0 + q - b * up] = dm[i];
      }
    }
  }
}

// The chain's shape for (B, H) on the current device, and whether the card
// can hold its grid at once; returns a CUDA error code (0: fits).
int make_plan(int B, int H, Plan* pl) {
  if (B <= 0 || H <= 0 || H > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int u = (H + sms - 1) / sms;
  u += u % 2;  // even, as K1f's: no zero pair in the last word of a row
  if (u > kMaxUnits) return kErrNotResident;
  pl->u = u;
  pl->ctas = (H + u - 1) / u;
  pl->kp = round4(H);
  pl->bp = round_rows(B);
  // a pass's rows: at most kMaxPos cells a thread
  const int cap = kMaxRows < kMaxPos * kThreads / u / kRows * kRows
                      ? kMaxRows : kMaxPos * kThreads / u / kRows * kRows;
  pl->rows = B < cap ? B : cap;
  pl->mmax = round_rows(pl->rows);
  pl->kc = pl->kp < kMaxChunk ? pl->kp : kMaxChunk;
  while (smem_bytes(pl->kp, u, pl->mmax, pl->kc) > static_cast<size_t>(optin) &&
         pl->kc > 8) {
    pl->kc = round4(pl->kc / 2);
  }
  pl->smem = smem_bytes(pl->kp, u, pl->mmax, pl->kc);
  if (pl->smem > static_cast<size_t>(optin)) return kErrNotResident;
  err = cudaFuncSetAttribute(ligru_bwd_seq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl->smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ligru_bwd_seq_kernel, kThreads, pl->smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < pl->ctas) return kErrNotResident;
  return 0;
}

}  // namespace

extern "C" int tpk_ligru_bwd_max_hidden() { return kMaxHidden; }

// out[0..5] = (CTAs, units a CTA, shared-memory bytes a CTA, units' dA
// pairs staged at a time, floats of a packed U row, floats of the dabuf
// scratch) of the chain for (B, H); returns make_plan's code.
extern "C" int tpk_ligru_bwd_plan(int B, int H, int* out) {
  Plan pl;
  const int err = make_plan(B, H, &pl);
  if (err == 0) {
    out[0] = pl.ctas;
    out[1] = pl.u;
    out[2] = static_cast<int>(pl.smem);
    out[3] = pl.kc;
    out[4] = row_floats(pl.u);
    out[5] = 2 * pl.bp * 2 * pl.kp;
  }
  cudaGetLastError();  // a failed query leaves nothing behind
  return err;
}

// Launches the three passes on `stream` and returns the first error: a grid
// the card cannot hold at once (cudaErrorCooperativeLaunchTooLarge), a U
// packed for another number of units a CTA than the plan's
// (cudaErrorInvalidValue), both before anything runs, or what a launch
// reports (a refused launch never runs, and only this value reports it).
// upk is (P, H, row_floats(units)) float32 as the header states; dabuf
// holds the plan's floats (tpk_ligru_bwd_plan, out[5]), zeroed by the
// caller (its padding pairs meet U's zero rows); bar is one unsigned word,
// zeroed by the caller.
extern "C" int tpk_ligru_bwd(const float* ff, const float* h, const float* g,
                             const float* u, const float* upk,
                             const float* mask, float* dff, float* du,
                             float* dmask, float* dabuf, void* bar, int T,
                             int B, int H, int units, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int err = make_plan(B, H, &pl);
  if (err == 0 && units != pl.u) err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  const int R = T * B;
  ligru_remat_kernel<<<dim3((2 * H + tpk::kRematCols - 1) / tpk::kRematCols,
                            (R + tpk::kRematRows - 1) / tpk::kRematRows),
                       tpk::kRematThreads, 0, stream>>>(h, B, u, ff, dff, R, H);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  Params prm{h, g, upk, mask, dff, dmask, dabuf, static_cast<unsigned*>(bar),
             T, B, H, pl.u, pl.kp, pl.bp, pl.rows, pl.mmax, pl.kc};
  void* args[] = {&prm};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      ligru_bwd_seq_kernel, dim3(pl.ctas), dim3(kThreads), args, pl.smem, stream);
  const cudaError_t last = cudaGetLastError();
  err = static_cast<int>(launched != cudaSuccess ? launched : last);
  if (err != 0) return err;
  return static_cast<int>(
      tpk::launch_du(h, B, dff, 2 * H, 0, 2 * H, du, R, H, stream));
}
