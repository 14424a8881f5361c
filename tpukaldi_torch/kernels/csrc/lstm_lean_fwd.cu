// LSTM forward recurrence with a bf16 recurrent weight, for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/lstm.py::_lstm_lean_kernel (the Pallas forward
// of the "lean" LSTM, launched from _lstm_lean_fwd_impl), the QLSTM's
// recurrence.  For every batch row b it runs
//
//     r  = bf16(h) @ bf16(U)           U = [Uf | Ui | Uo | Uc], (H, 4H)
//     f, i, o = sigmoid(ff_{f,i,o} + r_{f,i,o}),  cand = tanh(ff_c + r_c)
//     c  = i * cand * mask[b] + f * c
//     h  = o * tanh(c)                 h_0 = c_0 = 0
//
// with exact products and float32 sums, and writes h and c for every step
// in float32: h stays float32 and is rounded to bf16 only as the product's
// operand.  ff (T, B, 4H) is float32, or bf16 through the bf16 entry (the
// bf16 compute mode: tpukaldi's kernel reads ff in its native dtype and
// widens it as it loads it, load_ff here, so h and c are the float32
// entry's on the widened ff bit for bit); mask (B, H), h and c (T, B, H)
// are float32; U
// arrives packed as upk (H, H, 4) bf16, upk[k, j, g] = U[k, gH + j], made
// once per call by the wrapper.  Every step of T runs (the Pallas kernel
// pads T to its time block; the padding sits at the end of time, so the
// outputs are the same).
//
// Design: one persistent cooperative launch, as the Pallas kernel keeps U
// resident in VMEM and forms each step's gates as one bf16 MXU product.
// - Grid.  P CTAs, at most one per SM: CTA p owns u consecutive hidden
//   units and their 4u gate columns, u the smallest even number with
//   P = ceil(H / u) <= the SM count (H = 1024 on an H100: u = 8, P = 128).
//   A grid the card cannot hold at once is refused, not run.
// - U stays in shared memory for all T steps: each CTA copies its slice of
//   upk once with cp.async, H rows of 8u bytes (64 KB at H = 1024; 80 KB
//   with each row padded by 16 bytes against bank conflicts), zero-padded
//   to a multiple of 16 rows and 16 columns.  Past what shared memory
//   holds (H = 2048, u = 16: 288 KB), a CTA keeps its first k_res rows
//   resident (1,024 at B' = 16, 768 at 64 rows) and streams the rest with
//   h's chunks, 128 rows a chunk, into the same skewed ldmatrix layout
//   (u_stream.cuh): 16.8 MB of U a step over the grid, 17.6 us a step at
//   (T, B, H) = (778, 16, 2048) on an H100 at 700 W
//   (tpukaldi_torch/tools/recurrence_envelope.py).  Where the slice fits
//   (every H <= 1024; 1036 and 1536 too), the resident design runs as
//   before, bit for bit.  H <= 2048 keeps u <= 16 on 132 SMs.
// - h is exchanged through hbuf[2][Bp][Hp] in global memory (bf16, B and H
//   padded to 16, zeroed by the wrapper; persist_grid.cuh): each step
//   every CTA streams the whole bf16 h_{t-1} through shared memory in
//   K-chunks of up to 512 columns, double-buffered with cp.async.cg (L2
//   only, so no stale L1 line is read), and writes the bf16 operands of its
//   own units' h_t into the other buffer; one grid barrier ends the step.
// - The product runs on the tensor cores: ldmatrix and mma.sync.m16n8k16
//   (mma_bf16.cuh), bf16 operands, float32 accumulators; rows the batch
//   rows (padded to 16), columns the CTA's gate columns, depth H.  A warp
//   owns a 32 x 32 tile (2 x 2 fragments, so each loaded fragment feeds
//   two products); where there are fewer such tiles than the 8 warps, the
//   depth is split across warps too.  Each warp sums its k-steps in
//   ascending order and the cell adds the warps' partial sums in a fixed
//   order, so two calls on the same inputs give the same bits.
// - The cell: one thread per (batch row, owned unit) adds ff (loaded into
//   registers when the step starts, in flight while h is staged and
//   multiplied), applies tpukaldi's gate functions (lstm_lean_cell.cuh),
//   carries c in a register and writes the bf16
//   operand of h to hbuf; the CTA then arrives at the barrier and writes h
//   and c (float32), which no other CTA reads, while the others catch up.
//   A pass holds at most 128 batch rows (c in registers); more rows run as
//   further passes in the same launch, each from h_0 = c_0 = 0.
//
// What bounds it.  Per step each CTA reads the whole bf16 h from L2,
// P x Bp x H x 2 bytes across the grid (16.8 MB at B = 64, H = 1024), and
// waits once at the grid barrier, whose arrivals and acquire round trips
// through L2 take microseconds; its own product (64 x 32 x 1024 at that
// shape) takes about one.  So the step is paced by that h broadcast, the
// barrier and the cell's latency, not by U: the 8 MB of U that the
// one-CTA-per-row design re-read from L2 every step stays in shared memory.
// The float32 sums run in the tensor cores' order and then across warps,
// so the gates agree with K4b's remat (lstm_lean_bwd.cu), which sums the
// same products in another order, to the sum order, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "lstm_lean_cell.cuh"
#include "mma_bf16.cuh"
#include "persist_grid.cuh"
#include "u_stream.cuh"

namespace {

constexpr int kMaxHidden = 2048;  // K4b's is 1024
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;   // batch rows of one pass
constexpr int kMaxUnits = 16;   // hidden units one CTA may own
constexpr int kMaxPos = kMaxRows * kMaxUnits / kThreads;  // (b, j) a thread
// partial sums in shared memory: one slot of (rows x 4u) floats per depth
// split, at most a 32 x 32 warp tile per warp
constexpr int kPartialFloats = kWarps * 32 * 32;
constexpr int kMaxChunk = 512;  // h columns staged at a time
// bf16 padding of a row of U and of staged h in shared memory: 16 bytes,
// so the 8 rows of an ldmatrix fall in distinct banks
constexpr int kSkew = 8;

// error code for a grid that cannot be resident at once
constexpr int kErrNotResident = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// FF the element type of ff: float, or __nv_bfloat16 for the bf16 entry
template <typename FF>
struct Params {
  const FF* ff;
  const __nv_bfloat16* upk;
  const float* mask;
  float* h_out;
  float* c_out;
  __nv_bfloat16* hbuf;  // [2][bp][kp]
  unsigned* bar;        // grid barrier's arrival counter, zero at launch
  int T, B, H;
  int u;     // hidden units a CTA owns (the last CTA may own fewer)
  int kp;    // H padded to 16: U's rows and hbuf's row length
  int np;    // 4u padded to 16: U's columns in shared memory
  int bp;    // B padded to 16: hbuf's rows
  int mmax;  // rows of the largest pass, padded to 16
  int kc;    // h columns staged at a time (a multiple of 16)
  int kres;  // U's rows resident: kp, or whole chunks (the rest streamed)
};

struct Plan {
  int u, ctas, kp, np, bp, mmax, kc;
  int k_res;  // U's rows a CTA keeps resident (kp: all, the resident design)
  size_t smem;
};

// U's resident rows, the two staged h chunks, the partial sums and, where
// U's slice is streamed, its two staged chunks
inline size_t smem_bytes(int res_rows, int np, int mmax, int kc, bool stream) {
  const size_t u_bytes =
      static_cast<size_t>(res_rows + (stream ? 2 * kc : 0)) * (np + kSkew) * 2;
  const size_t h_bytes = 2 * static_cast<size_t>(mmax) * (kc + kSkew) * 2;
  return u_bytes + h_bytes + static_cast<size_t>(kPartialFloats) * 4;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename FF>
__device__ __forceinline__ void load_ff(const Params<FF>& p, int t, int row,
                                        int j, float* v) {
  const FF* f = p.ff + (static_cast<size_t>(t) * p.B + row) * 4 * p.H + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) v[g] = widen(f[static_cast<size_t>(g) * p.H]);
}

// U's rows from kres on, if any, are streamed a chunk at a time
// (u_stream.cuh)
template <typename FF>
__global__ void __launch_bounds__(kThreads, 1)
lstm_lean_fwd_kernel(const Params<FF> p) {
  const int H = p.H, kp = p.kp, np = p.np, kc = p.kc;
  const int unit0 = blockIdx.x * p.u;
  const int up = min(p.u, H - unit0);  // units this CTA owns
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int us_ld = np + kSkew;
  const int hs_ld = kc + kSkew;

  // U's resident rows: kp, or whole chunks where the rest is streamed
  const int kr = p.kres;
  unsigned char* smem = tpk::dynamic_smem();
  __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(smem);  // kr x us_ld
  __nv_bfloat16* hs = us + static_cast<size_t>(kr) * us_ld;  // 2 x mmax x hs_ld
  float* gs = reinterpret_cast<float*>(hs + 2 * static_cast<size_t>(p.mmax) * hs_ld);
  // 2 x kc x us_ld streamed chunks of U
  __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(gs + kPartialFloats);
  // the CTA's columns of row k: upk + (k H + unit0) 4 bf16
  const __nv_bfloat16* blk = p.upk + static_cast<size_t>(unit0) * 4;

  // U's slice: zero the padding, then the real rows of 8 * up bytes (a
  // streamed slice's resident rows are all below H), two units (16 bytes)
  // a copy where H is even (then every piece is 16-byte aligned), one unit
  // (8 bytes) otherwise
  for (int i = tid; i < kr * us_ld; i += kThreads) us[i] = __float2bfloat16_rn(0.0f);
  __syncthreads();
  const int vec = (H % 2 == 0) ? 2 : 1;
  const int pieces = up / vec;
  for (int i = tid; i < min(H, kr) * pieces; i += kThreads) {
    const int k = i / pieces;
    const int v = (i - k * pieces) * vec;
    const __nv_bfloat16* src = p.upk + (static_cast<size_t>(k) * H + unit0 + v) * 4;
    __nv_bfloat16* dst = us + static_cast<size_t>(k) * us_ld + v * 4;
    if (vec == 2) {
      tpk::cp_async16_cg(dst, src);
    } else {
      tpk::cp_async8(dst, src);
    }
  }
  tpk::cp_async_commit();
  tpk::cp_async_wait<0>();
  __syncthreads();

  const size_t buf_elems = static_cast<size_t>(p.bp) * kp;
  const int nt = np / 16;
  const int nchunks = (kp + kc - 1) / kc;
  unsigned arrived = 0;  // the barrier counter's value at the last barrier

  for (int b0 = 0; b0 < p.B; b0 += kMaxRows) {
    const int rows = min(kMaxRows, p.B - b0);
    const int mp = round16(rows);
    // warp tiles of 2 x 2 tiles (32 rows x 32 columns; at the edges some
    // of the four tiles are absent); where there are fewer warp tiles than
    // warps, the depth is split as well: warp w takes warp tile w % groups
    // and the k-steps s, s + ks, ... with s = w / groups
    const int gn = (nt + 1) / 2;
    const int groups = (mp / 16 + 1) / 2 * gn;
    const int ks = min(max(1, kWarps / groups), kp / 16);
    const bool active = warp < groups * ks;
    const int s_warp = warp / groups;
    const int wr = (warp % groups) / gn * 32;  // the warp tile's first row
    const int wc = (warp % groups) % gn * 32;  // and first column
    const bool row1 = wr + 16 < mp;  // its second row of tiles exists
    const bool col1 = wc + 16 < np;  // its second column of tiles exists
    const int npos = rows * up;

    float c[kMaxPos], m[kMaxPos], hv[kMaxPos], fv[kMaxPos][4];
#pragma unroll
    for (int i = 0; i < kMaxPos; ++i) {
      const int q = tid + i * kThreads;
      c[i] = 0.0f;
      m[i] = 0.0f;
      if (q < npos) {
        const int b = q / up;
        const int j = unit0 + q - b * up;
        m[i] = p.mask[static_cast<size_t>(b0 + b) * H + j];
      }
    }

    for (int t = 0; t < p.T; ++t) {
      const __nv_bfloat16* src = p.hbuf + (t & 1) * buf_elems + static_cast<size_t>(b0) * kp;
      __nv_bfloat16* dst = p.hbuf + ((t + 1) & 1) * buf_elems + static_cast<size_t>(b0) * kp;

      // stage h columns [ch * kc, ch * kc + width) of the pass's rows, and
      // a streamed chunk's rows of U beside them (the columns of its units:
      // a padding column's product lands only in a column no cell reads)
      auto stage = [&](int ch) {
        const int k0 = ch * kc;
        const int per_row = min(kc, kp - k0) / 8;
        __nv_bfloat16* buf = hs + (ch & 1) * static_cast<size_t>(p.mmax) * hs_ld;
        for (int i = tid; i < mp * per_row; i += kThreads) {
          const int r = i / per_row;
          const int v = (i - r * per_row) * 8;
          tpk::cp_async16_cg(buf + r * hs_ld + v,
                             src + static_cast<size_t>(r) * kp + k0 + v);
        }
        if (k0 >= kr) {
          __nv_bfloat16* rows = ss + (ch & 1) * static_cast<size_t>(kc) * us_ld;
          const int r1 = k0 + 8 * per_row;
          if (vec == 2) {
            tpk::stage_rows<16>(rows, 2 * us_ld, blk, 8 * static_cast<size_t>(H),
                                pieces, k0, r1, H);
          } else {
            tpk::stage_rows<8>(rows, 2 * us_ld, blk, 8 * static_cast<size_t>(H),
                               pieces, k0, r1, H);
          }
        }
        tpk::cp_async_commit();
      };

      float acc[2][2][2][4];  // [row tile][column tile][8-column half]
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[x / 16][x / 8 % 2][x / 4 % 2][x % 4] = 0.0f;

      stage(0);
      // this step's ff, in flight while h is staged and multiplied
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          load_ff(p, t, b0 + b, unit0 + q - b * up, fv[i]);
        }
      }
      for (int ch = 0; ch < nchunks; ++ch) {
        if (ch + 1 < nchunks) {
          stage(ch + 1);
          tpk::cp_async_wait<1>();
        } else {
          tpk::cp_async_wait<0>();
        }
        __syncthreads();
        // lane's ldmatrix row: row lane % 16, columns (lane / 16) * 8 on
        const __nv_bfloat16* hc = hs + (ch & 1) * static_cast<size_t>(p.mmax) * hs_ld
                                  + (lane % 16) * hs_ld + (lane / 16) * 8;
        const __nv_bfloat16* uc =
            (ch * kc >= kr
                 ? ss + ((ch & 1) * static_cast<size_t>(kc) + lane % 16) * us_ld
                 : us + (static_cast<size_t>(ch) * kc + lane % 16) * us_ld)
            + (lane / 16) * 8;
        const int ksteps = min(kc, kp - ch * kc) / 16;
        if (active) {
#pragma unroll 2
          for (int kk = s_warp; kk < ksteps; kk += ks) {
            unsigned fa[2][4], fb[2][4];
            tpk::ldsm_x4(fa[0], hc + wr * hs_ld + kk * 16);
            if (row1) tpk::ldsm_x4(fa[1], hc + (wr + 16) * hs_ld + kk * 16);
            tpk::ldsm_x4_trans(fb[0], uc + kk * 16 * us_ld + wc);
            if (col1) tpk::ldsm_x4_trans(fb[1], uc + kk * 16 * us_ld + wc + 16);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if ((i == 0 || row1) && (j == 0 || col1)) {
                  tpk::mma_16816(acc[i][j][0], fa[i], fb[j][0], fb[j][1]);
                  tpk::mma_16816(acc[i][j][1], fa[i], fb[j][2], fb[j][3]);
                }
              }
            }
          }
        }
        __syncthreads();  // the buffer is staged again two chunks on
      }

      // the partial sums: gs[s][row][column], column = 4 * unit + gate
      if (active) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if ((i == 0 || row1) && (j == 0 || col1)) {
              float* g = gs + (static_cast<size_t>(s_warp) * mp + wr + 16 * i + lane / 4) * np
                         + wc + 16 * j + 2 * (lane % 4);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                g[half * 8] = acc[i][j][half][0];
                g[half * 8 + 1] = acc[i][j][half][1];
                g[8 * np + half * 8] = acc[i][j][half][2];
                g[8 * np + half * 8 + 1] = acc[i][j][half][3];
              }
            }
          }
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const int jj = q - b * up;
          const int j = unit0 + jj;
          float r[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) r[g] = gs[b * np + jj * 4 + g];
          for (int s = 1; s < ks; ++s) {
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              r[g] += gs[(static_cast<size_t>(s) * mp + b) * np + jj * 4 + g];
            }
          }
          const float f = tpk::lean_sigmoid(fv[i][0] + r[0]);
          const float ig = tpk::lean_sigmoid(fv[i][1] + r[1]);
          const float o = tpk::lean_sigmoid(fv[i][2] + r[2]);
          const float cand = tanhf(fv[i][3] + r[3]);
          c[i] = ig * cand * m[i] + f * c[i];
          hv[i] = o * tanhf(c[i]);
          dst[static_cast<size_t>(b) * kp + j] = __float2bfloat16_rn(hv[i]);
        }
      }
      // the other CTAs read only hbuf: arrive, then write h and c while
      // they catch up
      if (t + 1 < p.T) tpk::grid_arrive(p.bar);
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const size_t out = (static_cast<size_t>(t) * p.B + b0 + b) * H + unit0 + q - b * up;
          p.h_out[out] = hv[i];
          p.c_out[out] = c[i];
        }
      }
      if (t + 1 < p.T) {
        arrived += gridDim.x;
        tpk::grid_wait(p.bar, arrived);
      }
    }
  }
}

// bytes of U the grid streams a step: each CTA's rows past k_res, the 8
// bytes (4 bf16 gates) of each of its units
inline long long stream_bytes(const Plan& pl, int H) {
  return 8LL * H * (H - (pl.k_res < H ? pl.k_res : H));
}

// The launch's shape for (B, H) on the current device, and whether the
// card can hold its grid at once; returns a CUDA error code (0: fits).
// The two entries' kernels take the same shared memory and registers (the
// load widens in a register), so one plan serves both.
template <typename FF>
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
  int u = 2;
  while ((H + u - 1) / u > sms) u += 2;
  if (u > kMaxUnits) return kErrNotResident;
  pl->u = u;
  pl->ctas = (H + u - 1) / u;
  pl->kp = round16(H);
  pl->np = round16(4 * u);
  pl->bp = round16(B);
  pl->mmax = round16(B < kMaxRows ? B : kMaxRows);
  // the resident design where U's whole slice fits beside the h chunks,
  // halving them as far as 16 columns; else the streamed one (u_stream.cuh)
  pl->kc = pl->kp < kMaxChunk ? pl->kp : kMaxChunk;
  while (smem_bytes(pl->kp, pl->np, pl->mmax, pl->kc, false) >
             static_cast<size_t>(optin) &&
         pl->kc > 16) {
    pl->kc = round16(pl->kc / 2);
  }
  pl->k_res = pl->kp;
  pl->smem = smem_bytes(pl->kp, pl->np, pl->mmax, pl->kc, false);
  if (pl->smem > static_cast<size_t>(optin)) {
    const auto smem = [&](int rows, int kc) {
      return smem_bytes(rows, pl->np, pl->mmax, kc, true);
    };
    if (!tpk::stream_plan(smem, optin, 2 * static_cast<size_t>(pl->np + kSkew),
                          H, &pl->kc, &pl->k_res)) {
      return kErrNotResident;
    }
    pl->smem = smem(pl->k_res, pl->kc);
  }
  err = cudaFuncSetAttribute(lstm_lean_fwd_kernel<FF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl->smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lstm_lean_fwd_kernel<FF>, kThreads, pl->smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < pl->ctas) return kErrNotResident;
  return 0;
}

template <typename FF>
int launch(const FF* ff, const void* upk, const float* mask, float* h_out,
           float* c_out, void* hbuf, void* bar, int T, int B, int H,
           cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = make_plan<FF>(B, H, &pl);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  Params<FF> prm{ff, static_cast<const __nv_bfloat16*>(upk), mask, h_out, c_out,
                 static_cast<__nv_bfloat16*>(hbuf), static_cast<unsigned*>(bar),
                 T, B, H, pl.u, pl.kp, pl.np, pl.bp, pl.mmax, pl.kc,
                 pl.k_res};
  void* args[] = {&prm};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      lstm_lean_fwd_kernel<FF>, dim3(pl.ctas), dim3(kThreads), args, pl.smem, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace

extern "C" int tpk_lstm_lean_fwd_max_hidden() { return kMaxHidden; }
extern "C" int tpk_lstm_lean_fwd_bf16_max_hidden() { return kMaxHidden; }

// out[0..5] = (CTAs, units a CTA, shared-memory bytes a CTA, h columns
// staged at a time, U's rows a CTA keeps resident (round16(H): all), bytes
// of U the grid streams a step) of the launch for (B, H); returns
// make_plan's code.
extern "C" int tpk_lstm_lean_fwd_plan(int B, int H, int* out) {
  Plan pl;
  const int err = make_plan<float>(B, H, &pl);
  if (err == 0) {
    out[0] = pl.ctas;
    out[1] = pl.u;
    out[2] = static_cast<int>(pl.smem);
    out[3] = pl.kc;
    out[4] = pl.k_res;
    out[5] = static_cast<int>(stream_bytes(pl, H));
  }
  cudaGetLastError();  // a failed query leaves nothing behind
  return err;
}

// Launches on `stream` and returns the error: a grid the card cannot hold
// at once (cudaErrorCooperativeLaunchTooLarge), or what the cooperative
// launch reports (a refused launch never runs, and only this value reports
// it).  hbuf is [2][round16(B)][round16(H)] bf16 and bar one unsigned
// word, both zeroed by the caller.
extern "C" int tpk_lstm_lean_fwd(const float* ff, const void* upk,
                                 const float* mask, float* h_out, float* c_out,
                                 void* hbuf, void* bar, int T, int B, int H,
                                 cudaStream_t stream) {
  return launch(ff, upk, mask, h_out, c_out, hbuf, bar, T, B, H, stream);
}

// The same with ff (T, B, 4H) bf16.
extern "C" int tpk_lstm_lean_fwd_bf16(const void* ff, const void* upk,
                                      const float* mask, float* h_out,
                                      float* c_out, void* hbuf, void* bar, int T,
                                      int B, int H, cudaStream_t stream) {
  return launch(static_cast<const __nv_bfloat16*>(ff), upk, mask, h_out, c_out,
                hbuf, bar, T, B, H, stream);
}
