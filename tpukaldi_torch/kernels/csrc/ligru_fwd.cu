// Li-GRU forward recurrence for Hopper (sm_90a), float32.
//
// Replaces tpukaldi/kernels/ligru.py::_ligru_kernel (the Pallas forward,
// launched from _ligru_pallas_fwd_impl).  For every batch row b it runs
//
//     r    = h @ U                          U = [Uh | Uz], (H, 2H)
//     z_t  = sigmoid(ff[t, b, H:] + r[H:])
//     hc   = relu(ff[t, b, :H] + r[:H]) * mask[b]
//     h    = z_t * h + (1 - z_t) * hc      h_0 = 0
//
// and writes h for every step.  All tensors are float32: ff (T, B, 2H),
// mask (B, H), out (T, B, H).  U arrives packed by the wrapper
// (kernels/ligru.py::_pack), once per call, as upk (P, H, ld): CTA q's
// block holds, for each row k, the pairs (Uh[k, j], Uz[k, j]) of its units
// j = q u, ..., q u + u - 1 side by side, two units to a 16-byte word, then
// zeros up to ld = row_floats(u) floats (an odd number of words: the last
// word's second pair is zero at odd u, and so are the units past H of the
// last CTA).  Every step of T runs (the Pallas kernel pads T to its time
// block; the padding sits at the end of time, so the outputs are the same).
//
// Design: K2f's (lstm_fwd.cu), one persistent cooperative launch, with the
// liGRU's cell: one product a step, two gate columns a unit.
// - Grid.  P CTAs, at most one per SM: CTA q owns u consecutive hidden
//   units and their 2u gate columns, u the smallest even number with
//   P = ceil(H / u) <= the SM count (on an H100: u = 6, P = 92 at
//   H = 550; u = 8, P = 128 at H = 1024); the last CTA may own fewer.
//   An odd u leaves a zero pair in the last word of every row: u = 5,
//   P = 110 at H = 550 was 2% slower at B' = 64 and 5% slower at B' = 16
//   (tpukaldi_torch/tools/ligru_fwd_phases.py).  A grid the card cannot
//   hold at once is refused, not run.
// - U stays in shared memory for all T steps: each CTA copies its block of
//   upk once with cp.async, H rows of ld floats (12 at u = 6: 26 KB at
//   H = 550; 20 at u = 8: 80 KB at H = 1024), zero-padded to a multiple of
//   4 rows.  A row's odd number of words puts 8 rows read at one column in
//   8 distinct groups of 4 banks.
// - Past what shared memory holds (H = 2048, u = 16: 288 KB a slice), a
//   CTA keeps its first k_res rows resident (1,024 at B' = 16, 768 at 64
//   rows) and streams the rest with h's chunks, 128 rows a chunk
//   (u_stream.cuh): 18.9 MB of U a step over the grid at B' = 16, 23.3 us a
//   step at (T, B, H) = (778, 16, 2048) on an H100 at 700 W
//   (tpukaldi_torch/tools/recurrence_envelope.py).  Where the slice fits
//   (every H <= 1024; 1036 and 1536 too), the resident design runs as
//   before, bit for bit.  H <= 2048 keeps u <= 16 on 132 SMs.
// - h is exchanged through hbuf[2][Bp][Hp] in global memory (float32, B
//   and H padded to 4, zeroed by the wrapper; persist_grid.cuh): each step
//   every CTA streams the whole h_{t-1} through shared memory in chunks of
//   up to 256 columns, double-buffered with cp.async.cg (L2 only, so no
//   stale L1 line is read), and writes its own units' h_t into the other
//   buffer; one grid barrier ends the step.  The chunk halves until U's
//   slice, the two chunks and the partial sums fit the shared memory a
//   block may opt in to.
// - The product is float32 fmaf on the CUDA cores, as tpukaldi's kernel is
//   float32 and the port keeps TF32 off.  A thread owns a register tile of
//   4 batch rows (r, r + m/4, r + m/2, r + 3m/4 of the pass's m rows, so
//   that neighbouring threads read h rows in distinct banks) x one 16-byte
//   word of the slice rows, two units' (uh, uz) columns: per k step of 4 it
//   loads 4 float4 of h and 4 of U and runs 64 fmaf.  Where there are fewer
//   tiles than the 256 threads (at the training batch B' = 16, u = 6: 12
//   tiles), the depth is split too: slice s takes the k steps s, s + S, ...
//   Each thread sums its k steps in ascending order and the cell adds the
//   slices' partial sums in ascending order, so two calls on the same
//   inputs give the same bits.  h agrees with K1b's serial remat
//   (ligru_bwd.cu) to the sum order, not bit for bit, as K2f's does with
//   K2b's.
// - The cell: one thread per (batch row, owned unit) adds ff (its two gates
//   loaded into registers when the step starts, in flight while h is
//   staged and multiplied), applies the gates, keeps its h_{t-1} in a
//   register and writes h_t to hbuf; the CTA then arrives at the barrier
//   and writes h_t to the output, which no other CTA reads, while the
//   others catch up.  A pass holds at most 128 batch rows (and at most
//   1024 / u, so that a thread holds at most 4 cells); more rows run as
//   further passes in the same launch, each from h_0 = 0.
//
// What bounds it.  The 2.42 MB of U (H = 550) that the one-CTA-per-row
// design re-read from L2 every step, in every CTA, stays in shared memory.
// Per step each CTA reads the whole float32 h from L2 (P x B x H x 4 bytes
// across the grid, 15.5 MB at B = 64, H = 550), runs its share of the
// product (B x 2u x H fmaf: 0.42 M at B = 64, u = 6) and waits once at the
// grid barrier.

#include <cuda_runtime.h>

#include "persist_grid.cuh"
#include "u_stream.cuh"

namespace {

constexpr int kMaxHidden = 2048;  // K1b's is 1024
constexpr int kThreads = 256;
constexpr int kRows = 4;            // batch rows of a thread's tile
constexpr int kMaxRows = 128;       // batch rows of one pass
constexpr int kMaxUnits = 16;       // hidden units one CTA may own
constexpr int kMaxPos = 4;          // cells a thread holds: (b, j) pairs
constexpr int kMaxChunk = 256;      // h columns staged at a time
// partial sums in shared memory: slices x rows x 4 columns of a word, at
// most one float4 per thread of each of its tile's rows
constexpr int kPartialFloats = kThreads * kRows * 4;

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

struct Params {
  const float* ff;
  const float* upk;
  const float* mask;
  float* out;
  float* hbuf;    // [2][bp][kp]
  unsigned* bar;  // grid barrier's arrival counter, zero at launch
  int T, B, H;
  int u;     // hidden units a CTA owns (the last CTA may own fewer)
  int kp;    // H padded to 4: U's rows and hbuf's row length
  int bp;    // B padded to kRows: hbuf's rows
  int rows;  // batch rows of a pass
  int mmax;  // rows of the largest pass, padded to kRows
  int kc;    // h columns staged at a time (a multiple of 4)
  int kres;  // U's rows resident: kp, or whole chunks (the rest streamed)
};

struct Plan {
  int u, ctas, kp, bp, rows, mmax, kc;
  int k_res;  // U's rows a CTA keeps resident (kp: all, the resident design)
  size_t smem;
};

// U's resident rows, the two staged h chunks, the partial sums and, where
// U's slice is streamed, its two staged chunks
inline size_t smem_bytes(int res_rows, int u, int mmax, int kc, bool stream) {
  const size_t u_floats =
      static_cast<size_t>(res_rows + (stream ? 2 * kc : 0)) * row_floats(u);
  const size_t h_floats = 2 * static_cast<size_t>(mmax) * odd_words(kc);
  return (u_floats + h_floats + kPartialFloats) * sizeof(float);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// U's rows from kres on, if any, are streamed a chunk at a time
// (u_stream.cuh)
__global__ void __launch_bounds__(kThreads, 1)
ligru_fwd_kernel(const Params p) {
  const int H = p.H, kp = p.kp, kc = p.kc;
  const int unit0 = blockIdx.x * p.u;
  const int up = min(p.u, H - unit0);  // units this CTA owns
  const int nw = pair_words(up);       // words of the product
  const int tid = threadIdx.x;
  const int ld = row_floats(p.u);
  const int hs_ld = odd_words(kc);
  const size_t two_h = 2 * static_cast<size_t>(H);

  // U's resident rows: kp, or whole chunks where the rest is streamed
  const int kr = p.kres;
  float* us = reinterpret_cast<float*>(tpk::dynamic_smem());  // kr x ld
  float* hs = us + static_cast<size_t>(kr) * ld;  // 2 x mmax x hs_ld
  float* gs = hs + 2 * static_cast<size_t>(p.mmax) * hs_ld;  // partial sums
  float* ss = gs + kPartialFloats;  // 2 x kc x ld streamed chunks of U

  // U's slice: the block's H rows are one contiguous run of upk; the rows
  // up to kp are zeros (a streamed slice's resident rows are all below H)
  for (int i = H * ld + tid; i < kr * ld; i += kThreads) us[i] = 0.0f;
  const float* blk = p.upk + static_cast<size_t>(blockIdx.x) * H * ld;
  for (int i = tid; i < min(H, kr) * ld / 4; i += kThreads) {
    tpk::cp_async16_cg(us + 4 * i, blk + 4 * static_cast<size_t>(i));
  }
  tpk::cp_async_commit();
  tpk::cp_async_wait<0>();
  __syncthreads();

  const size_t buf_elems = static_cast<size_t>(p.bp) * kp;
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
    const size_t slice_ld = static_cast<size_t>(mp) * 4 * nw;  // one slice

    float m[kMaxPos], hv[kMaxPos], fv[kMaxPos][2];
#pragma unroll
    for (int i = 0; i < kMaxPos; ++i) {
      const int q = tid + i * kThreads;
      m[i] = 0.0f;
      hv[i] = 0.0f;
      if (q < npos) {
        const int b = q / up;
        m[i] = p.mask[static_cast<size_t>(b0 + b) * H + unit0 + q - b * up];
      }
    }

    for (int t = 0; t < p.T; ++t) {
      const float* src = p.hbuf + (t & 1) * buf_elems + static_cast<size_t>(b0) * kp;
      float* dst = p.hbuf + ((t + 1) & 1) * buf_elems + static_cast<size_t>(b0) * kp;

      // stage h columns [ch * kc, ch * kc + width) of the pass's rows, and
      // a streamed chunk's rows of U beside them
      auto stage = [&](int ch) {
        const int k0 = ch * kc;
        const int per_row = min(kc, kp - k0) / 4;
        float* buf = hs + (ch & 1) * static_cast<size_t>(p.mmax) * hs_ld;
        for (int i = tid; i < mp * per_row; i += kThreads) {
          const int r = i / per_row;
          const int v = (i - r * per_row) * 4;
          tpk::cp_async16_cg(buf + r * hs_ld + v,
                             src + static_cast<size_t>(r) * kp + k0 + v);
        }
        if (k0 >= kr) {
          tpk::stage_rows<16>(ss + (ch & 1) * static_cast<size_t>(kc) * ld,
                              4 * ld, blk, 4 * static_cast<size_t>(ld), ld / 4,
                              k0, k0 + 4 * per_row, H);
        }
        tpk::cp_async_commit();
      };

      float acc[kRows][4];
#pragma unroll
      for (int x = 0; x < kRows * 4; ++x) acc[x / 4][x % 4] = 0.0f;

      stage(0);
      // this step's two ff gates, in flight while h is staged and multiplied
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const float* f = p.ff + (static_cast<size_t>(t) * p.B + b0 + b) * two_h
                           + unit0 + q - b * up;
          fv[i][0] = f[0];
          fv[i][1] = f[H];
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
        if (active) {
          const float* hc = hs + (ch & 1) * static_cast<size_t>(p.mmax) * hs_ld
                            + tr * hs_ld;
          const float* uc =
              (ch * kc >= kr
                   ? ss + (ch & 1) * static_cast<size_t>(kc) * ld
                   : us + static_cast<size_t>(ch) * kc * ld) + 4 * tw;
          const int ksteps = min(kc, kp - ch * kc) / 4;
          for (int kk = s_thr; kk < ksteps; kk += S) {
            float4 hr[kRows], uw[4];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              hr[i] = *reinterpret_cast<const float4*>(
                  hc + static_cast<size_t>(i) * tr_n * hs_ld + 4 * kk);
            }
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              uw[d] = *reinterpret_cast<const float4*>(
                  uc + static_cast<size_t>(4 * kk + d) * ld);
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float hk[4] = {hr[i].x, hr[i].y, hr[i].z, hr[i].w};
#pragma unroll
              for (int d = 0; d < 4; ++d) {
                acc[i][0] = fmaf(hk[d], uw[d].x, acc[i][0]);
                acc[i][1] = fmaf(hk[d], uw[d].y, acc[i][1]);
                acc[i][2] = fmaf(hk[d], uw[d].z, acc[i][2]);
                acc[i][3] = fmaf(hk[d], uw[d].w, acc[i][3]);
              }
            }
          }
        }
        __syncthreads();  // the buffer is staged again two chunks on
      }

      // the partial sums: gs[s][row][2 * unit + (0: uh, 1: uz)]
      if (active) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float* g = gs + (static_cast<size_t>(s_thr) * mp + tr + i * tr_n) * 4 * nw
                     + 4 * tw;
          *reinterpret_cast<float4*>(g) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const int jj = q - b * up;
          const float* g = gs + b * 4 * nw + 2 * jj;
          float rh = g[0], rz = g[1];
          for (int s = 1; s < S; ++s) {
            rh += g[s * slice_ld];
            rz += g[s * slice_ld + 1];
          }
          const float zt = sigmoidf(fv[i][1] + rz);
          const float hc = fmaxf(fv[i][0] + rh, 0.0f) * m[i];
          hv[i] = zt * hv[i] + (1.0f - zt) * hc;
          dst[static_cast<size_t>(b) * kp + unit0 + jj] = hv[i];
        }
      }
      // the other CTAs read only hbuf: arrive, then write h while they
      // catch up
      const bool more = t + 1 < p.T;
      if (more) tpk::grid_arrive(p.bar);
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          p.out[(static_cast<size_t>(t) * p.B + b0 + b) * H + unit0 + q - b * up] =
              hv[i];
        }
      }
      if (more) {
        arrived += gridDim.x;
        tpk::grid_wait(p.bar, arrived);
      }
    }
  }
}

// bytes of U the grid streams a step: each CTA's rows past k_res, whole
// packed rows
inline long long stream_bytes(const Plan& pl, int H) {
  return static_cast<long long>(pl.ctas) * (H - (pl.k_res < H ? pl.k_res : H)) *
         row_floats(pl.u) * sizeof(float);
}

// The launch's shape for (B, H) on the current device, and whether the
// card can hold its grid at once; returns a CUDA error code (0: fits).
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
  u += u % 2;  // even: no zero pair in the last word of a row
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
  // the resident design where U's whole slice fits beside the h chunks,
  // halving them as far as 16 columns; else the streamed one (u_stream.cuh)
  pl->kc = pl->kp < kMaxChunk ? pl->kp : kMaxChunk;
  while (smem_bytes(pl->kp, u, pl->mmax, pl->kc, false) > static_cast<size_t>(optin) &&
         pl->kc > 16) {
    pl->kc = round4(pl->kc / 2);
  }
  pl->k_res = pl->kp;
  pl->smem = smem_bytes(pl->kp, u, pl->mmax, pl->kc, false);
  if (pl->smem > static_cast<size_t>(optin)) {
    const auto smem = [&](int rows, int kc) {
      return smem_bytes(rows, u, pl->mmax, kc, true);
    };
    if (!tpk::stream_plan(smem, optin, sizeof(float) * row_floats(u), H,
                          &pl->kc, &pl->k_res)) {
      return kErrNotResident;
    }
    pl->smem = smem(pl->k_res, pl->kc);
  }
  err = cudaFuncSetAttribute(ligru_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl->smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ligru_fwd_kernel, kThreads, pl->smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < pl->ctas) return kErrNotResident;
  return 0;
}

}  // namespace

extern "C" int tpk_ligru_fwd_max_hidden() { return kMaxHidden; }

// out[0..6] = (CTAs, units a CTA, shared-memory bytes a CTA, h columns
// staged at a time, floats of a packed U row, U's rows a CTA keeps
// resident (round4(H): all), bytes of U the grid streams a step) of the
// launch for (B, H); returns make_plan's code.
extern "C" int tpk_ligru_fwd_plan(int B, int H, int* out) {
  Plan pl;
  const int err = make_plan(B, H, &pl);
  if (err == 0) {
    out[0] = pl.ctas;
    out[1] = pl.u;
    out[2] = static_cast<int>(pl.smem);
    out[3] = pl.kc;
    out[4] = row_floats(pl.u);
    out[5] = pl.k_res;
    out[6] = static_cast<int>(stream_bytes(pl, H));
  }
  cudaGetLastError();  // a failed query leaves nothing behind
  return err;
}

// Launches on `stream` and returns the error: a grid the card cannot hold
// at once (cudaErrorCooperativeLaunchTooLarge), a U packed for another
// number of units a CTA than the plan's (cudaErrorInvalidValue), or what
// the cooperative launch reports (a refused launch never runs, and only
// this value reports it).  upk is (P, H, row_floats(units)) float32 as the
// header states, hbuf [2][round4(B)][round4(H)] float32 and bar one
// unsigned word, both zeroed by the caller.
extern "C" int tpk_ligru_fwd(const float* ff, const float* upk, const float* mask,
                             float* out, float* hbuf, void* bar, int T, int B,
                             int H, int units, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int err = make_plan(B, H, &pl);
  if (err == 0 && units != pl.u) err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  Params prm{ff, upk, mask, out, hbuf, static_cast<unsigned*>(bar),
             T, B, H, pl.u, pl.kp, pl.bp, pl.rows, pl.mmax, pl.kc,
             pl.k_res};
  void* args[] = {&prm};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      ligru_fwd_kernel, dim3(pl.ctas), dim3(kThreads), args, pl.smem, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}
