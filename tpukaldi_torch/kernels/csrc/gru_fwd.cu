// GRU forward recurrence for Hopper (sm_90a), float32.
//
// Replaces tpukaldi/kernels/gru.py::_gru_kernel (the Pallas forward,
// launched from _gru_pallas_fwd_impl).  For every batch row b it runs
//
//     [uz | ur] = h @ Uzr                       Uzr (H, 2H), Uh (H, H)
//     z  = sigmoid(ff[t, b, H:2H] + uz)
//     r  = sigmoid(ff[t, b, 2H:]  + ur)
//     a  = ff[t, b, 0:H] + (r * h) @ Uh
//     h  = z * h + (1 - z) * act(a) * mask[b]   h_0 = 0
//
// with act = relu (kAct 0) or tanh (kAct 1), and writes h for every step.
// ff is in tpukaldi's gate order [h | z | r].  All tensors are float32 and
// contiguous: ff (T, B, 3H), Uzr (H, 2H), Uh (H, H), mask (B, H), out
// (T, B, H).  Every step of T runs; nothing is padded to a time block.
//
// Design: K2f's (lstm_fwd.cu), one persistent cooperative launch, with the
// GRU's second, dependent product: two exchanges and two grid barriers a
// step, as in K3b's chain (gru_bwd.cu).
// - Grid.  P CTAs, at most one per SM: CTA q owns u consecutive hidden
//   units S_q, u the smallest number with P = ceil(H / u) <= the SM count
//   (on an H100: u = 5, P = 110 at H = 550; u = 8, P = 128 at H = 1024);
//   the last CTA may own fewer.  A grid the card cannot hold at once is
//   refused, not run.
// - Uh[:, S_q] and [Uz | Ur][:, S_q] stay in shared memory for all T
//   steps, copied once per call with cp.async in the layout K3b reads
//   (gru_slices.cuh): 44 KB at H = 550, 115 KB at H = 1024.  Past what
//   shared memory holds (H = 2048, u = 16: 416 KB), a CTA keeps its first
//   k_res rows resident (640 at B' = 16, 384 at 64 rows) and streams the
//   rest with each product's chunks, 128 rows a chunk, the part of the
//   rows that product reads (gru_slices.cuh::stage_gru_rows,
//   u_stream.cuh): 34.6 MB of U a step over the grid at B' = 16, 67.9 us a
//   step at (T, B, H) = (778, 16, 2048) on an H100 at 700 W
//   (tpukaldi_torch/tools/recurrence_envelope.py).  Where the slices fit
//   (every H <= 1024, and 1036), the resident design runs as before, bit
//   for bit.  H <= 2048 keeps u <= 16 on 132 SMs.
// - A step has two phases, each ending at a grid barrier:
//   (a) every CTA streams h_{t-1} (the pass's rows x H) from hbuf through
//       shared memory in chunks of up to 256 columns, double-buffered with
//       cp.async.cg, runs h_{t-1} @ [Uz | Ur][:, S_q] (2u columns), forms z
//       and r of its own (b, j) cells and writes r * h_{t-1} of S_q into
//       rbuf; barrier 1;
//   (b) it streams rbuf the same way, runs (r h_{t-1}) @ Uh[:, S_q] (u
//       columns), forms a and h_t with h_{t-1}[S_q] and z kept in
//       registers and writes h_t into hbuf; barrier 2; then h_t into the
//       output, which no other CTA reads, while the others catch up.
//   The step's three ff gates are loaded into registers when it starts, in
//   flight while h is staged and multiplied.  The staging reads L2 only
//   (cp.async.cg), so no CTA reads a stale L1 line of a buffer that another
//   CTA rewrote a phase earlier.
// - Why hbuf and rbuf need no ping-pong of their own, as K2f's hbuf does:
//   every CTA's reads of hbuf at (a) of step t end before it arrives
//   at barrier 1 of step t, and hbuf's next writes, at (b) of step t, come
//   after that barrier; every read of rbuf at (b) of step t ends before the
//   arrival at barrier 2 of step t, and rbuf's next writes, at (a) of step
//   t + 1, come after it.  So each buffer's reads end before its next
//   writes begin, parted by the other phase's barrier.  A pass's last step
//   skips barrier 2: the next pass reads and writes other rows of both
//   buffers (each holds every batch row).  The barrier counter grows by 2P
//   a step.
// - The products are float32 fmaf on the CUDA cores, as tpukaldi's kernel
//   is float32 and the port keeps TF32 off.  A thread owns a register tile
//   of 4 batch rows (r, r + m/4, r + m/2, r + 3m/4 of the pass's m rows, so
//   that neighbouring threads read h rows in distinct banks) x one 16-byte
//   word of the slice rows, 4 columns: per k step of 4 it loads 4 float4 of
//   h and 4 of U and runs 64 fmaf.  Where there are fewer tiles than the
//   256 threads (at the training batch B' = 16, u = 5: 12 tiles in (a), 8
//   in (b)), the depth is split too: slice s takes the k steps s, s + S,
//   ...  The Uh product has one column per unit, in ceil(u / 4) words (8
//   columns for u = 5, 3 of them zeros).  A tile of 4 rows x 1 column over
//   a slice of Uh stored by column would load 5 words for 16 fmaf, against
//   the word tile's 8 for 64 (40 of them on real columns at u = 5), and
//   leave twice as many slices to add, so (b) keeps the word tile.
// - Each thread sums its k steps in ascending order and the cell adds the
//   slices' partial sums in ascending order, so two calls on the same
//   inputs give the same bits.  h agrees with K3b's remat (gru_remat.cuh)
//   to the sum order, not bit for bit, as K2f's does with K2b's.
// - A pass holds at most 128 batch rows (and at most 1024 / u, so that a
//   thread holds at most 4 cells); more rows run as further passes in the
//   same launch, each from h_0 = 0.
//
// What bounds it.  The 3.63 MB of Uzr and Uh (H = 550) that the
// one-CTA-per-row design re-read from L2 every step, in every CTA, stays in
// shared memory.  Per step each CTA reads the pass's h_{t-1} and r h_{t-1}
// from L2 (2 x P x B x H x 4 bytes across the grid, 31 MB at B = 64,
// H = 550), runs its share of the two products (B x 3u x H fmaf, 0.53 M at
// B = 64; its word tiles run 20 columns for the 15 real ones at u = 5) and
// waits at two grid barriers.  tpukaldi_torch/tools/gru_fwd_phases.py,
// which cuts phases out of this source, split a step on an H100 at 700 W
// at (B, H) = (64, 550) into 19.1 us: the two products 7.1, the two
// streams 7.8, the two grid barriers 1.9, the cells and the rest 3.7; at
// B = 16 (the training batch), 10.3 us: 2.4, 3.7, 1.8 and 2.9.  Tiles of 8
// rows were 2% faster at B = 64 and 8% slower at B = 16; chunks of 128
// columns 7% slower at B = 64 and 2% faster at B = 16, of 64 columns
// 18-19% slower at both.

#include <cuda_runtime.h>

#include "gru_slices.cuh"
#include "persist_grid.cuh"
#include "u_stream.cuh"

namespace {

constexpr int kMaxHidden = 2048;  // K3b's is 1024
constexpr int kThreads = 256;
constexpr int kRows = 4;          // batch rows of a thread's tile
constexpr int kMaxRows = 128;     // batch rows of one pass
constexpr int kMaxUnits = 16;     // hidden units one CTA may own
constexpr int kMaxPos = 4;        // cells a thread holds: (b, j) pairs
constexpr int kMaxChunk = 256;    // h columns staged at a time
// partial sums in shared memory: slices x rows x 4 columns of a word, at
// most one float4 per thread of each of its tile's rows
constexpr int kPartialFloats = kThreads * kRows * 4;

// error code for a grid that cannot be resident at once
constexpr int kErrNotResident = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr int round_rows(int x) {
  return (x + kRows - 1) / kRows * kRows;
}

// a row length of x floats padded to an odd number of 16-byte words, so
// that 8 rows read at one column fall in 8 distinct groups of 4 banks
__host__ __device__ constexpr int odd_words(int x) {
  return (x / 4) % 2 ? x : x + 4;
}

struct Params {
  const float* ff;
  const float* uzr;
  const float* uh;
  const float* mask;
  float* out;
  float* hbuf;    // [bp][kp] h_{t-1}, then [bp][kp] r h_{t-1} (rbuf); zeroed
  unsigned* bar;  // grid barrier's arrival counter, zero at launch
  int T, B, H;
  int u;     // hidden units a CTA owns (the last CTA may own fewer)
  int kp;    // H padded to 4: U's rows and the buffers' row length
  int bp;    // B padded to kRows: the buffers' rows
  int rows;  // batch rows of a pass
  int mmax;  // rows of the largest pass, padded to kRows
  int kc;    // columns staged at a time (a multiple of 4)
  int kres;  // U's rows resident: kp, or whole chunks (the rest streamed)
};

struct Plan {
  int u, ctas, kp, bp, rows, mmax, kc;
  int k_res;  // U's rows a CTA keeps resident (kp: all, the resident design)
  size_t smem;
};

// U's resident rows, the two staged chunks, the partial sums and, where
// U's slices are streamed, their two staged chunks
inline size_t smem_bytes(int res_rows, int u, int mmax, int kc, bool stream) {
  const size_t u_floats = static_cast<size_t>(res_rows + (stream ? 2 * kc : 0)) *
                          tpk::gru_row_floats(u);
  const size_t h_floats = 2 * static_cast<size_t>(mmax) * odd_words(kc);
  return (u_floats + h_floats + kPartialFloats) * sizeof(float);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// U's rows from kres on, if any, are streamed a chunk at a time, each
// product staging its own part of them (u_stream.cuh)
template <int kAct>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const Params p) {
  const int H = p.H, kp = p.kp, kc = p.kc, u = p.u;
  const int unit0 = blockIdx.x * u;
  const int up = min(u, H - unit0);  // units this CTA owns
  const int tid = threadIdx.x;
  const int ld = tpk::gru_row_floats(u);
  const int wh = tpk::gru_uh_words(u);    // words of the Uh product
  const int wzr = tpk::gru_uzr_words(u);  // words of the [Uz | Ur] product
  const int hs_ld = odd_words(kc);
  const size_t three_h = 3 * static_cast<size_t>(H);

  // U's resident rows: kp, or whole chunks where the rest is streamed
  const int kr = p.kres;
  float* us = reinterpret_cast<float*>(tpk::dynamic_smem());  // kr x ld
  float* hs = us + static_cast<size_t>(kr) * ld;  // 2 x mmax x hs_ld
  float* gs = hs + 2 * static_cast<size_t>(p.mmax) * hs_ld;  // partial sums
  float* ss = gs + kPartialFloats;  // 2 x kc x ld streamed chunks of U

  // U's resident rows (a streamed slice's are all below H)
  tpk::load_gru_slices(us, kr, p.uh, p.uzr, H, u, unit0, up, min(H, kr));

  float* const hbuf = p.hbuf;
  float* const rbuf = p.hbuf + static_cast<size_t>(p.bp) * kp;
  const int nchunks = (kp + kc - 1) / kc;
  unsigned arrived = 0;  // the barrier counter's value at the last barrier
  auto arrive = [&]() { tpk::grid_arrive(p.bar); };
  auto wait = [&]() {
    arrived += gridDim.x;
    tpk::grid_wait(p.bar, arrived);
  };

  for (int b0 = 0; b0 < p.B; b0 += p.rows) {
    const int rows = min(p.rows, p.B - b0);
    const int mp = round_rows(rows);
    const int tr_n = mp / kRows;
    const int npos = rows * up;

    float m[kMaxPos], hv[kMaxPos], zv[kMaxPos], fv[kMaxPos][3];
#pragma unroll
    for (int i = 0; i < kMaxPos; ++i) {
      const int q = tid + i * kThreads;
      m[i] = 0.0f;
      hv[i] = 0.0f;
      zv[i] = 0.0f;
      if (q < npos) {
        const int b = q / up;
        m[i] = p.mask[static_cast<size_t>(b0 + b) * H + unit0 + q - b * up];
      }
    }

    // stage columns [ch * kc, ch * kc + width) of the pass's rows of src,
    // and a streamed chunk's rows of U's part that the product reads (the
    // [Uz, Ur] part, or the Uh part) beside them
    auto stage = [&](const float* src, int ch, bool uzr_part) {
      const int k0 = ch * kc;
      const int per_row = min(kc, kp - k0) / 4;
      float* buf = hs + (ch & 1) * static_cast<size_t>(p.mmax) * hs_ld;
      for (int i = tid; i < mp * per_row; i += kThreads) {
        const int r = i / per_row;
        const int v = (i - r * per_row) * 4;
        tpk::cp_async16_cg(buf + r * hs_ld + v,
                           src + static_cast<size_t>(b0 + r) * kp + k0 + v);
      }
      if (k0 >= kr) {
        tpk::stage_gru_rows(ss + (ch & 1) * static_cast<size_t>(kc) * ld, p.uh,
                            p.uzr, uzr_part, H, u, unit0, up, k0,
                            k0 + 4 * per_row);
      }
      tpk::cp_async_commit();
    };
    // the pass's rows of src times the slice rows' words [w0, w0 + nw), as
    // partial sums gs[slice][row][4 * nw]; returns the slices.  w0 = 0 is
    // the Uh part, any other the [Uz, Ur] part
    auto product = [&](const float* src, int w0, int nw) {
      const bool uzr_part = w0 != 0;
      const int ntile = tr_n * nw;  // tiles of kRows rows x one word
      const int S = max(1, kThreads / ntile);
      const bool active = tid < ntile * S;
      const int s_thr = tid / ntile;
      const int tile = tid - s_thr * ntile;
      const int tr = tile / nw;
      const int tw = tile - tr * nw;
      float acc[kRows][4];
#pragma unroll
      for (int x = 0; x < kRows * 4; ++x) acc[x / 4][x % 4] = 0.0f;
      stage(src, 0, uzr_part);
      for (int ch = 0; ch < nchunks; ++ch) {
        if (ch + 1 < nchunks) {
          stage(src, ch + 1, uzr_part);
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
                   : us + static_cast<size_t>(ch) * kc * ld) + 4 * (w0 + tw);
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
      return S;
    };

    for (int t = 0; t < p.T; ++t) {
      // this step's ff, in flight while h is staged and multiplied
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const float* f = p.ff + (static_cast<size_t>(t) * p.B + b0 + b) * three_h
                           + unit0 + q - b * up;
          fv[i][0] = f[0];
          fv[i][1] = f[H];
          fv[i][2] = f[2 * H];
        }
      }

      // (a) z and r from h_{t-1} @ [Uz | Ur]; r h_{t-1} into rbuf, barrier 1
      int S = product(hbuf, wh, wzr);
      const size_t zr_ld = static_cast<size_t>(mp) * 4 * wzr;  // one slice
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const int jj = q - b * up;
          const float* g = gs + b * 4 * wzr + 2 * jj;
          float uz = g[0], ur = g[1];
          for (int s = 1; s < S; ++s) {
            uz += g[s * zr_ld];
            ur += g[s * zr_ld + 1];
          }
          zv[i] = sigmoidf(fv[i][1] + uz);
          const float r = sigmoidf(fv[i][2] + ur);
          rbuf[static_cast<size_t>(b0 + b) * kp + unit0 + jj] = r * hv[i];
        }
      }
      arrive();
      wait();

      // (b) a from (r h_{t-1}) @ Uh; h_t into hbuf, barrier 2
      S = product(rbuf, 0, wh);
      const size_t h_ld = static_cast<size_t>(mp) * 4 * wh;  // one slice
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const int jj = q - b * up;
          const float* g = gs + b * 4 * wh + jj;
          float ua = g[0];
          for (int s = 1; s < S; ++s) ua += g[s * h_ld];
          const float a = fv[i][0] + ua;
          const float act = kAct == 0 ? fmaxf(a, 0.0f) : tanhf(a);
          hv[i] = zv[i] * hv[i] + (1.0f - zv[i]) * (act * m[i]);
          hbuf[static_cast<size_t>(b0 + b) * kp + unit0 + jj] = hv[i];
        }
      }
      // the other CTAs read only hbuf: arrive, then write h while they
      // catch up
      const bool more = t + 1 < p.T;
      if (more) arrive();
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          p.out[(static_cast<size_t>(t) * p.B + b0 + b) * H + unit0 + q - b * up] =
              hv[i];
        }
      }
      if (more) wait();
    }
  }
}

// the kernel for act 0 (relu) or 1 (tanh)
inline void (*fwd_kernel(int act))(const Params) {
  return act == 0 ? gru_fwd_kernel<0> : gru_fwd_kernel<1>;
}

// bytes of U the grid streams a step: each CTA's rows past k_res, the 3u
// floats of its units (Uh's in one product, Uz's and Ur's in the other)
inline long long stream_bytes(const Plan& pl, int H) {
  return 12LL * H * (H - (pl.k_res < H ? pl.k_res : H));
}

// The launch's shape for (B, H) on the current device, and whether the
// card can hold its grid at once; returns a CUDA error code (0: fits).
int make_plan(int B, int H, int act, Plan* pl) {
  if (B <= 0 || H <= 0 || H > kMaxHidden || act < 0 || act > 1) {
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
  const int u = (H + sms - 1) / sms;
  if (u > kMaxUnits) return kErrNotResident;
  pl->u = u;
  pl->ctas = (H + u - 1) / u;
  pl->kp = round4(H);
  pl->bp = round_rows(B);
  // a pass's rows: at most kMaxPos cells a thread (which also keeps each
  // product's tiles within the threads)
  const int cap = kMaxRows < kMaxPos * kThreads / u / kRows * kRows
                      ? kMaxRows : kMaxPos * kThreads / u / kRows * kRows;
  pl->rows = B < cap ? B : cap;
  pl->mmax = round_rows(pl->rows);
  // the resident design where U's whole slices fit beside the chunks,
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
    if (!tpk::stream_plan(smem, optin, sizeof(float) * tpk::gru_row_floats(u),
                          H, &pl->kc, &pl->k_res)) {
      return kErrNotResident;
    }
    pl->smem = smem(pl->k_res, pl->kc);
  }
  const auto kernel = fwd_kernel(act);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl->smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, pl->smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < pl->ctas) return kErrNotResident;
  return 0;
}

}  // namespace

extern "C" int tpk_gru_fwd_max_hidden() { return kMaxHidden; }

// out[0..5] = (CTAs, units a CTA, shared-memory bytes a CTA, columns staged
// at a time, U's rows a CTA keeps resident (round4(H): all), bytes of U the
// grid streams a step) of the launch for (B, H); returns make_plan's code.
extern "C" int tpk_gru_fwd_plan(int B, int H, int* out) {
  Plan pl;
  const int err = make_plan(B, H, 1, &pl);
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

// act: 0 relu, 1 tanh.  Launches on `stream` and returns the error: a grid
// the card cannot hold at once (cudaErrorCooperativeLaunchTooLarge), or what
// the cooperative launch reports (a refused launch never runs, and only this
// value reports it).  hbuf is [2][round4(B)][round4(H)] float32 and bar one
// unsigned word, both zeroed by the caller.
extern "C" int tpk_gru_fwd(const float* ff, const float* uzr, const float* uh,
                           const float* mask, float* out, float* hbuf, void* bar,
                           int T, int B, int H, int act, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = make_plan(B, H, act, &pl);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  Params prm{ff, uzr, uh, mask, out, hbuf, static_cast<unsigned*>(bar),
             T, B, H, pl.u, pl.kp, pl.bp, pl.rows, pl.mmax, pl.kc,
             pl.k_res};
  void* args[] = {&prm};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      fwd_kernel(act), dim3(pl.ctas), dim3(kThreads), args, pl.smem, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}
