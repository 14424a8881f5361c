// LSTM backward recurrence for Hopper (sm_90a), float32.
//
// Replaces tpukaldi/kernels/lstm.py::_lstm_bwd_kernel (the Pallas backward,
// launched from _lstm_pallas_bwd_impl).  Given the forward's inputs ff
// (T, B, 4H), U = [Uf | Ui | Uo | Uc] (H, 4H), mask (B, H), its outputs h
// and c (T, B, H) and the gradient g of h (T, B, H), it returns
//
//     dff (T, B, 4H)   dA_t = [da_f | da_i | da_o | da_c] of every step
//     dU  (H, 4H)      sum over t, b of h_prev[t, b]^T dA[t, b]
//     dmask (B, H)     sum over t of dc * i * cand
//
// walking time backwards with h_prev[t] = h[t - 1], c_prev[t] = c[t - 1]
// (zeros at t = 0), the gates recomputed from h_prev:
//
//     a = ff + h_prev @ U;  f, i, o = sigmoid(a_f, a_i, a_o);  cand = tanh(a_c)
//     gh   = g[t] + dh                            dh, dc carried from t + 1
//     da_o = gh * tanh(c) * o * (1 - o)
//     dc   = gh * o * (1 - tanh(c)^2) + dc
//     da_f = dc * c_prev * f * (1 - f)
//     da_i = dc * cand * m * i * (1 - i)
//     da_c = dc * i * m * (1 - cand^2)
//     dh   = dA @ U^T,  dc = dc * f                   for step t - 1
//
// All tensors are float32 and contiguous.  U also arrives packed as upk
// (H, H, 4), upk[k, j, g] = U[k, gH + j], the same operand K2f reads
// (lstm_fwd.cu), made once per call by the wrapper.  Every step of T runs
// (the Pallas kernel pads T to its time block and runs the padded steps
// first, which adds nothing).
//
// Design: three launches on one stream.
// 1. The gate remat, off the chain (lstm_remat.cuh): nothing in
//    a = ff + h_prev @ U depends on the dh chain, so one parallel tiled
//    float32 pass forms it for all T * B rows and writes the activations
//    f, i, o, cand into dff.  The sequential pass overwrites them in place
//    with dA: each element is read and then rewritten by the same thread,
//    so no (T, B, 4H) buffer is added.
// 2. The dh chain, one persistent cooperative launch on K2f's grid: P CTAs,
//    CTA p owning u consecutive hidden units (u the smallest number with
//    P = ceil(H / u) <= the SM count: u = 5, P = 110 at H = 550; u = 8,
//    P = 128 at H = 1024; the last CTA may own fewer).  A grid the card
//    cannot hold at once is refused, not run.  Each CTA keeps K2f's own
//    slice of upk in shared memory for all T steps (44 KB at H = 550).
//    Per reverse step t:
//    (a) the cell: one thread per (batch row b, owned unit j) reads the
//        gates from dff[t] and c[t], c[t - 1], g[t] (loaded when the step
//        starts, in flight while the exchange is staged), adds the partial
//        dh sums of the step before to dh[b, j], forms dA for j's four gate
//        columns and writes them to dff[t] and to shared memory; dc and
//        dmask stay in registers.
//    (b) the partial dh product: part_p[b, k] = sum over the CTA's units j
//        and gates g of dA[b, gH + j] U[k, gH + j], for all k < H: B x H
//        outputs of depth 4u, on K2f's tiling (a thread owns 4 batch rows
//        x 4 rows k of U, m / 4 and H / 4 apart against bank conflicts;
//        per unit 8 float4 loads from shared memory to 64 fmaf).  They go
//        to a global ping-pong buffer laid out by the CTA that reads them,
//        pbuf[t & 1][q][p][b][u] (q the CTA owning unit k), so that each
//        CTA's reads are one contiguous run: staged in shared memory in
//        that layout (in the exchange's buffer, idle then, a group of
//        readers at a time where it is small) and written out in 16-byte
//        words, one contiguous block for each reader (scattered 4-byte
//        writes straight to pbuf were slower: PERF.md, section 6).
//    (c) one grid barrier (persist_grid.cuh).  Then CTA q stages
//        pbuf[..][q][p] for all p with cp.async.cg (L2 only, so no stale L1
//        line is read), in chunks of producers that fit its shared memory,
//        double-buffered, and sums them over p in ascending order: dh for
//        its own units.
//    dA never leaves the CTA except into dff: per step a CTA writes B x H
//    partial sums (35 KB at B = 16, H = 550) and reads P x B x u (56 KB).
//    A pass holds at most 128 batch rows (and at most 1024 / u, so that a
//    thread holds at most 4 cells); more rows run as further passes in the
//    same launch, each from dh = dc = 0.
// 3. dU = h_prev^T dff over the T * B rows: the deterministic tiled pass of
//    du_tile.cuh.
// Every sum runs in a fixed order (no float atomics), so two calls on the
// same inputs give the same bits.  The remat's sum order differs from
// K2f's, so the gates agree with the forward's to the sum order.
//
// What bounds it.  The one-CTA-per-row design this replaces ran B CTAs and
// re-read U twice per step from L2 (9.7 MB per CTA per step at H = 550).
// Here U stays in shared memory, the remat and dU are two parallel GEMM
// passes (2 T B H 4H flops each), and a step of the chain costs its share
// of the dh product (B x 4u x H fmaf a CTA: 176 K at B = 16, H = 550), the
// exchange, one grid barrier and the cell.  tpukaldi_torch/tools/
// lstm_bwd_phases.py, which cuts these phases out of this source, split a
// call at (T, B, H) = (778, 16, 550) on an H100 at 700 W into 9.8 ms: the
// remat 1.0, dU 2.8 and the chain 6.0, 7.7 us a step (the product 3.3,
// the exchange 1.3, the barrier, the cell and the write-out 3.2).  The
// product runs at a fifth of the SM's float32 rate; no wider tile, 512
// threads or other lane order made it faster at B = 16.

#include <cuda_runtime.h>

#include "du_tile.cuh"
#include "lstm_remat.cuh"
#include "persist_grid.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // as K2f's limit
constexpr int kThreads = 256;
constexpr int kRows = 4;         // batch rows of a thread's product tile
constexpr int kCols = 4;         // rows k of U of a thread's product tile
constexpr int kMaxRows = 128;    // batch rows of one pass
constexpr int kMaxUnits = 16;    // hidden units one CTA may own
constexpr int kMaxPos = 4;       // cells a thread holds: (b, j) pairs

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
  const float* c;
  const float* g;
  const float* upk;
  const float* mask;
  float* dff;     // in: the gates; out: dA
  float* dmask;
  float* pbuf;    // [2][P][P][mmax][u]: the partial dh sums
  unsigned* bar;  // grid barrier's arrival counter, zero at launch
  int T, B, H;
  int u;     // hidden units a CTA owns (the last CTA may own fewer)
  int kp;    // U's rows in shared memory: H padded to 4, and kCols
             // rows of zeros that a group's last tile may read
  int rows;  // batch rows of a pass
  int mmax;  // rows of the largest pass, padded to 4
  int pc;    // producers' blocks of partial sums staged at a time
};

struct Plan {
  int u, ctas, kp, rows, mmax, pc;
  size_t smem, pbuf;
};

// U's slice, this step's dA of the CTA's units, and two staged chunks of
// partial sums
inline size_t smem_bytes(int kp, int u, int mmax, int pc) {
  const size_t ld = odd_words(4 * u);
  const size_t floats = (static_cast<size_t>(kp) + mmax) * ld
                        + 2 * static_cast<size_t>(pc) * mmax * u;
  return floats * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_seq_kernel(const Params p) {
  const int H = p.H, kp = p.kp, u = p.u;
  const int P = gridDim.x;
  const int me = blockIdx.x;
  const int unit0 = me * u;
  const int up = min(u, H - unit0);  // units this CTA owns
  const int tid = threadIdx.x;
  const int ld = odd_words(4 * u);
  const size_t four_h = 4 * static_cast<size_t>(H);

  float* us = reinterpret_cast<float*>(tpk::dynamic_smem());  // kp x ld
  float* das = us + static_cast<size_t>(kp) * ld;             // mmax x ld
  float* stg = das + static_cast<size_t>(p.mmax) * ld;  // 2 x pc x mmax x u

  // U's slice: zero the padding (and dA's rows, of which a short pass
  // leaves some unwritten), then the H real rows of up 16-byte words
  for (int i = tid; i < (kp + p.mmax) * ld; i += kThreads) us[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < H * up; i += kThreads) {
    const int k = i / up;
    const int v = i - k * up;
    tpk::cp_async16_cg(us + static_cast<size_t>(k) * ld + 4 * v,
                       p.upk + (static_cast<size_t>(k) * H + unit0 + v) * 4);
  }
  tpk::cp_async_commit();
  tpk::cp_async_wait<0>();
  __syncthreads();

  const size_t blk = static_cast<size_t>(p.mmax) * u;  // one producer's block
  const size_t buf_elems = static_cast<size_t>(P) * P * blk;
  const size_t chunk_elems = static_cast<size_t>(p.pc) * blk;
  const int nchunks = (P + p.pc - 1) / p.pc;
  // the product's partial sums are staged for qgroup readers at a time in
  // the exchange's buffer, which is idle then
  const int qgroup = 2 * p.pc;
  float* ostg = stg;
  const float inv_u = 1.0f / u;
  unsigned arrived = 0;  // the barrier counter's value at the last barrier

  for (int b0 = 0; b0 < p.B; b0 += p.rows) {
    const int rows = min(p.rows, p.B - b0);
    const bool last_pass = b0 + p.rows >= p.B;
    const int mp = round_rows(rows);
    const int tr_n = mp / kRows;
    const int npos = rows * up;
    const int per_blk = mp * u / 4;  // 16-byte words of a block this pass

    float dc[kMaxPos], dm[kMaxPos], m[kMaxPos];
#pragma unroll
    for (int i = 0; i < kMaxPos; ++i) {
      const int q = tid + i * kThreads;
      dc[i] = 0.0f;
      dm[i] = 0.0f;
      m[i] = 0.0f;
      if (q < npos) {
        const int b = q / up;
        m[i] = p.mask[static_cast<size_t>(b0 + b) * H + unit0 + q - b * up];
      }
    }

    for (int t = p.T - 1; t >= 0; --t) {
      // this CTA's partial sums of the step before: pbuf[(t + 1) & 1][me]
      const float* src = p.pbuf + ((t + 1) & 1) * buf_elems + me * P * blk;

      // stage producers [ch * pc, ch * pc + pc) of the pass's rows
      auto stage = [&](int ch) {
        const int p0 = ch * p.pc;
        const int n = min(p.pc, P - p0) * per_blk;
        float* buf = stg + (ch & 1) * chunk_elems;
        for (int i = tid; i < n; i += kThreads) {
          const int pp = i / per_blk;
          const int v = i - pp * per_blk;
          tpk::cp_async16_cg(buf + static_cast<size_t>(pp) * mp * u + 4 * v,
                             src + (p0 + pp) * blk + 4 * v);
        }
        tpk::cp_async_commit();
      };
      const bool exchange = t + 1 < p.T;
      if (exchange) stage(0);

      // this step's gates, c, c_prev and g, in flight while the partial
      // sums are staged and added
      float gv[kMaxPos][4], cv[kMaxPos], cpv[kMaxPos], gr[kMaxPos], dh[kMaxPos];
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        dh[i] = 0.0f;
        if (q < npos) {
          const int b = q / up;
          const int j = unit0 + q - b * up;
          const size_t row = static_cast<size_t>(t) * p.B + b0 + b;
#pragma unroll
          for (int g = 0; g < 4; ++g) gv[i][g] = p.dff[row * four_h + g * H + j];
          cv[i] = p.c[row * H + j];
          cpv[i] = t > 0 ? p.c[(row - p.B) * H + j] : 0.0f;
          gr[i] = p.g[row * H + j];
        }
      }

      if (exchange) {
        for (int ch = 0; ch < nchunks; ++ch) {
          if (ch + 1 < nchunks) {
            stage(ch + 1);
            tpk::cp_async_wait<1>();
          } else {
            tpk::cp_async_wait<0>();
          }
          __syncthreads();
          const float* buf = stg + (ch & 1) * chunk_elems;
          const int np = min(p.pc, P - ch * p.pc);
#pragma unroll
          for (int i = 0; i < kMaxPos; ++i) {
            const int q = tid + i * kThreads;
            if (q < npos) {
              const int b = q / up;
              const float* x = buf + b * u + q - b * up;
              for (int pp = 0; pp < np; ++pp) {
                dh[i] += x[static_cast<size_t>(pp) * mp * u];
              }
            }
          }
          __syncthreads();  // the buffer is staged again two chunks on
        }
      }

      // the cell: dA of (b, j) into dff[t] (over the gates just read) and
      // into shared memory for the product
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const int jj = q - b * up;
          const float f = gv[i][0], ig = gv[i][1], o = gv[i][2], cand = gv[i][3];
          const float tanh_c = tanhf(cv[i]);
          const float gh = gr[i] + dh[i];
          const float da_o = gh * tanh_c * o * (1.0f - o);
          dc[i] = gh * o * (1.0f - tanh_c * tanh_c) + dc[i];
          const float da_f = dc[i] * cpv[i] * f * (1.0f - f);
          const float da_i = dc[i] * cand * m[i] * ig * (1.0f - ig);
          const float da_c = dc[i] * ig * m[i] * (1.0f - cand * cand);
          const size_t row = static_cast<size_t>(t) * p.B + b0 + b;
          float* d = p.dff + row * four_h + unit0 + jj;
          d[0] = da_f;
          d[H] = da_i;
          d[2 * H] = da_o;
          d[3 * H] = da_c;
          *reinterpret_cast<float4*>(das + b * ld + 4 * jj) =
              make_float4(da_f, da_i, da_o, da_c);
          dm[i] = fmaf(dc[i] * ig, cand, dm[i]);
          dc[i] *= f;
        }
      }

      if (t > 0) {
        __syncthreads();  // dA of the CTA's units complete
        // partial dh sums of every row k of U, a group of readers at a
        // time: into shared memory in the readers' layout, then out to
        // each reader's block in 16-byte words
        float* dst = p.pbuf + (t & 1) * buf_elems + me * blk;
        for (int q0 = 0; q0 < P; q0 += qgroup) {
          const int nq = min(qgroup, P - q0);
          const int k0 = q0 * u;
          const int kn = min(H, k0 + nq * u) - k0;  // rows k of the group
          const int kq = (kn + kCols - 1) / kCols;
          const int ntile = tr_n * kq;  // tiles of kRows rows x kCols rows k
          for (int tile = tid; tile < ntile; tile += kThreads) {
            // rows b fastest: a warp's lanes share few rows k of U (a
            // broadcast load) and few rows b of dA
            const int tk = tile / tr_n;
            const int tr = tile - tk * tr_n;
            float acc[kRows][kCols];
#pragma unroll
            for (int x = 0; x < kRows * kCols; ++x) acc[x / kCols][x % kCols] = 0.0f;
            for (int jj = 0; jj < up; ++jj) {
              float4 dv[kRows], uw[kCols];
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
                dv[i] = *reinterpret_cast<const float4*>(
                    das + (tr + i * tr_n) * ld + 4 * jj);
              }
#pragma unroll
              for (int d = 0; d < kCols; ++d) {
                uw[d] = *reinterpret_cast<const float4*>(
                    us + static_cast<size_t>(k0 + tk + d * kq) * ld + 4 * jj);
              }
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
#pragma unroll
                for (int d = 0; d < kCols; ++d) {
                  acc[i][d] = fmaf(dv[i].x, uw[d].x, acc[i][d]);
                  acc[i][d] = fmaf(dv[i].y, uw[d].y, acc[i][d]);
                  acc[i][d] = fmaf(dv[i].z, uw[d].z, acc[i][d]);
                  acc[i][d] = fmaf(dv[i].w, uw[d].w, acc[i][d]);
                }
              }
            }
#pragma unroll
            for (int d = 0; d < kCols; ++d) {
              const int k = k0 + tk + d * kq;
              if (k - k0 >= kn) continue;
              // k / u, exact: (k + 0.5) / u is at least 0.5 / u from an integer
              const int q = static_cast<int>((k + 0.5f) * inv_u);
              float* o = ostg + (q - q0) * mp * u + k - q * u;
#pragma unroll
              for (int i = 0; i < kRows; ++i) {
                const int b = tr + i * tr_n;
                if (b < rows) o[b * u] = acc[i][d];
              }
            }
          }
          __syncthreads();  // the group's partial sums staged
          for (int i = tid; i < nq * per_blk; i += kThreads) {
            const int qq = i / per_blk;
            const int v = i - qq * per_blk;
            *reinterpret_cast<float4*>(dst + (q0 + qq) * P * blk + 4 * v) =
                *reinterpret_cast<const float4*>(ostg + qq * mp * u + 4 * v);
          }
          if (q0 + qgroup < P) __syncthreads();  // the staging is reused
        }
      }
      // the next pass's first product rewrites a buffer the others may
      // still be reading: the last step of a pass ends at a barrier too,
      // but the launch's last
      if (t > 0 || !last_pass) {
        tpk::grid_arrive(p.bar);
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

// The sequential launch's shape for (B, H) on the current device, and
// whether the card can hold its grid at once; returns a CUDA error code
// (0: fits).
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
  const int u = (H + sms - 1) / sms;
  if (u > kMaxUnits) return kErrNotResident;
  pl->u = u;
  pl->ctas = (H + u - 1) / u;
  pl->kp = round4(H) + kCols;
  // a pass's rows: at most kMaxPos cells a thread
  const int cap = kMaxRows < kMaxPos * kThreads / u / kRows * kRows
                      ? kMaxRows : kMaxPos * kThreads / u / kRows * kRows;
  pl->rows = B < cap ? B : cap;
  pl->mmax = round_rows(pl->rows);
  // the staged producers halve until the shared memory fits
  pl->pc = pl->ctas;
  while (smem_bytes(pl->kp, u, pl->mmax, pl->pc) > static_cast<size_t>(optin) &&
         pl->pc > 1) {
    pl->pc = (pl->pc + 1) / 2;
  }
  pl->smem = smem_bytes(pl->kp, u, pl->mmax, pl->pc);
  pl->pbuf = 2 * static_cast<size_t>(pl->ctas) * pl->ctas * pl->mmax * u;
  if (pl->smem > static_cast<size_t>(optin)) return kErrNotResident;
  err = cudaFuncSetAttribute(lstm_bwd_seq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl->smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lstm_bwd_seq_kernel, kThreads, pl->smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < pl->ctas) return kErrNotResident;
  return 0;
}

}  // namespace

extern "C" int tpk_lstm_bwd_max_hidden() { return kMaxHidden; }

// out[0..4] = (CTAs, units a CTA, shared-memory bytes a CTA, producers'
// partial sums staged at a time, floats of the pbuf scratch) of the
// sequential launch for (B, H); returns make_plan's code.
extern "C" int tpk_lstm_bwd_plan(int B, int H, int* out) {
  Plan pl;
  const int err = make_plan(B, H, &pl);
  if (err == 0) {
    out[0] = pl.ctas;
    out[1] = pl.u;
    out[2] = static_cast<int>(pl.smem);
    out[3] = pl.pc;
    out[4] = static_cast<int>(pl.pbuf);
  }
  cudaGetLastError();  // a failed query leaves nothing behind
  return err;
}

// Launches the three passes on `stream` and returns the first error: a
// grid the card cannot hold at once (cudaErrorCooperativeLaunchTooLarge,
// before anything runs), or what a launch reports (a refused launch never
// runs, and only this value reports it).  upk is (H, H, 4) float32; pbuf
// holds the plan's floats (tpk_lstm_bwd_plan, out[4]), any contents; bar
// is one unsigned word, zeroed by the caller.
extern "C" int tpk_lstm_bwd(const float* ff, const float* h, const float* c,
                            const float* g, const float* u, const float* upk,
                            const float* mask, float* dff, float* du,
                            float* dmask, float* pbuf, void* bar, int T, int B,
                            int H, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int err = make_plan(B, H, &pl);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  err = static_cast<int>(tpk::launch_remat(h, B, u, ff, dff, T * B, H, stream));
  if (err != 0) return err;
  Params prm{c, g, upk, mask, dff, dmask, pbuf, static_cast<unsigned*>(bar),
             T, B, H, pl.u, pl.kp, pl.rows, pl.mmax, pl.pc};
  void* args[] = {&prm};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      lstm_bwd_seq_kernel, dim3(pl.ctas), dim3(kThreads), args, pl.smem, stream);
  const cudaError_t last = cudaGetLastError();
  err = static_cast<int>(launched != cudaSuccess ? launched : last);
  if (err != 0) return err;
  return static_cast<int>(
      tpk::launch_du(h, B, dff, 4 * H, 0, 4 * H, du, T * B, H, stream));
}
