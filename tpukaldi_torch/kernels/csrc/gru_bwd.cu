// GRU backward recurrence for Hopper (sm_90a), float32.
//
// Replaces tpukaldi/kernels/gru.py::_gru_bwd_kernel (the Pallas backward,
// launched from _gru_pallas_bwd_impl).  Given the forward's inputs ff
// (T, B, 3H) in gate order [h | z | r], Uzr = [Uz | Ur] (H, 2H), Uh (H, H),
// mask (B, H), its output h (T, B, H) and the gradient g of h (T, B, H), it
// returns
//
//     dff  (T, B, 3H)  [da | da_z | da_r] of every step, in ff's order
//     dUzr (H, 2H)     sum over t, b of h_prev^T [da_z | da_r]
//     dUh  (H, H)      sum over t, b of (r * h_prev)^T da
//     dmask (B, H)     sum over t of dhc * act(a)
//
// walking time backwards with h_prev[t] = h[t - 1] (zeros at t = 0), the
// gates recomputed from h_prev:
//
//     z, r = sigmoid(ff_z, ff_r + h_prev @ Uzr),  a = ff_h + (r h_prev) @ Uh
//     gh   = g[t] + dh                            dh carried from step t + 1
//     da_z = gh * (h_prev - act(a) * m) * z * (1 - z)
//     dhc  = gh * (1 - z),  da = dhc * m * act'(a)
//     drh  = da @ Uh^T,  da_r = drh * h_prev * r * (1 - r)
//     dh   = gh * z + drh * r + [da_z | da_r] @ Uzr^T     for step t - 1
//
// with act = relu (kAct 0, act' = [a > 0]) or tanh (kAct 1, act' =
// 1 - tanh(a)^2).  All tensors are float32 and contiguous; the caller also
// passes a scratch rh (T, B, H) for r * h_prev, the partial-sum buffer
// pbuf (tpk_gru_bwd_plan's floats) and one zeroed barrier word.  Every
// step of T runs (the Pallas kernel pads T to its time block and runs the
// padded steps first, which adds nothing).
//
// Design: K2b's (lstm_bwd.cu), with the GRU's two dependent exchanges a
// step.  Three stages on one stream.
// 1. The gate remat, off the chain (gru_remat.cuh, two launches): z, r and
//    a for all T * B rows, written into dff, and r * h_prev into rh.  The
//    chain overwrites each gate in place with its gradient: each element
//    is read and then rewritten by the same thread.
// 2. The dh chain, one persistent cooperative launch on K2f/K2b's grid: P
//    CTAs, CTA q owning u consecutive hidden units S_q (u the smallest
//    number with P = ceil(H / u) <= the SM count: u = 5, P = 110 at
//    H = 550; u = 8, P = 128 at H = 1024; the last CTA may own fewer).  A
//    grid the card cannot hold at once is refused, not run.  Each CTA
//    keeps its column slices Uh[:, S_q] and [Uz | Ur][:, S_q] in shared
//    memory for all T steps, packed once per call from Uh and Uzr in the
//    layout K3f reads too (gru_slices.cuh): row k holds Uh[k, S_q] in
//    ceil(u / 4) 16-byte words, then Uz[k, j], Ur[k, j] side by side for
//    j in S_q in ceil(2u / 4) words, the row padded to an odd number of
//    words (44 KB at H = 550, 115 KB at H = 1024).  Per reverse step t:
//    (a) the cell: one thread per (batch row b, owned unit j) reads a, z,
//        r from dff[t], h_prev and g[t] (loaded while the exchange of the
//        step before is staged), adds that exchange's partial sums to
//        dh[b, j], forms gh, da, da_z, dhc and dmask in registers and
//        writes da and da_z to dff[t] and to shared memory, laid out as U's
//        rows (da in the first words, da_z beside the zeros that da_r
//        fills in (c)).
//    (b) the partial drh sums: part_q[b, k] = sum over j in S_q of
//        da[b, j] Uh[k, j] for all k < H (B x H outputs of depth u), on
//        K2b's product tiling and its staged write-out to a buffer laid
//        out by reader, pA[k's CTA][q][b][u]; then grid barrier 1.
//    (c) CTA q stages pA[q][p] for all p with cp.async.cg (L2 only),
//        chunks of producers double-buffered, and sums them over p in
//        ascending order: drh for its own units; da_r = drh h_prev r
//        (1 - r) into dff[t] and beside da_z in shared memory.
//    (d) the partial dh sums of [da_z | da_r] @ Uzr^T, depth 2u, as (b)
//        into a second buffer pB; then grid barrier 2.
//    (e) the next step's (a) sums pB as (c) sums pA, onto gh z + drh r.
//    The da_z part of (d) stays after barrier 1: moving it ahead would
//    need the B x H partial sums a CTA forms held across the barrier (35
//    KB at B = 16, H = 550; the CTA's shared memory holds U and the
//    staging) or a third buffer and a third read, for a product of depth
//    u a step (~1 us of K2b's 3.4-us product of depth 4u).  No CTA split
//    or grouping like K4b's was taken: the exchanged bytes are K2b's per
//    exchange (B x H floats written and read a CTA, 35 KB at B = 16,
//    H = 550), and K4b's groups paid at H = 1024 and B = 32, where a
//    CTA's partial sums were 128 KB each way.
//    Why pA and pB need no ping-pong of their own: a step writes pA at
//    (b), reads it at (c), writes pB at (d) and reads it at (e) of the
//    step after.  Every CTA's read of pA at step t comes before its
//    arrival at barrier 2 of step t, and the next write of pA (step
//    t - 1, (b)) comes after that barrier; every read of pB (step t - 1,
//    (e)) comes before the arrival at barrier 1 of step t - 1, and the
//    next write of pB (step t - 1, (d)) after it.  So each buffer's reads
//    end before its next writes begin, each separated by the other
//    exchange's barrier: the two buffers are the ping-pong pair.  The last
//    step of a pass writes no pB and ends at barrier 2 all the same, but
//    the launch's last, since the next pass's first (b) rewrites pA.  The
//    barrier counter grows by 2P a step.  The reads go through
//    cp.async.cg, so no stale L1 line of a buffer is read.
//    A pass holds at most 128 batch rows (and at most 1024 / u, so that a
//    thread holds at most 4 cells); more rows run as further passes in the
//    same launch, each from dh = 0.
// 3. dUzr = h_prev^T [da_z | da_r] and dUh = rh^T da over the T * B rows:
//    two calls of the deterministic tiled pass of du_tile.cuh.
// Every sum runs in a fixed order (no float atomics), so two calls on the
// same inputs give the same bits.
//
// What bounds it.  U stays in shared memory, the remat and dU are parallel
// GEMM passes (2 T B H 3H flops each), and a step of the chain costs its
// share of two products (B x 3u x H fmaf a CTA: 132 K at B = 16, H = 550),
// two exchanges, two grid barriers and the cell.
// tpukaldi_torch/tools/gru_bwd_phases.py, which cuts these phases out of
// this source, split a call at (T, B, H) = (778, 16, 550) on an H100 at
// 700 W into 14.7 ms: the remat 0.9, dU 2.8 and the chain 11.0, 14.2 us a
// step (the two products 4.8, the two exchanges 3.5, the two grid
// barriers 2.9, the cell and the rest 2.9).  Each product's tile loop
// takes ~2.4 us where its instructions at full rate need ~0.6: latency,
// with 8 warps an SM.

#include <cuda_runtime.h>

#include "du_tile.cuh"
#include "gru_remat.cuh"
#include "gru_slices.cuh"
#include "persist_grid.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // as K3f's limit
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

__device__ __forceinline__ float sigmoid_grad(float s) {
  return s * (1.0f - s);
}

struct Params {
  const float* h;
  const float* g;
  const float* uh;
  const float* uzr;
  const float* mask;
  float* dff;     // in: [a | z | r]; out: [da | da_z | da_r]
  float* dmask;
  float* pbuf;    // pA then pB, each [P][P][mmax][u]: the partial sums
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

// U's slices, this step's [da | da_z, da_r] of the CTA's units, and two
// staged chunks of partial sums
inline size_t smem_bytes(int kp, int u, int mmax, int pc) {
  const size_t ld = tpk::gru_row_floats(u);
  const size_t floats = (static_cast<size_t>(kp) + mmax) * ld
                        + 2 * static_cast<size_t>(pc) * mmax * u;
  return floats * sizeof(float);
}

template <int kAct>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_seq_kernel(const Params p) {
  const int H = p.H, kp = p.kp, u = p.u;
  const int P = gridDim.x;
  const int me = blockIdx.x;
  const int unit0 = me * u;
  const int up = min(u, H - unit0);  // units this CTA owns
  const int tid = threadIdx.x;
  const int ld = tpk::gru_row_floats(u);
  const int wh = tpk::gru_uh_words(u);    // words of the drh product
  const int wzr = tpk::gru_uzr_words(u);  // words of the dh product
  const int zr0 = 4 * wh;            // a row's first [Uz, Ur] float
  const size_t three_h = 3 * static_cast<size_t>(H);

  float* us = reinterpret_cast<float*>(tpk::dynamic_smem());  // kp x ld
  float* das = us + static_cast<size_t>(kp) * ld;             // mmax x ld
  float* stg = das + static_cast<size_t>(p.mmax) * ld;  // 2 x pc x mmax x u

  // U's slices, with the padding and the cells' rows (of which a short
  // pass leaves some unwritten) zeroed
  tpk::load_gru_slices(us, kp + p.mmax, p.uh, p.uzr, H, u, unit0, up);

  const size_t blk = static_cast<size_t>(p.mmax) * u;  // one producer's block
  const size_t buf_elems = static_cast<size_t>(P) * P * blk;
  float* const pA = p.pbuf;
  float* const pB = p.pbuf + buf_elems;
  const size_t chunk_elems = static_cast<size_t>(p.pc) * blk;
  const int nchunks = (P + p.pc - 1) / p.pc;
  // the products' partial sums are staged for qgroup readers at a time in
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

    float dm[kMaxPos], m[kMaxPos], dhn[kMaxPos];
#pragma unroll
    for (int i = 0; i < kMaxPos; ++i) {
      const int q = tid + i * kThreads;
      dm[i] = 0.0f;
      m[i] = 0.0f;
      dhn[i] = 0.0f;
      if (q < npos) {
        const int b = q / up;
        m[i] = p.mask[static_cast<size_t>(b0 + b) * H + unit0 + q - b * up];
      }
    }

    // stage producers [ch * pc, ch * pc + pc) of this CTA's blocks in src
    auto stage = [&](const float* src, int ch) {
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
    // acc[i] += the partial sums of the cell i's unit in src over the
    // producers in ascending order; chunk 0 is already in flight
    auto gather = [&](const float* src, float (&acc)[kMaxPos]) {
      for (int ch = 0; ch < nchunks; ++ch) {
        if (ch + 1 < nchunks) {
          stage(src, ch + 1);
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
              acc[i] += x[static_cast<size_t>(pp) * mp * u];
            }
          }
        }
        __syncthreads();  // the buffer is staged again two chunks on
      }
    };
    // partial sums over the CTA's words [w0, w1) of the cells' rows times
    // U's rows, for every row k < H, into each reader's block of dst: a
    // group of readers at a time, into shared memory in the readers'
    // layout, then out in 16-byte words
    auto product = [&](int w0, int w1, float* dst_buf) {
      float* dst = dst_buf + me * blk;
      for (int q0 = 0; q0 < P; q0 += qgroup) {
        const int nq = min(qgroup, P - q0);
        const int k0 = q0 * u;
        const int kn = min(H, k0 + nq * u) - k0;  // rows k of the group
        const int kq = (kn + kCols - 1) / kCols;
        const int ntile = tr_n * kq;  // tiles of kRows rows x kCols rows k
        for (int tile = tid; tile < ntile; tile += kThreads) {
          // rows b fastest: a warp's lanes share few rows k of U (a
          // broadcast load) and few rows b of the cells
          const int tk = tile / tr_n;
          const int tr = tile - tk * tr_n;
          float acc[kRows][kCols];
#pragma unroll
          for (int x = 0; x < kRows * kCols; ++x) acc[x / kCols][x % kCols] = 0.0f;
          for (int w = w0; w < w1; ++w) {
            float4 dv[kRows], uw[kCols];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              dv[i] = *reinterpret_cast<const float4*>(
                  das + (tr + i * tr_n) * ld + 4 * w);
            }
#pragma unroll
            for (int d = 0; d < kCols; ++d) {
              uw[d] = *reinterpret_cast<const float4*>(
                  us + static_cast<size_t>(k0 + tk + d * kq) * ld + 4 * w);
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
    };
    auto grid_barrier = [&]() {
      tpk::grid_arrive(p.bar);
      arrived += gridDim.x;
      tpk::grid_wait(p.bar, arrived);
    };

    for (int t = p.T - 1; t >= 0; --t) {
      const bool exchange = t + 1 < p.T;
      const float* srcB = pB + static_cast<size_t>(me) * P * blk;
      if (exchange) stage(srcB, 0);

      // this step's gates, h_prev and g, in flight while the partial sums
      // of the step before are staged and added
      float ga[kMaxPos], gz[kMaxPos], gr[kMaxPos], hp[kMaxPos], gg[kMaxPos];
      float dh[kMaxPos];
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        dh[i] = dhn[i];
        if (q < npos) {
          const int b = q / up;
          const int j = unit0 + q - b * up;
          const size_t row = static_cast<size_t>(t) * p.B + b0 + b;
          ga[i] = p.dff[row * three_h + j];
          gz[i] = p.dff[row * three_h + H + j];
          gr[i] = p.dff[row * three_h + 2 * H + j];
          hp[i] = t > 0 ? p.h[(row - p.B) * H + j] : 0.0f;
          gg[i] = p.g[row * H + j];
        }
      }
      if (exchange) gather(srcB, dh);

      // (a) the cell: da and da_z of (b, j) into dff[t] (over a and z just
      // read) and into shared memory for the drh product
      float gzk[kMaxPos], rf[kMaxPos];
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        gzk[i] = 0.0f;
        rf[i] = 0.0f;
        if (q < npos) {
          const int b = q / up;
          const int jj = q - b * up;
          const float a = ga[i], z = gz[i], r = gr[i];
          const float act = kAct == 0 ? fmaxf(a, 0.0f) : tanhf(a);
          const float dact = kAct == 0 ? (a > 0.0f ? 1.0f : 0.0f)
                                       : 1.0f - act * act;
          const float gh = gg[i] + dh[i];
          const float da_z = gh * (hp[i] - act * m[i]) * sigmoid_grad(z);
          const float dhc = gh * (1.0f - z);
          const float da = dhc * m[i] * dact;
          const size_t row = static_cast<size_t>(t) * p.B + b0 + b;
          float* d = p.dff + row * three_h + unit0 + jj;
          d[0] = da;
          d[H] = da_z;
          das[b * ld + jj] = da;
          das[b * ld + zr0 + 2 * jj] = da_z;
          dm[i] = fmaf(dhc, act, dm[i]);
          gzk[i] = gh * z;
          rf[i] = hp[i] * sigmoid_grad(r);
        }
      }
      __syncthreads();  // da of the CTA's units complete

      // (b) partial drh sums, then barrier 1
      product(0, wh, pA);
      grid_barrier();

      // (c) drh of the CTA's units, summed over the producers; da_r
      float drh[kMaxPos];
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) drh[i] = 0.0f;
      stage(pA + static_cast<size_t>(me) * P * blk, 0);
      gather(pA + static_cast<size_t>(me) * P * blk, drh);
#pragma unroll
      for (int i = 0; i < kMaxPos; ++i) {
        const int q = tid + i * kThreads;
        if (q < npos) {
          const int b = q / up;
          const int jj = q - b * up;
          const float da_r = drh[i] * rf[i];
          const size_t row = static_cast<size_t>(t) * p.B + b0 + b;
          p.dff[row * three_h + 2 * H + unit0 + jj] = da_r;
          das[b * ld + zr0 + 2 * jj + 1] = da_r;
          dhn[i] = gzk[i] + drh[i] * gr[i];
        }
      }

      // (d) partial dh sums of [da_z | da_r] @ Uzr^T for step t - 1, then
      // barrier 2 (also after a pass's last step, but the launch's last:
      // the next pass's first product rewrites pA)
      if (t > 0) {
        __syncthreads();  // da_r of the CTA's units complete
        product(wh, wh + wzr, pB);
      }
      if (t > 0 || !last_pass) grid_barrier();
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

// the chain's kernel for act 0 (relu) or 1 (tanh)
inline void (*chain_kernel(int act))(const Params) {
  return act == 0 ? gru_bwd_seq_kernel<0> : gru_bwd_seq_kernel<1>;
}

// The sequential launch's shape for (B, H) on the current device, and
// whether the card can hold its grid at once; returns a CUDA error code
// (0: fits).
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
  const auto kernel = chain_kernel(act);
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

extern "C" int tpk_gru_bwd_max_hidden() { return kMaxHidden; }

// out[0..4] = (CTAs, units a CTA, shared-memory bytes a CTA, producers'
// partial sums staged at a time, floats of the pbuf scratch) of the
// sequential launch for (B, H); returns make_plan's code.
extern "C" int tpk_gru_bwd_plan(int B, int H, int* out) {
  Plan pl;
  const int err = make_plan(B, H, 1, &pl);
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

// act: 0 relu, 1 tanh.  Launches the three stages on `stream` and returns
// the first error: a grid the card cannot hold at once
// (cudaErrorCooperativeLaunchTooLarge, before anything runs), or what a
// launch reports (a refused launch never runs, and only this value reports
// it).  rh_scratch is (T, B, H) float32; pbuf holds the plan's floats
// (tpk_gru_bwd_plan, out[4]), any contents; bar is one unsigned word,
// zeroed by the caller.
extern "C" int tpk_gru_bwd(const float* ff, const float* h, const float* g,
                           const float* uzr, const float* uh,
                           const float* mask, float* dff, float* duzr,
                           float* duh, float* dmask, float* rh_scratch,
                           float* pbuf, void* bar, int T, int B, int H,
                           int act, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int err = make_plan(B, H, act, &pl);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  err = static_cast<int>(tpk::launch_gru_remat(h, B, uzr, uh, ff, dff,
                                               rh_scratch, T * B, H, stream));
  if (err != 0) return err;
  Params prm{h, g, uh, uzr, mask, dff, dmask, pbuf, static_cast<unsigned*>(bar),
             T, B, H, pl.u, pl.kp, pl.rows, pl.mmax, pl.pc};
  void* args[] = {&prm};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      chain_kernel(act), dim3(pl.ctas), dim3(kThreads), args, pl.smem, stream);
  const cudaError_t last = cudaGetLastError();
  err = static_cast<int>(launched != cudaSuccess ? launched : last);
  if (err != 0) return err;
  err = static_cast<int>(
      tpk::launch_du(h, B, dff, 3 * H, H, 2 * H, duzr, T * B, H, stream));
  if (err != 0) return err;
  return static_cast<int>(
      tpk::launch_du(rh_scratch, 0, dff, 3 * H, 0, H, duh, T * B, H, stream));
}
