// LSTM backward recurrence with a bf16 recurrent weight, for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/lstm.py::_lstm_lean_bwd_kernel (the Pallas
// backward of the "lean" LSTM, the QLSTM's, launched from
// _lstm_lean_bwd_impl).  Given the forward's inputs ff (T, B, 4H),
// U = [Uf | Ui | Uo | Uc] (H, 4H) and mask (B, H), its outputs h and c
// (T, B, H) and the gradient g of h (T, B, H), it returns
//
//     dff (T, B, 4H)   dA_t = [da_f | da_i | da_o | da_c] of every step
//     dmask (B, H)     sum over t of dc * i * cand
//
// walking time backwards with h_prev[t] = h[t - 1], c_prev[t] = c[t - 1]
// (zeros at t = 0), the gates recomputed from h_prev with the forward's
// bf16 products:
//
//     a = ff + bf16(h_prev) @ bf16(U);  f, i, o = sigmoid(a_f, a_i, a_o);
//     cand = tanh(a_c)
//     gh   = g[t] + dh                            dh, dc carried from t + 1
//     da_o = gh * tanh(c) * o * (1 - o)
//     dc   = gh * o * (1 - tanh(c)^2) + dc
//     da_f = dc * c_prev * f * (1 - f)
//     da_i = dc * cand * m * i * (1 - i)
//     da_c = dc * i * m * (1 - cand^2)
//     dh   = bf16(dA) @ bf16(U)^T,  dc = dc * f       for step t - 1
//
// Every product is exact in float32 and summed in float32, as the Pallas
// kernel's bf16 dots with float32 accumulation.  dU = h_prev^T dff is not
// formed here: like tpukaldi's _lean_bwd, the wrapper contracts it as one
// float32 GEMM over the T * B rows afterwards.  ff, c, g, mask, dff and
// dmask are float32 through tpk_lstm_lean_bwd.  tpk_lstm_lean_bwd_bf16 is
// the bf16 compute mode's entry (tpukaldi's kernel reads ff in its native
// dtype and writes dff in it): ff and dff are bf16 there, the remat widens
// ff as it loads it and writes the gates to a float32 buffer the caller
// gives (the gates then the float32 dA, as dff is in the float32 entry),
// and the chain writes dff = dA rounded to nearest even, the value its own
// product takes as bf16 operand; so dff is the float32 entry's on the
// widened ff, rounded, bit for bit.  The wrapper passes three bf16 operands, made once per
// call: hp (T B, hk), hp[r] = h_prev of row r = t B + b, hk = H padded to
// 32 with zeros; u16 (hk, 4H padded to 8), U with zero padding; and upk
// (H, H, 4), upk[k, j, g] = U[k, gH + j], K4f's own packing
// (lstm_lean_fwd.cu).  Every step of T runs (the Pallas kernel pads T to
// its time block and runs the padded steps first, which adds nothing).
//
// Design: three launches, as the float32 LSTM backward (lstm_bwd.cu), with
// the products on the tensor cores (mma_bf16.cuh: ldmatrix,
// mma.sync.m16n8k16, bf16 operands, float32 accumulators) and the dh
// chain's CTAs in groups that share their dA, so that few partial sums
// cross the card.
// 1. The gate remat, off the chain: nothing in a = ff + bf16(h_prev) @
//    bf16(U) depends on the dh chain, so one tiled GEMM forms it for all
//    T * B rows at once (the Pallas kernel's phase 1 over the whole
//    sequence).  A block owns a 128 x 128 tile of a, a warp 64 x 32;
//    the depth runs in stages of 32, double-buffered with cp.async.  Its
//    epilogue writes the activations f, i, o, cand into dff; the chain
//    overwrites them in place with dA (each element read and rewritten by
//    the same thread), so no (T, B, 4H) buffer is added.
// 2. The dh chain, one persistent cooperative launch.  CTA p owns u
//    consecutive hidden units, u the smallest even number with
//    ceil(H / u) <= the SM count, as K4f's CTAs do (u = 8 at H = 1024; the
//    last CTAs may own fewer, or none).  The CTAs form S groups of R, CTA
//    (r, s) = p = s R + r, so group s owns the R u units from s R u, and
//    the plan takes the R x S that moves the fewest bytes (make_plan; R =
//    13, S = 10 at H = 1024 on an H100).  CTA (r, s) keeps in shared memory
//    for all T steps the bf16 U[k, gH + j] of the rows k that CTA r of
//    every group owns (S u rows) and the columns of its own group's units
//    j (4 R u), from K4f's packing upk (64 KB at H = 1024; 4 H^2 / P
//    elements whatever R and S).  A grid the card cannot hold at once is
//    refused, not run.  Per reverse step t:
//    (a) the cell: one thread per (batch row b, owned unit j) reads the
//        gates from dff[t] and c[t], c[t - 1], g[t] (loaded when the step
//        starts, in flight while the exchange is staged), adds the S
//        partial dh sums of the step before, forms dA for j's four gate
//        columns and writes them to dff[t] and their bf16 operands to its
//        group's row of dabuf; dc and dmask stay in registers.
//    (b) one barrier of the group's R CTAs (persist_grid.cuh's, on the
//        group's counter), then the group's dA (rows b x 4 R u) staged in
//        shared memory with cp.async.cg.
//    (c) the partial dh product on the tensor cores: part_s[b, k] = sum
//        over the group's units j and gates g of bf16(dA[b, gH + j])
//        bf16(U[k, gH + j]) for the CTA's S u rows k: M = the pass's rows,
//        N = S u, depth 4 R u.  The U slice, rows k with (j, g) contiguous,
//        is the column-major B operand that mma.sync's row.col wants, so
//        plain ldmatrix loads it.  A warp takes 16 rows k at a time for
//        every row tile and stores its accumulators straight from the
//        registers: float2 words (k and k + 1, the same reader's, as u is
//        even) into a global ping-pong buffer laid out by the CTA that
//        reads them, pbuf[t & 1][reader][s][b][u], each warp store covering
//        whole 32-byte sectors.  The addresses are set before the time loop
//        and advanced by constant strides, and the buffer has room for the
//        padding rows k and b of the tiles, so a step of the product issues
//        little besides its ldmatrix, mma and stores.
//    (d) one grid barrier.  Then CTA q stages its S blocks with cp.async.cg
//        (L2 only, so no stale L1 line is read), in chunks that fit its
//        shared memory, double-buffered, and sums them over s in ascending
//        order: dh for its own units.
//    Per step and batch row a CTA writes S u partial sums and 4u bf16 dA
//    and reads S u partial sums and 4 R u bf16 dA: at (B, H) = (32, 1024)
//    about 12 KB out and 36 KB in, where groups of one CTA (R = 1: partial
//    sums over all H rows k, the float32 backward's design) write and read
//    128 KB each, and one group (S = 1: every CTA reads all of dA, K4f's
//    broadcast turned around) cannot hold dA's 256 KB in shared memory.
//    A pass holds at most 128 batch rows (and at most 1024 / u, so that a
//    thread holds at most 4 cells); more rows run as further passes in the
//    same launch, each from dh = dc = 0.
// 3. dU: the wrapper's float32 GEMM.
// Every sum runs in a fixed order (no float atomics), so two calls on the
// same inputs give the same bits.  The remat sums in the tensor cores'
// order per 16-deep step, then over the steps in ascending order; K4f sums
// per warp and then across warps, so the gates agree with the forward's to
// the float32 sum order, not bit for bit (the operands are the same).
//
// What bounds it.  The remat is 2 T B H 4H flops (209 GFLOP at (T, B, H) =
// (778, 32, 1024): 0.21 ms at the card's bf16 peak) and reads ff and
// writes dff (2 x 408 MB, 0.24 ms at 3.35 TB/s).  A step of the chain is a
// latency chain: the exchange, the cell, the group's barrier and dA, the
// product (B x 4 R u x S u, 2.1 MFLOP a CTA at that shape) and the grid
// barrier.  tpukaldi_torch/tools/lstm_lean_bwd_phases.py, which cuts these
// phases out of this source, times them (PERF.md, section 6).  The
// one-CTA-per-row design this replaces re-read U twice from L2 every step
// (16 MB per CTA per step at H = 1024) and formed the gates with a
// sequential fmaf chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "lstm_lean_cell.cuh"
#include "mma_bf16.cuh"
#include "persist_grid.cuh"

namespace {

constexpr int kMaxHidden = 1024;  // as K4f's limit
// bf16 padding of a row in shared memory: 16 bytes, so that the 8 rows of
// an ldmatrix fall in distinct banks
constexpr int kSkew = 8;

// ---------------------------------------------------------------- remat
constexpr int kRmRows = 128;     // rows r of a block's tile
constexpr int kRmCols = 128;     // columns of a block's tile
constexpr int kRmDepth = 32;     // depth k of a stage; hp's row length pads H to it
constexpr int kRmThreads = 256;  // 8 warps, 2 x 4 warp tiles of 64 x 32
constexpr int kRmALd = kRmDepth + kSkew;
constexpr int kRmBLd = kRmCols + kSkew;

__host__ __device__ constexpr int round_to(int x, int m) { return (x + m - 1) / m * m; }

// two consecutive elements of ff, widened to float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// out[r, n] = gate_n(ff[r, n] + sum_k hp[r, k] u16[k, n]) for r < R,
// n < 4H: gate_n the sigmoid for n < 3H, tanh after.  hp is (R, hk) and
// u16 (hk, ldu) bf16, zero-padded (hk = H padded to kRmDepth, ldu = 4H
// padded to 8); ff (R, 4H) float32 or bf16 (FF), out (R, 4H) float32.
template <typename FF>
__global__ void __launch_bounds__(kRmThreads)
lstm_lean_remat_kernel(const __nv_bfloat16* __restrict__ hp,
                       const __nv_bfloat16* __restrict__ u16,
                       const FF* __restrict__ ff, float* __restrict__ out,
                       int R, int H) {
  __shared__ __align__(16) __nv_bfloat16 a_tile[2][kRmRows * kRmALd];   // [r][k]
  __shared__ __align__(16) __nv_bfloat16 b_tile[2][kRmDepth * kRmBLd];  // [k][n]
  const int N = 4 * H;
  const int hk = round_to(H, kRmDepth);
  const int ldu = round_to(N, 8);
  const int r0 = blockIdx.y * kRmRows;
  const int c0 = blockIdx.x * kRmCols;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wr = (warp / 4) * 64;  // the warp tile's first row
  const int wc = (warp % 4) * 32;  // and first column

  // a stage: 128 rows x 32 of hp and 32 rows x 128 columns of u16, 16 bytes
  // a copy, two copies of each a thread; rows past R and columns past ldu
  // read the last ones (their results are not stored)
  auto stage = [&](int s, int k0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kRmThreads;
      const int row = i / 4;
      const int part = i % 4;
      const int src = min(r0 + row, R - 1);
      tpk::cp_async16_cg(a_tile[s] + row * kRmALd + part * 8,
                         hp + static_cast<size_t>(src) * hk + k0 + part * 8);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kRmThreads;
      const int kr = i / 16;
      const int col = min(c0 + (i % 16) * 8, ldu - 8);
      tpk::cp_async16_cg(b_tile[s] + kr * kRmBLd + (i % 16) * 8,
                         u16 + static_cast<size_t>(k0 + kr) * ldu + col);
    }
    tpk::cp_async_commit();
  };

  float acc[4][4][4];  // [row tile][8-column tile][fragment]
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x / 16][x / 4 % 4][x % 4] = 0.0f;

  const int nk = hk / kRmDepth;
  stage(0, 0);
  for (int ks = 0; ks < nk; ++ks) {
    if (ks + 1 < nk) {
      stage((ks + 1) & 1, (ks + 1) * kRmDepth);
      tpk::cp_async_wait<1>();
    } else {
      tpk::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a = a_tile[ks & 1] + (wr + lane % 16) * kRmALd + (lane / 16) * 8;
    const __nv_bfloat16* b = b_tile[ks & 1] + (lane % 16) * kRmBLd + wc + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < kRmDepth / 16; ++kk) {
      unsigned fa[4][4], fb[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) tpk::ldsm_x4(fa[mi], a + mi * 16 * kRmALd + kk * 16);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) tpk::ldsm_x4_trans(fb[nj], b + kk * 16 * kRmBLd + nj * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          tpk::mma_16816(acc[mi][2 * nj], fa[mi], fb[nj][0], fb[nj][1]);
          tpk::mma_16816(acc[mi][2 * nj + 1], fa[mi], fb[nj][2], fb[nj][3]);
        }
      }
    }
    __syncthreads();  // the buffer is staged again next stage
  }

  // lane holds rows lane / 4 and + 8, columns 2 (lane % 4) and + 1 of each
  // 16 x 8 tile: a float2 of ff in, of gates out (N is even)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c0 + wc + nt * 8 + 2 * (lane % 4);
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + wr + mi * 16 + lane / 4 + 8 * half;
        if (r >= R) continue;
        const size_t at = static_cast<size_t>(r) * N + col;
        const float2 x = load2(ff + at);
        const float a0 = x.x + acc[mi][nt][2 * half];
        const float a1 = x.y + acc[mi][nt][2 * half + 1];
        *reinterpret_cast<float2*>(out + at) = make_float2(
            col < 3 * H ? tpk::lean_sigmoid(a0) : tanhf(a0),
            col + 1 < 3 * H ? tpk::lean_sigmoid(a1) : tanhf(a1));
      }
    }
  }
}

template <typename FF>
cudaError_t launch_remat(const __nv_bfloat16* hp, const __nv_bfloat16* u16,
                         const FF* ff, float* out, int R, int H,
                         cudaStream_t stream) {
  const dim3 grid((4 * H + kRmCols - 1) / kRmCols, (R + kRmRows - 1) / kRmRows);
  lstm_lean_remat_kernel<FF><<<grid, kRmThreads, 0, stream>>>(hp, u16, ff, out, R, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- chain
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;   // batch rows of one pass
constexpr int kMaxUnits = 16;   // hidden units one CTA may own
constexpr int kMaxPos = 4;      // cells a thread holds: (b, j) pairs

// error code for a grid that cannot be resident at once
constexpr int kErrNotResident = static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

struct Params {
  const float* c;
  const float* g;
  const __nv_bfloat16* upk;
  const float* mask;
  float* dff;     // in: the gates; out: dA (float32 entry)
  __nv_bfloat16* dff16;  // bf16 entry: dA rounded (dff then holds the
                         // gates and is not written); null otherwise
  float* dmask;
  float* pbuf;    // [2][Q R][S][mmax][u]: the partial dh sums, a block from
                  // every group for every u of a CTA's kl rows k (Q = kl / u
                  // rounded up; the readers are the first S R)
  __nv_bfloat16* dabuf;  // [S][mmax][nc]: each group's bf16 dA, zero at launch
  unsigned* bar;  // [1 + S]: the grid barrier's arrival counter, then each
                  // group's, zero at launch
  int T, B, H;
  int u;     // hidden units a CTA owns (even; the last CTAs may own fewer)
  int R, S;  // CTAs of a group, groups
  int kl;    // rows k of a CTA's U slice: S u, padded to 16
  int nc;    // columns of a group's dA and of the U slice: 4 R u, padded to 16
  int rows;  // batch rows of a pass
  int mmax;  // rows of the largest pass, padded to 16
  int pc;    // groups' blocks of partial sums staged at a time
};

struct Plan {
  int u, R, S, kl, nc, rows, mmax, pc;
  size_t smem, pbuf, dabuf;
};

// U's slice, this step's bf16 dA of the group, and two staged chunks of
// partial sums
inline size_t smem_bytes(int kl, int nc, int mmax, int u, int pc) {
  const size_t ld = nc + kSkew;
  return (static_cast<size_t>(kl) + mmax) * ld * 2
         + 2 * static_cast<size_t>(pc) * mmax * u * 4;
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_lean_bwd_seq_kernel(const Params p) {
  const int H = p.H, u = p.u, R = p.R, S = p.S, kl = p.kl, nc = p.nc;
  const int me = blockIdx.x;  // CTA r of group s: me = s R + r
  const int grp = me / R;
  const int rk = me - grp * R;
  const int unit0 = me * u;
  const int up = max(0, min(u, H - unit0));  // units this CTA owns
  const int gu0 = grp * R * u;               // the group's first unit
  const int gnu = max(0, min(R * u, H - gu0));  // and its units
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ld = nc + kSkew;
  const size_t four_h = 4 * static_cast<size_t>(H);

  unsigned char* smem = tpk::dynamic_smem();
  __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(smem);  // kl x ld: [k][4 j + g]
  __nv_bfloat16* das = us + static_cast<size_t>(kl) * ld;      // mmax x ld: [b][4 j + g]
  float* stg = reinterpret_cast<float*>(das + static_cast<size_t>(p.mmax) * ld);

  // U's slice: rows k of the blocks of u units that CTA r of every group
  // owns (row x is unit (x / u R + r) u + x % u), columns the group's units'
  // gates.  Zero the padding, then copy each real row's 8 gnu bytes, two
  // units (16 bytes) a copy where H is even (then every piece is 16-byte
  // aligned), one unit (8 bytes) otherwise
  for (int i = tid; i < (kl + p.mmax) * ld; i += kThreads) us[i] = __float2bfloat16_rn(0.0f);
  __syncthreads();
  const int vec = (H % 2 == 0) ? 2 : 1;
  const int pieces = gnu / vec;
  for (int i = tid; i < kl * pieces; i += kThreads) {
    const int x = i / pieces;
    const int v = (i - x * pieces) * vec;
    const int k = (x / u * R + rk) * u + x % u;
    if (x >= S * u || k >= H) continue;
    const __nv_bfloat16* src = p.upk + (static_cast<size_t>(k) * H + gu0 + v) * 4;
    __nv_bfloat16* dst = us + static_cast<size_t>(x) * ld + v * 4;
    if (vec == 2) {
      tpk::cp_async16_cg(dst, src);
    } else {
      tpk::cp_async8(dst, src);
    }
  }
  tpk::cp_async_commit();
  tpk::cp_async_wait<0>();
  __syncthreads();

  const size_t blk = static_cast<size_t>(p.mmax) * u;  // one group's block
  // a CTA's readers' blocks: reader (q R + rk) for its rows x = q u ...,
  // q_stride floats apart; the buffer has room for the padding rows of
  // kl, so the product stores them without a test
  const int q_stride = R * S * static_cast<int>(blk);
  const size_t buf_elems = static_cast<size_t>((kl + u - 1) / u) * q_stride;
  const size_t chunk_elems = static_cast<size_t>(p.pc) * blk;
  const int nchunks = (S + p.pc - 1) / p.pc;
  const int ksteps = nc / 16;
  const int ntiles = kl / 16;  // 16 rows k of the slice a tile
  // the product's constants: this lane's ldmatrix rows of U and of dA, and
  // the block q and unit i of its columns x = warp 16 + hf 8 + 2 (lane %
  // 4) in the warp's first tile of 16 rows, which a warp advances by
  // kWarps 16 rows a tile
  const __nv_bfloat16* u_lane = us + (lane % 16) * ld + (lane / 16) * 8;
  const __nv_bfloat16* a_lane = das + (lane % 16) * ld + (lane / 16) * 8;
  int q0[2], i0[2];
  for (int hf = 0; hf < 2; ++hf) {
    const int x = warp * 16 + hf * 8 + 2 * (lane % 4);
    q0[hf] = x / u;
    i0[hf] = x - q0[hf] * u;
  }
  const int dq = kWarps * 16 / u;
  const int di = kWarps * 16 - dq * u;
  // this lane's row b in a block, in this CTA's block of every reader
  const int row_off = (rk * S + grp) * static_cast<int>(blk) + (lane / 4) * u;
  unsigned* gbar = p.bar + 1 + grp;
  unsigned arrived = 0;   // the grid barrier counter's value at the last barrier
  unsigned garrived = 0;  // and the group's

  for (int b0 = 0; b0 < p.B; b0 += p.rows) {
    const int rows = min(p.rows, p.B - b0);
    const bool last_pass = b0 + p.rows >= p.B;
    const int mp = (rows + 15) / 16 * 16;
    const int npos = rows * up;
    const int per_blk = mp * u / 4;  // 16-byte words of a block this pass
    const int mt = mp / 16;          // the product's tiles of rows b

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
      const float* src = p.pbuf + ((t + 1) & 1) * buf_elems + me * S * blk;

      // stage groups [ch * pc, ch * pc + pc) of the pass's rows
      auto stage = [&](int ch) {
        const int p0 = ch * p.pc;
        const int n = min(p.pc, S - p0) * per_blk;
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
          for (int gt = 0; gt < 4; ++gt) gv[i][gt] = p.dff[row * four_h + gt * H + j];
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
          const int n_ch = min(p.pc, S - ch * p.pc);
#pragma unroll
          for (int i = 0; i < kMaxPos; ++i) {
            const int q = tid + i * kThreads;
            if (q < npos) {
              const int b = q / up;
              const float* x = buf + b * u + q - b * up;
              for (int pp = 0; pp < n_ch; ++pp) {
                dh[i] += x[static_cast<size_t>(pp) * mp * u];
              }
            }
          }
          __syncthreads();  // the buffer is staged again two chunks on
        }
      }

      // the cell: dA of (b, j) into dff[t] (over the gates just read) and
      // its bf16 operands into the group's row of dabuf
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
          const size_t at = row * four_h + unit0 + jj;
          const __nv_bfloat16 q[4] = {__float2bfloat16_rn(da_f), __float2bfloat16_rn(da_i),
                                      __float2bfloat16_rn(da_o), __float2bfloat16_rn(da_c)};
          if (p.dff16 != nullptr) {
            __nv_bfloat16* d = p.dff16 + at;
            d[0] = q[0];
            d[H] = q[1];
            d[2 * H] = q[2];
            d[3 * H] = q[3];
          } else {
            float* d = p.dff + at;
            d[0] = da_f;
            d[H] = da_i;
            d[2 * H] = da_o;
            d[3 * H] = da_c;
          }
          __nv_bfloat16* o4 = p.dabuf + (static_cast<size_t>(grp) * p.mmax + b) * nc
                              + 4 * (rk * u + jj);
          o4[0] = q[0];
          o4[1] = q[1];
          o4[2] = q[2];
          o4[3] = q[3];
          dm[i] = fmaf(dc[i] * ig, cand, dm[i]);
          dc[i] *= f;
        }
      }

      if (t > 0) {
        // the group's dA complete: one barrier of its R CTAs, then its
        // rows staged as the product's A operand
        tpk::grid_arrive(gbar);
        garrived += R;
        tpk::grid_wait(gbar, garrived);
        const __nv_bfloat16* da_src = p.dabuf + static_cast<size_t>(grp) * p.mmax * nc;
        const int per_row = nc / 8;
        for (int i = tid; i < mp * per_row; i += kThreads) {
          const int b = i / per_row;
          const int v = (i - b * per_row) * 8;
          tpk::cp_async16_cg(das + b * ld + v, da_src + static_cast<size_t>(b) * nc + v);
        }
        tpk::cp_async_commit();
        tpk::cp_async_wait<0>();
        __syncthreads();
        // the partial dh sums of the slice's rows k: rows b x depth (das)
        // times depth x rows k (us, whose rows k with the depth contiguous
        // are the B operand as it is, so the fragments of rows k .. k + 7
        // are registers 0 and 2 of an ldmatrix.x4, of rows k + 8 .. k + 15
        // registers 1 and 3), 16 rows k a warp at a time for every row
        // tile, stored from the accumulators as float2 words to their
        // readers' blocks, all addresses advanced by constant strides
        float* dst = p.pbuf + (t & 1) * buf_elems + row_off;
        int q[2] = {q0[0], q0[1]};
        int ix[2] = {i0[0], i0[1]};
        for (int nt = warp; nt < ntiles; nt += kWarps) {
          float* o0 = dst + q[0] * q_stride + ix[0];
          float* o1 = dst + q[1] * q_stride + ix[1];
          for (int mi = 0; mi < mt; ++mi) {
            float acc[2][4] = {};
            for (int kk = 0; kk < ksteps; ++kk) {
              unsigned fa[4], fb[4];
              tpk::ldsm_x4(fb, u_lane + nt * 16 * ld + kk * 16);
              tpk::ldsm_x4(fa, a_lane + mi * 16 * ld + kk * 16);
              tpk::mma_16816(acc[0], fa, fb[0], fb[2]);
              tpk::mma_16816(acc[1], fa, fb[1], fb[3]);
            }
            // rows b and b + 8 of columns k and k + 1 (the same reader's,
            // as u is even); rows past the pass's and columns past the
            // slice's land in slots no reader sums
            const int at = mi * 16 * u;
            *reinterpret_cast<float2*>(o0 + at) = make_float2(acc[0][0], acc[0][1]);
            *reinterpret_cast<float2*>(o0 + at + 8 * u) = make_float2(acc[0][2], acc[0][3]);
            *reinterpret_cast<float2*>(o1 + at) = make_float2(acc[1][0], acc[1][1]);
            *reinterpret_cast<float2*>(o1 + at + 8 * u) = make_float2(acc[1][2], acc[1][3]);
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {  // x += kWarps 16
            q[hf] += dq;
            ix[hf] += di;
            if (ix[hf] >= u) {
              ix[hf] -= u;
              ++q[hf];
            }
          }
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
// (0: fits).  Of the factorings R x S of the unit blocks whose grid and
// shared memory fit, it takes the one whose rows move the fewest bytes a
// step: a CTA's partial sums out (kl floats), its readers' in (S u) and its
// group's bf16 dA in (nc).
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
  const int nu = (H + u - 1) / u;  // blocks of u units
  pl->u = u;
  // a pass's rows: at most kMaxPos cells a thread
  const int cap = kMaxPos * kThreads / u / 16 * 16;
  pl->rows = B < kMaxRows ? B : kMaxRows;
  if (pl->rows > cap) pl->rows = cap;
  pl->mmax = round_to(pl->rows, 16);
  int best = -1;
  for (int R = 1; R <= nu; ++R) {
    const int S = (nu + R - 1) / R;
    const int kl = round_to(S * u, 16);
    const int nc = round_to(4 * R * u, 16);
    if (R * S > sms || smem_bytes(kl, nc, pl->mmax, u, 1) > static_cast<size_t>(optin)) {
      continue;
    }
    const int bytes = 4 * kl + 4 * S * u + 2 * nc;
    if (best < 0 || bytes < best || (bytes == best && R * S < pl->R * pl->S)) {
      best = bytes;
      pl->R = R;
      pl->S = S;
      pl->kl = kl;
      pl->nc = nc;
    }
  }
  if (best < 0) return kErrNotResident;
  // the staged groups halve until the shared memory fits
  pl->pc = pl->S;
  while (smem_bytes(pl->kl, pl->nc, pl->mmax, u, pl->pc) > static_cast<size_t>(optin) &&
         pl->pc > 1) {
    pl->pc = (pl->pc + 1) / 2;
  }
  pl->smem = smem_bytes(pl->kl, pl->nc, pl->mmax, u, pl->pc);
  pl->pbuf = 2 * static_cast<size_t>((pl->kl + u - 1) / u) * pl->R * pl->S * pl->mmax * u;
  pl->dabuf = static_cast<size_t>(pl->S) * pl->mmax * pl->nc;
  err = cudaFuncSetAttribute(lstm_lean_bwd_seq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl->smem));
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lstm_lean_bwd_seq_kernel, kThreads, pl->smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < pl->R * pl->S) return kErrNotResident;
  return 0;
}

int launch_chain(const Params& prm, const Plan& pl, cudaStream_t stream) {
  void* args[] = {const_cast<Params*>(&prm)};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      lstm_lean_bwd_seq_kernel, dim3(pl.R * pl.S), dim3(kThreads), args, pl.smem, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

// Both entries: the remat of ff into dff (the gates, float32), then the
// chain, which rewrites dff with dA or, given dff16, writes dA rounded there.
template <typename FF>
int run(const FF* ff, const float* c, const float* g, const void* hp,
        const void* u16, const void* upk, const float* mask, float* dff,
        __nv_bfloat16* dff16, float* dmask, float* pbuf, void* dabuf, void* bar,
        int T, int B, int H, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int err = make_plan(B, H, &pl);
  if (err != 0) {
    cudaGetLastError();
    return err;
  }
  err = static_cast<int>(launch_remat(static_cast<const __nv_bfloat16*>(hp),
                                      static_cast<const __nv_bfloat16*>(u16), ff,
                                      dff, T * B, H, stream));
  if (err != 0) return err;
  const Params prm{c, g, static_cast<const __nv_bfloat16*>(upk), mask, dff, dff16,
                   dmask, pbuf, static_cast<__nv_bfloat16*>(dabuf),
                   static_cast<unsigned*>(bar), T, B, H, pl.u, pl.R, pl.S, pl.kl,
                   pl.nc, pl.rows, pl.mmax, pl.pc};
  return launch_chain(prm, pl, stream);
}

}  // namespace

extern "C" int tpk_lstm_lean_bwd_max_hidden() { return kMaxHidden; }
extern "C" int tpk_lstm_lean_bwd_bf16_max_hidden() { return kMaxHidden; }

// out[0..7] = (CTAs, units a CTA, shared-memory bytes a CTA, groups'
// partial sums staged at a time, floats of the pbuf scratch, groups, CTAs
// of a group, bf16 words of the dabuf scratch) of the sequential launch for
// (B, H); returns make_plan's code.
extern "C" int tpk_lstm_lean_bwd_plan(int B, int H, int* out) {
  Plan pl;
  const int err = make_plan(B, H, &pl);
  if (err == 0) {
    out[0] = pl.R * pl.S;
    out[1] = pl.u;
    out[2] = static_cast<int>(pl.smem);
    out[3] = pl.pc;
    out[4] = static_cast<int>(pl.pbuf);
    out[5] = pl.S;
    out[6] = pl.R;
    out[7] = static_cast<int>(pl.dabuf);
  }
  cudaGetLastError();  // a failed query leaves nothing behind
  return err;
}

// Launches the remat and the sequential pass on `stream` and returns the
// first error: a grid the card cannot hold at once
// (cudaErrorCooperativeLaunchTooLarge, before anything runs), or what a
// launch reports (a refused launch never runs, and only this value reports
// it).  hp, u16 and upk are the bf16 operands of the header; pbuf holds the
// plan's floats (tpk_lstm_lean_bwd_plan, out[4]), any contents; dabuf its
// bf16 words (out[7]) and bar 1 + S unsigned words (out[5]), both zeroed
// by the caller.
extern "C" int tpk_lstm_lean_bwd(const float* ff, const float* c, const float* g,
                                 const void* hp, const void* u16, const void* upk,
                                 const float* mask, float* dff, float* dmask,
                                 float* pbuf, void* dabuf, void* bar, int T,
                                 int B, int H, cudaStream_t stream) {
  return run(ff, c, g, hp, u16, upk, mask, dff, nullptr, dmask, pbuf, dabuf, bar, T,
             B, H, stream);
}

// The bf16 entry: ff and dff (T, B, 4H) bf16, and gates, a float32 (T, B,
// 4H) buffer of any contents for the remat's gates; the rest as above.
extern "C" int tpk_lstm_lean_bwd_bf16(const void* ff, const float* c, const float* g,
                                      const void* hp, const void* u16,
                                      const void* upk, const float* mask,
                                      float* gates, void* dff, float* dmask,
                                      float* pbuf, void* dabuf, void* bar, int T,
                                      int B, int H, cudaStream_t stream) {
  return run(static_cast<const __nv_bfloat16*>(ff), c, g, hp, u16, upk, mask, gates,
             static_cast<__nv_bfloat16*>(dff), dmask, pbuf, dabuf, bar, T, B, H,
             stream);
}
