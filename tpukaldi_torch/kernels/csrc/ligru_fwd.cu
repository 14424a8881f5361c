// Li-GRU forward recurrence for Hopper (sm_90a).
//
// Replaces tpukaldi/kernels/ligru.py::_ligru_kernel (the Pallas forward,
// launched from _ligru_pallas_fwd_impl).  For every batch row b it runs
//
//     r    = h @ U                          U = [Uh | Uz], (H, 2H) row-major
//     z_t  = sigmoid(ff[t, b, H:] + r[H:])
//     hc   = relu(ff[t, b, :H] + r[:H]) * mask[b]
//     h    = z_t * h + (1 - z_t) * hc      h_0 = 0
//
// and writes h for every step.  All tensors are float32 and contiguous:
// ff (T, B, 2H), U (H, 2H), mask (B, H), out (T, B, H).
//
// Design.  One CTA per batch row: rows are independent, so no CTA waits on
// another and there is no grid-wide synchronisation.  The whole time loop
// runs inside the kernel; h of the row lives in shared memory, double
// buffered so that one __syncthreads() per step separates the reads of
// h_{t-1} from the writes of h_t.  Thread j owns hidden unit j: it computes
// columns j and H + j of h @ U in float32, reading U row by row, so the 32
// threads of a warp read 32 neighbouring floats (coalesced), then applies
// the gate update and stores h_t[j].  Every step of T runs; nothing is
// padded to a time block.
//
// What bounds it.  Each step every CTA re-reads all of U (2H * H floats,
// 2.42 MB at H = 550) from L2: T * B * 8 H^2 bytes of L2 traffic for
// 4 T B H^2 flops, one flop per two bytes, far below what the SMs could
// compute.  Only B CTAs run (B <= 132 fills at most one wave), so the
// card is also under-occupied at small batch.  The persistent design that
// keeps a column slice of U resident in each CTA's shared memory and
// exchanges h across CTAs every step (Sparse Persistent RNNs, PAPERS.md,
// arXiv 1804.10223) removes the L2 re-reads; it is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__global__ void ligru_fwd_kernel(const float* __restrict__ ff,
                                 const float* __restrict__ u,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out,
                                 int T, int B, int H) {
  extern __shared__ float h_smem[];  // 2 * H floats: h_{t-1}, h_t
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool active = j < H;
  const size_t two_h = 2 * static_cast<size_t>(H);

  float h_j = 0.0f;
  const float m = active ? mask[static_cast<size_t>(b) * H + j] : 0.0f;
  if (active) h_smem[j] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h_prev = h_smem + (t & 1) * H;
    float* h_next = h_smem + ((t + 1) & 1) * H;
    if (active) {
      float acc_h = 0.0f;
      float acc_z = 0.0f;
      const float* u_col = u + j;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = h_prev[k];
        acc_h = fmaf(hk, u_col[k * two_h], acc_h);
        acc_z = fmaf(hk, u_col[k * two_h + H], acc_z);
      }
      const float* ff_t = ff + (static_cast<size_t>(t) * B + b) * two_h;
      const float zt = 1.0f / (1.0f + expf(-(ff_t[H + j] + acc_z)));
      const float hc = fmaxf(ff_t[j] + acc_h, 0.0f) * m;
      h_j = zt * h_j + (1.0f - zt) * hc;
      h_next[j] = h_j;
      out[(static_cast<size_t>(t) * B + b) * H + j] = h_j;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tpk_ligru_fwd_max_hidden() { return kMaxHidden; }

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// (too many threads, too much shared memory) never runs, and only this
// return value reports it.
extern "C" int tpk_ligru_fwd(const float* ff, const float* u,
                             const float* mask, float* out, int T, int B,
                             int H, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(H) * sizeof(float);
  ligru_fwd_kernel<<<B, threads, smem, stream>>>(ff, u, mask, out, T, B, H);
  return static_cast<int>(cudaGetLastError());
}
