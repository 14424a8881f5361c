// The card's L2 read rate: not a kernel of the port, a probe that
// chip_smoke.py times to price the bytes a streamed forward recurrence
// (u_stream.cuh) reads again every step from L2.
//
// Every thread reads 16-byte words of a buffer that fits in L2, `reps`
// passes over it, with ld.global.cg (L2, not L1: a pass re-reads what an
// SM read the pass before), four loads in flight a thread.  The sum is
// stored only if it is -1, which a zero buffer never gives, so no load is
// dropped and nothing is written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
l2_read_kernel(const float4* __restrict__ buf, long long n4, int reps,
               float* out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  float acc = 0.0f;
  for (int r = 0; r < reps; ++r) {
    long long i = first;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      const float4 a = __ldcg(buf + i);
      const float4 b = __ldcg(buf + i + stride);
      const float4 c = __ldcg(buf + i + 2 * stride);
      const float4 d = __ldcg(buf + i + 3 * stride);
      acc += (a.x + b.x) + (c.x + d.x) + (a.y + b.y) + (c.y + d.y) +
             (a.z + b.z) + (c.z + d.z) + (a.w + b.w) + (c.w + d.w);
    }
    for (; i < n4; i += stride) {
      const float4 a = __ldcg(buf + i);
      acc += (a.x + a.y) + (a.z + a.w);
    }
  }
  if (acc == -1.0f) out[0] = acc;
}

}  // namespace

// The current device's L2 size in bytes into *bytes; returns the CUDA error
// code of the query.
extern "C" int tpk_l2_bytes(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrL2CacheSize, dev);
  }
  return static_cast<int>(err);
}

// `reps` passes over the n4 16-byte words at buf, on `blocks` blocks of 512
// threads; returns the launch's CUDA error code.
extern "C" int tpk_l2_read(const void* buf, long long n4, int reps, int blocks,
                           float* out, cudaStream_t stream) {
  l2_read_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(buf), n4, reps, out);
  return static_cast<int>(cudaGetLastError());
}
