// What a persistent recurrence kernel needs besides its arithmetic: the
// dynamic shared memory, 16- and 8-byte cp.async copies into it, and one
// grid-wide barrier per time step (grid_arrive, then grid_wait).
//
// A persistent kernel runs its whole time loop in one cooperative launch
// (cudaLaunchCooperativeKernel, which refuses a grid the card cannot hold
// at once, instead of letting the barrier deadlock).  Each CTA owns a slice
// of the hidden units and exchanges h through a global ping-pong buffer
// hbuf[2][...]: step t reads hbuf[t & 1] and writes hbuf[(t + 1) & 1], and
// one grid barrier ends the step.  With the ping-pong that one barrier covers
// both hazards: a buffer's reads of step t - 1 end before its writes of
// step t + 1 begin.  The reads of hbuf go through cp_async16_cg, which
// reads L2 only, so a CTA never sees a stale L1 line of a buffer that
// another CTA rewrote two steps earlier.

#pragma once

#include <cuda_runtime.h>

namespace tpk {

// the block's dynamic shared memory (sized by the launch)
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char tpk_dynamic_smem[];
  return tpk_dynamic_smem;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only (no L1 allocation)
__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 8 bytes global -> shared (cp.async takes .cg only for 16 bytes)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Add v to *p after this thread's earlier writes, and those the block
// ordered before it with __syncthreads, are visible at GPU scope.
__device__ __forceinline__ void red_release_gpu(unsigned* p, unsigned v) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "red.relaxed.gpu.global.add.u32 [%0], %1;\n" ::"l"(p),
      "r"(v)
      : "memory");
}

// A grid-wide barrier in two halves, on one arrival counter that only grows
// within a launch (the caller zeroes it before the launch), so that writes
// no other CTA reads can go out between them.  grid_arrive: thread 0
// arrives with a release, cumulative over the block's writes that
// __syncthreads ordered before it.  grid_wait(count, n): thread 0 waits
// with acquire loads until the counter reaches n (n = k * gridDim.x at the
// k-th barrier), and __syncthreads orders the block's later reads after
// that acquire.  The signed difference keeps the comparison right across a
// wrap of the 32-bit counter.
__device__ __forceinline__ void grid_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) red_release_gpu(count, 1u);
}

__device__ __forceinline__ void grid_wait(const unsigned* count, unsigned n) {
  if (threadIdx.x == 0) {
    while (static_cast<int>(ld_acquire_gpu(count) - n) < 0) {
    }
  }
  __syncthreads();
}

}  // namespace tpk
