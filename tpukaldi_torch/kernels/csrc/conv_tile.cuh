// What the raw-waveform layer-0 kernels share (conv_pool_fwd.cu K5f,
// conv_pool_bwd.cu K5b, conv_ln_fwd.cu K6f, conv_ln_bwd.cu K6b) and the
// conv stack's (K7f, K7b): the geometry, the layer norm's affine step and
// the dropout hash; the dW pass's window load and the block sums; the
// runtime queries their launches keep (SM count, shared-memory limit,
// occupancy).  The backwards' dX and dW passes are in conv_pool_bwd.cuh,
// the forwards' register tile and pipeline (their own window load and
// max-pool) in conv_fwd.cuh.  The stack's upper layers keep limits of
// their own (stack_tile.cuh).
//
// Layouts (tpukaldi's): x (N, L) float32, w (K, O) float32, pooled outputs
// and their gradients (N, M, O) with M = (L - K + 1) / pool, idx (N, M, O)
// int8.  A backward block takes kFilt filters, one per lane of every warp.
// K6f saves the pooled value in training, so K6b normalises the same bits
// and opens the relu gate where the forward did.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace tpk {

// The envelope of the four entries: filters of up to 32 ms at 16 kHz
// (SincNet's published 251 taps, 25-ms 401-tap filters) and pools of up to
// 32 conv positions.  Nothing in a kernel is sized by them: the forwards
// stage the Kp taps they are given, the dW pass takes its taps in groups,
// and a pool longer than the forwards' run is taken in several runs.
constexpr int kMaxTaps = 512;
constexpr int kMaxPool = 32;
constexpr int kTapChunk = 8;    // taps are padded to a multiple of it
constexpr int kFilt = 32;       // filters per backward block, one per lane
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory per block

__host__ __device__ inline int padded_taps(int K) {
  return (K + kTapChunk - 1) / kTapChunk * kTapChunk;
}

// xs[i] = x_row[start + i] for i < count, zero outside [0, L): the zeros
// meet zero weights or fall beyond the last pooled row, and stay finite
__device__ inline void load_window(const float* __restrict__ x_row, int L,
                                   int start, int count, float* xs) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int t = start + i;
    xs[i] = (t >= 0 && t < L) ? x_row[t] : 0.0f;
  }
}

// the layer norm's affine step, ((c * r) * g) + b, each product and the sum
// rounded on its own (never contracted into an fma), as tpukaldi and the
// plain version compute it: K6f and K6b open the relu gate alike
__device__ __forceinline__ float ln_affine(float c, float r, float g,
                                           float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(c, r), g), b);
}

// tpukaldi's dropout hash (kernels/conv1d.py::_drop_mask): murmur3's fmix32
// over the element id, xor the seed and the window id each times a
// constant; the element is kept where the hash is below the threshold
__device__ __forceinline__ bool drop_keep(uint32_t eid, uint32_t seed,
                                          uint32_t wid, uint32_t threshold) {
  uint32_t h = eid * 0xC2B2AE3Du ^ seed * 0x9E3779B1u ^ wid * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h < threshold;
}

// The layer-norm kernels (K6b, and K7's upper layers): block (window n,
// tile of 32 filters), kLnWarps warps over the window's rows, and
// two rows of per-warp partial sums.  K6f sums in the same order with its
// own thread layout: row m's term in slot m mod kLnWarps, in increasing m,
// then the slots in order.
constexpr int kLnWarps = 16;

// the sum over the block's warps of each lane's `part`, in warp order;
// every thread gets its lane's total.  red holds kLnWarps x kFilt floats.
__device__ inline float warp_sum(float part, float* red) {
  const int lane = threadIdx.x % 32;
  red[(threadIdx.x / 32) * kFilt + lane] = part;
  __syncthreads();
  float tot = 0.0f;
  for (int w = 0; w < kLnWarps; ++w) tot += red[w * kFilt + lane];
  return tot;
}

// A runtime query's answer for the current device and `key`: ask(dev, &v)
// once, then the kept v (an error is returned, and not kept).  Each Ask
// type, one a call site, keeps its own answers.
template <typename Key, typename Ask>
inline cudaError_t device_cached(const Key& key, Ask ask, int* out) {
  static std::mutex lock;
  static std::map<std::pair<int, Key>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  const auto k = std::make_pair(dev, key);
  auto it = known.find(k);
  if (it == known.end()) {
    int v = 0;
    err = ask(dev, &v);
    if (err != cudaSuccess) return err;
    it = known.emplace(k, v).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// the streaming multiprocessors of the current device; 0 on an error
inline int sm_count() {
  int sms = 0;
  const cudaError_t err = device_cached(
      0,
      [](int dev, int* v) {
        return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
      },
      &sms);
  return err == cudaSuccess ? sms : 0;
}

// a kernel's dynamic shared memory raised to kMaxSmem, once per device
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  int done = 0;
  return device_cached(
      reinterpret_cast<const void*>(kernel),
      [&](int, int* v) {
        *v = 1;
        return cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(kMaxSmem));
      },
      &done);
}

// the shared geometry checks of the four entries
inline bool geometry_ok(int N, int L, int K, int O, int pool) {
  return N > 0 && O > 0 && K >= 1 && K <= kMaxTaps && pool >= 1 &&
         pool <= kMaxPool && L - K + 1 >= pool;
}

}  // namespace tpk
