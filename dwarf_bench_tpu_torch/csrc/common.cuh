// Shared helpers for the hand-written Hopper kernels of dwarf_bench_tpu_torch.
//
// Every entry point has a plain C interface (loaded with ctypes from
// ops/_build.py), launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so that a refused launch surfaces in Python.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace dbt {

constexpr int kMaxDevices = 64;

// Streaming multiprocessors of the current device (132 on an H100 SXM). The
// attribute query costs host time, so it is asked once a device and kept.
inline int num_sms() {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  int sms = cached ? known[dev].load(std::memory_order_relaxed) : 0;
  if (sms > 0) return sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sms = sms > 0 ? sms : 1;
  if (cached) known[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// Lets `kernel` take up to the device's opt-in shared memory a block (less
// its static shared memory) and, when `cluster`, clusters above the
// portable 8 blocks. The attribute calls
// cost host time, so each device is configured once and marked in `done`; a
// failure is returned and the next call tries again.
template <typename Kernel>
cudaError_t configure(Kernel kernel, bool cluster,
                      std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const uint64_t bit = 1ull << (dev & 63);
  if (err != cudaSuccess || (done.load(std::memory_order_acquire) & bit)) {
    return err;
  }
  int most = 0;
  cudaFuncAttributes attrs;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most - static_cast<int>(attrs.sharedSizeBytes));
  }
  if (err == cudaSuccess && cluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The result of a cudaLaunchKernelEx: a refused launch (a cooperative grid
// the context cannot hold, a cluster too large) also sets the runtime's
// last error, which is cleared here, or the next entry point's
// cudaGetLastError() would report it for a launch that ran.
inline cudaError_t launched(cudaError_t err) {
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

// Grid for a grid-stride loop over n elements: enough blocks to cover n,
// at most `per_sm` blocks on each SM, at least one block.
inline int grid_for(int64_t n, int threads, int per_sm) {
  int64_t want = (n + threads - 1) / threads;
  int64_t cap = (int64_t)num_sms() * per_sm;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

// An add at device scope with release semantics that returns nothing: the
// caller's earlier writes, and those of its block before a barrier, are
// visible to a thread whose acquiring load (load_acquire) reads the sum. The
// caller does not wait for it.
__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32). Writes the block's total to *total. Every thread of the
// block must call it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* total) {
  __shared__ uint32_t warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < nwarps ? warp_sums[lane] : 0u;
    warp_sums[lane] = warp_inclusive_scan(w);
  }
  __syncthreads();
  const uint32_t before = warp == 0 ? 0u : warp_sums[warp - 1];
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + inc - v;
}

}  // namespace dbt
