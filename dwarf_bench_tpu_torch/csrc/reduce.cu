// int32 sum mod 2^32.
//
// Replaces dwarf_bench_tpu/ops/reduce.py:36 reduce_sum_pallas: the TPU kernel
// streams 2 MB blocks through VMEM into an (8, 2048) int32 accumulator
// carried across its sequential grid, and sums the accumulator at the last
// step. Blocks on the card run in no order, so nothing is carried between
// them: a grid-stride loop gives each thread a uint32_t partial sum, a warp
// shuffle and a shared-memory step reduce each block to one value, and one
// atomicAdd per block folds it into the result. Addition mod 2^32 does not
// depend on order, so the sum is exact and the same on every run.
//
// It reads 4 bytes a row once, so it is bound by device-memory bandwidth
// (64 MB at 2^24 rows: about 20 us at the 3.35 TB/s peak). Where the input is
// 16-byte aligned the loop reads int4 vectors, four rows a load; a scalar
// loop takes the ragged tail (and a misaligned input whole). Two blocks of
// 512 threads an SM keep enough loads in flight to cover the latency.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    reduce_sum_kernel(const int32_t* __restrict__ x, int64_t n, int64_t nvec,
                      uint32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t s = 0;
  const int4* xv = reinterpret_cast<const int4*>(x);
  for (int64_t i = tid; i < nvec; i += stride) {
    const int4 v = xv[i];
    s += static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y) +
         static_cast<uint32_t>(v.z) + static_cast<uint32_t>(v.w);
  }
  for (int64_t i = nvec * 4 + tid; i < n; i += stride) {
    s += static_cast<uint32_t>(x[i]);
  }
  __shared__ uint32_t warp_sums[kThreads / 32];
  s = warp_sum(s);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0u;
    s = warp_sum(s);
    if (lane == 0) atomicAdd(out, s);
  }
}

}  // namespace

// out points to one int32 on the device; it is zeroed here, on the stream,
// before the blocks add into it. n may be 0 (the sum is then 0).
extern "C" int dbt_reduce_sum(const int32_t* x, int64_t n, int32_t* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, sizeof(int32_t), s);
  if (n > 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const int64_t nvec = aligned ? n / 4 : 0;
    const int grid = dbt::grid_for(aligned ? nvec : n, kThreads, 2);
    reduce_sum_kernel<<<grid, kThreads, 0, s>>>(
        x, n, nvec, reinterpret_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
