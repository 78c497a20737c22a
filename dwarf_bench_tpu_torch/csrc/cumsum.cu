// Inclusive int32 prefix sum plus a carry.
//
// Replaces dwarf_bench_tpu/ops/cumsum_pallas.py:35 cumsum_pallas:
// out[i] = carry_init + x[0] + ... + x[i], wrapping mod 2^32. The TPU kernel
// runs the scan as f32 matmuls against triangular ones matrices on the MXU and
// carries a scalar through its sequential grid; that is where its
// preconditions (|x| < 2^15, block sums < 2^24) come from. This scan adds in
// uint32_t throughout, so it is exact for every input and wraps as the
// contract asks (signed overflow would be undefined in C++).
//
// Blocks run in no order on the card, so nothing is carried between them.
// The scan is reduce-then-scan in three launches on one stream:
//   1. tile_sums:    each block sums one tile of kTile elements;
//   2. tile_offsets: one block turns the tile sums, in place, into exclusive
//                    tile offsets that start at *carry_init;
//   3. scan_tiles:   each block scans its tile again and adds its offset.
// The input is read twice and the output written once: 12 bytes a row, so the
// scan is bound by device-memory bandwidth. carry_init is read on the device,
// so a carry computed by an earlier kernel (the counting sort's min - 1) needs
// no round trip to the host.
#include "common.cuh"

namespace {

using dbt::block_exclusive_scan;

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__global__ void tile_sums(const int32_t* __restrict__ x, int64_t n,
                          uint32_t* __restrict__ sums) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + (int64_t)j * kThreads + threadIdx.x;
    if (i < n) s += static_cast<uint32_t>(x[i]);
  }
  uint32_t total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void tile_offsets(uint32_t* __restrict__ sums, int64_t ntiles,
                             const int32_t* __restrict__ carry_init) {
  uint32_t carry = static_cast<uint32_t>(carry_init[0]);
  for (int64_t base = 0; base < ntiles; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const uint32_t v = i < ntiles ? sums[i] : 0u;
    uint32_t total;
    const uint32_t before = block_exclusive_scan(v, &total);
    if (i < ntiles) sums[i] = carry + before;
    carry += total;
  }
}

__global__ void scan_tiles(const int32_t* __restrict__ x, int64_t n,
                           const uint32_t* __restrict__ offsets,
                           int32_t* __restrict__ out) {
  // Staged through shared memory so that global loads and stores stay
  // coalesced while each thread scans kItems consecutive elements.
  __shared__ uint32_t tile[kTile];
  const int64_t base = (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    const int64_t i = base + idx;
    tile[idx] = i < n ? static_cast<uint32_t>(x[i]) : 0u;
  }
  __syncthreads();
  uint32_t run[kItems];
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    s += tile[threadIdx.x * kItems + j];
    run[j] = s;
  }
  uint32_t total;
  // block_exclusive_scan synchronizes, so every read of `tile` above is done
  // before the writes below.
  const uint32_t off = offsets[blockIdx.x] + block_exclusive_scan(s, &total);
#pragma unroll
  for (int j = 0; j < kItems; ++j) tile[threadIdx.x * kItems + j] = off + run[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    const int64_t i = base + idx;
    if (i < n) out[i] = static_cast<int32_t>(tile[idx]);
  }
}

}  // namespace

// Number of int32 scratch words dbt_cumsum needs for n elements.
extern "C" int64_t dbt_cumsum_scratch(int64_t n) {
  return (n + kTile - 1) / kTile;
}

// carry_init points to one int32 on the device; scratch holds
// dbt_cumsum_scratch(n) int32 words.
extern "C" int dbt_cumsum(const int32_t* x, int64_t n,
                          const int32_t* carry_init, int32_t* out,
                          int32_t* scratch, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t ntiles = dbt_cumsum_scratch(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* sums = reinterpret_cast<uint32_t*>(scratch);
  tile_sums<<<(unsigned)ntiles, kThreads, 0, s>>>(x, n, sums);
  tile_offsets<<<1, kThreads, 0, s>>>(sums, ntiles, carry_init);
  scan_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(x, n, sums, out);
  return static_cast<int>(cudaGetLastError());
}
