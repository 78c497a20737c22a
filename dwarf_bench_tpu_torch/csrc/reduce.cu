// int32 sum mod 2^32.
//
// Replaces dwarf_bench_tpu/ops/reduce.py:36 reduce_sum_pallas: the TPU kernel
// streams 2 MB blocks through VMEM into an (8, 2048) int32 accumulator
// carried across its sequential grid, and sums the accumulator at the last
// step. Blocks on the card run in no order, so nothing is carried between
// them. One launch does the whole sum:
//   - one wave of blocks (kBlocksPerSm on each SM) runs a grid-stride loop
//     in which each thread keeps kUnroll independent 16-byte streaming loads
//     in flight (they do not fill L1); a scalar head takes the values before
//     the first 16-byte boundary and a scalar tail the last ragged ones;
//   - each block reduces its threads' uint32_t partial sums (warp shuffles,
//     then shared memory), writes the block's sum to its scratch word and
//     takes a ticket;
//   - the block with the last ticket adds the blocks' sums in block order,
//     writes out and puts the ticket back to 0. So the scratch, one lasting
//     buffer for each stream (ops/_build.py stream_scratch), is left as it
//     was found and no call needs a memset (csrc/cumsum.cu does the same).
// Addition mod 2^32 does not depend on order; the fixed order makes every
// run take the same steps.
//
// It reads 4 bytes a row once, so it is bound by device-memory bandwidth
// (64 MB at 2^24 rows: about 20 us at the 3.35 TB/s peak).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 4;  // 2048 threads: a full SM

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// The sum over the block of each thread's v, valid in thread 0. Every thread
// of the block must call it.
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // warp_sums may still be read by an earlier call
  v = warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? warp_sums[lane] : 0u;
  return warp == 0 ? warp_sum(v) : 0u;
}

__device__ __forceinline__ uint32_t add4(int4 q) {
  return static_cast<uint32_t>(q.x) + static_cast<uint32_t>(q.y) +
         static_cast<uint32_t>(q.z) + static_cast<uint32_t>(q.w);
}

// x[0, head) are scalars before the first 16-byte boundary, then nvec int4
// vectors, then scalars up to n. scratch[0] is the ticket, scratch[1 + b]
// block b's sum.
__global__ void __launch_bounds__(kThreads)
    reduce_sum_kernel(const int32_t* __restrict__ x, int64_t n, int64_t head,
                      int64_t nvec, uint32_t* __restrict__ out,
                      uint32_t* scratch) {
  __shared__ bool s_last;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int4* xv = reinterpret_cast<const int4*>(x + head);
  uint32_t s = 0;
  int64_t i = tid;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    int4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = __ldcs(xv + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += add4(q[u]);
  }
  for (; i < nvec; i += stride) s += add4(__ldcs(xv + i));
  if (tid < head) s += static_cast<uint32_t>(x[tid]);
  for (int64_t k = head + 4 * nvec + tid; k < n; k += stride) {
    s += static_cast<uint32_t>(x[k]);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) {
    scratch[1 + blockIdx.x] = s;
    __threadfence();  // the sum is visible before the ticket is
    s_last = atomicAdd(scratch, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  uint32_t t = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
    t += __ldcg(scratch + 1 + b);  // from L2: other SMs wrote them
  }
  t = block_sum(t);
  if (threadIdx.x == 0) {
    *out = t;
    scratch[0] = 0;
  }
}

}  // namespace

// out points to one int32 on the device. scratch holds scratch_words (>= 2)
// int32 on the device, the first of them 0; the kernel leaves it 0, so one
// buffer serves every call on a stream. n may be 0 (the sum is then 0); x
// needs only int32 alignment.
extern "C" int dbt_reduce_sum(const int32_t* x, int64_t n, int32_t* out,
                              int32_t* scratch, int32_t scratch_words,
                              void* stream) {
  if (scratch_words < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t mis = (reinterpret_cast<uintptr_t>(x) & 15) / 4;
  const int64_t head = mis == 0 ? 0 : (4 - mis < n ? 4 - mis : n);
  const int64_t nvec = (n - head) / 4;
  int64_t grid = (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int64_t cap = (int64_t)dbt::num_sms() * kBlocksPerSm;
  if (grid > cap) grid = cap;
  if (grid > scratch_words - 1) grid = scratch_words - 1;
  if (grid < 1) grid = 1;
  reduce_sum_kernel<<<(unsigned)grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, n, head, nvec, reinterpret_cast<uint32_t*>(out),
      reinterpret_cast<uint32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
