// Order-preserving stream compaction (copy_if) of one or two streams, shared
// by the filter (filter.cu), the mask compaction (compact.cu) and the scan
// tail's two chunk streams (scan_tail.cu).
//
// The TPU kernels this serves (scan_pallas.py filter_pallas,
// compact_pallas.py _compact_mask_call, scan_tail_pallas.py
// scan_tail_streams) walk their grid in order and carry the running output
// offset from one step to the next, compacting each block with roll
// butterflies. Blocks on the card run in no order, so a block cannot know
// where its kept rows go until every block before it has counted. Three
// launches on one stream:
//   1. tile_counts:  each block counts the kept rows of one tile of kTile
//                    rows, per stream;
//   2. tile_offsets: one block turns the counts, in place, into exclusive
//                    tile offsets and writes each stream's total (its count);
//   3. tile_scatter: each block reads its tile again and writes kept row r at
//                    tile offset + rank of r within the tile.
// Within a tile, warp w owns kItems runs of 32 consecutive rows, so loads
// coalesce and a row's rank is its warp's offset (one __syncthreads) plus the
// popcounts of the ballots before it. Output order is input order: no slot is
// claimed with an atomic. A row whose rank reaches its stream's capacity is
// not written, and the count stays the full count.
//
// The input is read twice and the kept rows written once, so at low
// selectivity the compaction is bound by device-memory bandwidth.
#pragma once

#include "common.cuh"

namespace dbt {
namespace {  // internal linkage: each .cu instantiates its own kernels

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kOffsetThreads = 1024;

inline int64_t compaction_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

// An Op of K streams provides
//   struct Item;                                              one row's data
//   __device__ Item load(int64_t i) const;
//   __device__ void flags(const Item&, bool (&keep)[K]) const;
//   __device__ void emit(const Item&, int64_t i, int s, int64_t pos) const;
//   int64_t cap[K];                                           slots per stream

// Loads and classifies the calling warp's kItems x 32 rows of the tile: the
// ballots of each stream and their popcount total (the same in every lane).
template <int K, class Op>
__device__ __forceinline__ void classify(const Op& op, int64_t n,
                                         int64_t first,
                                         typename Op::Item (&item)[kItems],
                                         uint32_t (&ballot)[K][kItems],
                                         int32_t (&total)[K]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + 32 * j;
    bool keep[K] = {};
    if (i < n) {
      item[j] = op.load(i);
      op.flags(item[j], keep);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      ballot[s][j] = __ballot_sync(0xffffffffu, keep[s]);
      total[s] += __popc(ballot[s][j]);
    }
  }
}

__device__ __forceinline__ int64_t warp_first_row() {
  return (int64_t)blockIdx.x * kTile +
         (int64_t)(threadIdx.x >> 5) * (32 * kItems) + (threadIdx.x & 31);
}

template <int K, class Op>
__global__ void __launch_bounds__(kThreads)
    tile_counts(Op op, int64_t n, int32_t* __restrict__ counts,
                int64_t ntiles) {
  __shared__ int32_t warp_total[K][kWarps];
  typename Op::Item item[kItems] = {};
  uint32_t ballot[K][kItems];
  int32_t total[K] = {};
  classify<K>(op, n, warp_first_row(), item, ballot, total);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) warp_total[s][warp] = total[s];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    int32_t t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_total[threadIdx.x][w];
    counts[threadIdx.x * ntiles + blockIdx.x] = t;
  }
}

template <int K>
__global__ void __launch_bounds__(kOffsetThreads)
    tile_offsets(int32_t* __restrict__ counts, int64_t ntiles,
                 int32_t* __restrict__ totals) {
  for (int s = 0; s < K; ++s) {
    uint32_t* c = reinterpret_cast<uint32_t*>(counts + s * ntiles);
    uint32_t carry = 0;
    for (int64_t b = 0; b < ntiles; b += blockDim.x) {
      const int64_t i = b + threadIdx.x;
      const uint32_t v = i < ntiles ? c[i] : 0u;
      uint32_t total;
      const uint32_t before = block_exclusive_scan(v, &total);
      if (i < ntiles) c[i] = carry + before;
      carry += total;
    }
    if (threadIdx.x == 0) totals[s] = static_cast<int32_t>(carry);
  }
}

template <int K, class Op>
__global__ void __launch_bounds__(kThreads)
    tile_scatter(Op op, int64_t n, const int32_t* __restrict__ offsets,
                 int64_t ntiles) {
  __shared__ int32_t warp_total[K][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first = warp_first_row();
  typename Op::Item item[kItems] = {};
  uint32_t ballot[K][kItems];
  int32_t total[K] = {};
  classify<K>(op, n, first, item, ballot, total);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) warp_total[s][warp] = total[s];
  }
  __syncthreads();
  const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    int64_t pos = offsets[s * ntiles + blockIdx.x];
    for (int w = 0; w < warp; ++w) pos += warp_total[s][w];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t b = ballot[s][j];
      if ((b >> lane) & 1u) {
        const int64_t p = pos + __popc(b & lanes_below);
        if (p < op.cap[s]) op.emit(item[j], first + 32 * j, s, p);
      }
      pos += __popc(b);
    }
  }
}

// The three launches on `stream`. `totals` (K int32 on the device) receives
// each stream's count; `scratch` holds K * compaction_tiles(n) int32 words.
template <int K, class Op>
cudaError_t compact_streams(const Op& op, int64_t n, int32_t* totals,
                            int32_t* scratch, cudaStream_t stream) {
  const int64_t ntiles = n > 0 ? compaction_tiles(n) : 0;
  if (ntiles > 0) {
    tile_counts<K, Op><<<(unsigned)ntiles, kThreads, 0, stream>>>(
        op, n, scratch, ntiles);
  }
  // with no tiles this only writes zero counts
  tile_offsets<K><<<1, kOffsetThreads, 0, stream>>>(scratch, ntiles, totals);
  if (ntiles > 0) {
    tile_scatter<K, Op><<<(unsigned)ntiles, kThreads, 0, stream>>>(
        op, n, scratch, ntiles);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace dbt
