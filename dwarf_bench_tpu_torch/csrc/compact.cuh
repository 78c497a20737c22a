// Order-preserving stream compaction (copy_if) of one or two streams in one
// launch, shared by the filter (filter.cu), the mask compaction (compact.cu)
// and the scan tail's two chunk streams (scan_tail.cu).
//
// The TPU kernels this serves (scan_pallas.py filter_pallas,
// compact_pallas.py _compact_mask_call, scan_tail_pallas.py
// scan_tail_streams) walk their grid in order and carry the running output
// offset from one step to the next, compacting each block with roll
// butterflies. Blocks on the card run in no order, so a block cannot know
// where its kept rows go until every block before it has counted. This is
// Merrill & Garland's single-pass scan with decoupled look-back over the
// per-stream counts, in one launch (as csrc/cumsum.cu):
//   - A block takes the next tile of kTile rows from an atomic counter, so
//     every earlier tile has started and the look-back never waits on a tile
//     that never runs.
//   - It reads its rows once, into registers: a lane holds Op::kVecs runs of
//     4 consecutive rows, each warp a contiguous stretch (cumsum's layout),
//     read with one vector load a run where the Op's view is aligned and the
//     warp's stretch is whole, and with scalar loads otherwise, in the same
//     launch. It classifies each row into its streams.
//   - A kept row's rank within its warp is the warp's kept rows in earlier
//     runs, plus those of the lanes below in its run, plus those before it
//     in its own run. Each lane's counts of a group of 4 runs are packed one
//     byte a run (at most 128 a warp), so one warp_inclusive_scan a group and
//     stream ranks 4 runs: no ballot a row. The warp counts are scanned in
//     shared memory.
//   - It publishes each stream's count in a 64-bit status word (flag << 32 |
//     count, one word a stream); warp 0 walks back to each stream's
//     inclusive prefix (look_back below: with two streams a tile is taken
//     once the words it needs are published) and publishes the prefixes.
//   - Each warp then stages its kept rows (Op::stage: a value, or a row
//     index) in shared memory at their ranks, and writes them out with
//     consecutive lanes on consecutive slots (Op::fetch, Op::store), so the
//     stores, and the column reads of the mask compaction, coalesce; a lane
//     fetches kBatch slots before it stores, so its reads overlap, and the
//     mask compaction asks the L2 for the columns' kept lines
//     (Op::prefetch) before its look-back, so their reads overlap the wait.
//     A slot at or past the stream's capacity is not written.
//   - The tile that holds the last row (tile 0 when n is 0) writes each
//     stream's full count, and lets the Op write what lies past the counts
//     (Op::last_tile: the scan tail's sentinel). The tile counter, a
//     finished-block counter and the status words start at zero and the
//     kernel leaves them so: each block counts itself finished once its
//     look-back is done (an add with release semantics that it does not
//     wait for), and the block of the last tile, which starts after every
//     other, waits for the count and zeroes them. So the wrappers keep one
//     scratch buffer a stream and no call needs a memset.
// Output order is input order: no slot is claimed with an atomic. Counts and
// ranks are 32-bit, so n must be below 2^31.
//
// Bound on the card: device-memory bandwidth. Each input row is read once
// and each kept row written once; the filter keeps a row's value in
// registers and shared memory from the read to the write, and the mask
// compaction reads its columns at kept rows only. A block cannot finish
// before the slowest of its recent predecessors has read its tile, so each
// block lives several microseconds and the bytes in flight are the rows
// that the resident blocks hold in registers: the filter takes 512 lanes of
// 8 runs (16384-row tiles, 64 KB) at two blocks an SM, the mask 512 lanes of
// 4 (8192 rows). The scan tail's calls are small (2^17 chunks at 2^24 rows):
// its Op takes tiles of its own size (TailOp in scan_tail.cu), so that its
// tiles spread over the SMs.
#pragma once

#include "common.cuh"

namespace dbt {
namespace {  // internal linkage: each .cu instantiates its own kernels

// The smallest tile of any Op: the scratch holds a status word a tile of
// kMinTile rows and stream, enough for every Op.
constexpr int kMinTile = 512;
constexpr int kBatch = 4;  // slots a lane fetches before it stores

// Status word of a decoupled look-back (Merrill & Garland's single-pass
// scan): flag << 32 | value, so that one 64-bit store makes both visible
// together; 0 means "not published yet".
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// The exclusive prefixes of tile `tile` (> 0) in K independent uint32 sums,
// read by warp 0 (every lane calls it) from its predecessors' status words,
// K a tile (sum s of tile t at status[K * t + s]). Lane l reads the tile at
// distance l + 1, 32 tiles a round trip to the L2. A sum takes the words up
// to its nearest inclusive prefix; the window is read again while one of
// those is unpublished, and moves back 32 tiles while a sum has met no
// prefix in it. Each sum stops at its own nearest prefix, so a tile may be a
// prefix in one sum and an aggregate in the other.
template <int K>
__device__ __forceinline__ void look_back(
    const volatile unsigned long long* status, uint32_t tile, int lane,
    uint32_t (&before)[K]) {
  constexpr int kNone = 32;  // no such word in the window
  bool open[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    before[s] = 0;
    open[s] = true;
  }
  int64_t last = (int64_t)tile - 1;
  while (true) {
    const int64_t idx = last - lane;
    unsigned long long w[K];
    int stop[K];  // distance - 1 of each sum's nearest prefix in the window
    bool waiting;
    do {
      waiting = false;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        w[s] = idx >= 0 ? status[K * idx + s] : kPrefix;
        const unsigned pre = __ballot_sync(0xffffffffu, (w[s] >> 32) == 2);
        const unsigned un = __ballot_sync(0xffffffffu, (w[s] >> 32) == 0);
        stop[s] = pre ? __ffs(pre) - 1 : kNone;
        waiting |= open[s] && un && __ffs(un) - 1 < stop[s];
      }
    } while (waiting);  // uniform across the warp: it comes from ballots
    bool done = true;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (open[s]) {
        before[s] += __reduce_add_sync(
            0xffffffffu, lane <= stop[s] ? static_cast<uint32_t>(w[s]) : 0u);
        open[s] = stop[s] == kNone;
      }
      done = done && !open[s];
    }
    if (done) return;
    last -= 32;
  }
}

// Rows of a tile of `Op`: Op::kThreads lanes of Op::kVecs runs of 4 rows.
// A lane's runs are counted in groups of up to 4 (a byte a run in a word).
template <class Op>
__host__ __device__ constexpr int tile_rows() {
  static_assert((Op::kVecs < 4 || Op::kVecs % 4 == 0) && Op::kVecs * 4 <= 32,
                "whole groups of runs, a lane's flags in one word");
  static_assert(Op::kThreads % 32 == 0 && Op::kThreads <= 1024,
                "whole warps; one warp scans the warp counts");
  static_assert(Op::kThreads * 4 * Op::kVecs % kMinTile == 0,
                "a tile is a multiple of kMinTile rows");
  return Op::kThreads * 4 * Op::kVecs;
}

// Tiles of a compaction of n rows: one block runs even for n = 0, to write
// the zero counts.
inline int64_t compaction_tiles(int64_t n, int64_t tile) {
  return n > 0 ? (n + tile - 1) / tile : 1;
}

// int32 scratch words of a compaction of n rows into k streams, for every
// Op: the two counters, then k 64-bit status words a tile of kMinTile rows.
inline int64_t compaction_scratch_words(int64_t n, int k) {
  return 2 + 2 * k * compaction_tiles(n, kMinTile);
}

// An Op of K streams provides
//   static constexpr int kThreads;    lanes of a block
//   static constexpr int kVecs;       runs of 4 rows a lane: 1, 2, 4 or 8
//   static constexpr int kMinBlocks;  blocks an SM (__launch_bounds__)
//   struct Item;                                           one row's data
//   __device__ Item load(int64_t i) const;                 row i
//   __device__ void load4(int64_t i, Item (&it)[4]) const; rows i to i + 3
//                                (i a multiple of 4; called only when `vec`)
//   __device__ void flags(const Item&, bool (&keep)[K]) const;
//   __device__ void prefetch(int64_t i) const;  a run from row i keeps rows:
//                                bring what fetch will read into the L2
//   __device__ uint32_t stage(const Item&, int64_t i, int s) const;
//                                what a warp keeps of kept row i of stream s
//   struct Value;                                          what a slot gets
//   __device__ Value fetch(uint32_t staged, int s) const;
//   __device__ void store(const Value&, int s, int64_t pos) const;
//   __device__ void last_tile(const uint32_t (&count)[K]) const;
//                                run by every lane of the last tile's block
//                                once each stream's full count is known
//   int64_t cap[K];                                        slots per stream

// The sum of the four bytes of a lane's packed counts (up to 512).
__device__ __forceinline__ uint32_t byte_sum(uint32_t x) {
  return (x & 0xFFu) + ((x >> 8) & 0xFFu) + ((x >> 16) & 0xFFu) + (x >> 24);
}

template <int K, class Op>
__global__ void __launch_bounds__(Op::kThreads, Op::kMinBlocks)
    compact_lookback(Op op, int64_t n, bool vec, int32_t* __restrict__ totals,
                     unsigned* __restrict__ counters,
                     unsigned long long* status) {
  constexpr int kThreads = Op::kThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int kVecs = Op::kVecs;
  constexpr int kRuns = kVecs < 4 ? kVecs : 4;  // runs of a group
  constexpr int kGroups = kVecs / kRuns;  // a packed word of counts a group
  constexpr int kGroupRows = 32 * 4 * kRuns;  // a warp's rows in a group
  constexpr int kWarpRows = kGroups * kGroupRows;
  constexpr int kTile = tile_rows<Op>();
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_warp[K][kWarps];  // warp counts, then their offsets
  __shared__ uint32_t s_before[K];
  __shared__ uint32_t s_total[K];
  __shared__ uint32_t s_stage[kWarps][kGroupRows];  // a group's kept rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counters, 1u);
  __syncthreads();
  const uint32_t tile = s_tile;
  // lane l's run j holds rows wbase + 4 * (32 * j + l) + [0, 4)
  const int64_t wbase = (int64_t)tile * kTile + (int64_t)warp * kWarpRows;
  const bool full = vec && wbase + kWarpRows <= n;

  typename Op::Item item[kVecs][4];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int64_t i = wbase + 4 * (32 * j + lane);
    if (full) {
      op.load4(i, item[j]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        item[j][c] = i + c < n ? op.load(i + c) : typename Op::Item{};
      }
    }
  }
  // bit 4 * j + c of bits[s]: row c of run j is kept in stream s
  uint32_t bits[K] = {};
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      bool keep[K] = {};
      if (full || wbase + 4 * (32 * j + lane) + c < n) {
        op.flags(item[j][c], keep);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
        bits[s] |= static_cast<uint32_t>(keep[s]) << (4 * j + c);
      }
    }
  }
  // the reads of the writes below start now, and overlap the look-back
  uint32_t any = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) any |= bits[s];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if ((any >> (4 * j)) & 0xFu) op.prefetch(wbase + 4 * (32 * j + lane));
  }

  // byte jj of word g: the kept rows of run kRuns * g + jj in the lanes
  // below (lane_below) and in the whole warp (warp_runs)
  uint32_t lane_below[K][kGroups], warp_runs[K][kGroups];
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      uint32_t own = 0;
#pragma unroll
      for (int jj = 0; jj < kRuns; ++jj) {
        own |= static_cast<uint32_t>(
                   __popc((bits[s] >> (4 * (kRuns * g + jj))) & 0xFu))
               << (8 * jj);
      }
      const uint32_t inc = warp_inclusive_scan(own);
      lane_below[s][g] = inc - own;
      warp_runs[s][g] = __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      uint32_t count = 0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) count += byte_sum(warp_runs[s][g]);
      s_warp[s][warp] = count;
    }
  }
  __syncthreads();

  if (warp == 0) {
    uint32_t aggregate[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const uint32_t w = lane < kWarps ? s_warp[s][lane] : 0u;
      const uint32_t winc = warp_inclusive_scan(w);
      if (lane < kWarps) s_warp[s][lane] = winc - w;
      aggregate[s] = __shfl_sync(0xffffffffu, winc, 31);
    }
    volatile unsigned long long* st = status;
    uint32_t before[K] = {};
    if (tile != 0) {
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < K; ++s) st[K * tile + s] = kAggregate | aggregate[s];
      }
      look_back<K>(st, tile, lane, before);
    }
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        st[K * tile + s] = kPrefix | (before[s] + aggregate[s]);
        s_before[s] = before[s];
        s_total[s] = before[s] + aggregate[s];
        if (tile == gridDim.x - 1) {
          totals[s] = static_cast<int32_t>(before[s] + aggregate[s]);
        }
      }
    }
  }
  __syncthreads();
  // every status read of this block is done and its prefixes are stored:
  // count it finished, without waiting for the add
  if (threadIdx.x == 0) add_release(counters + 1, 1u);

  uint32_t* stage = s_stage[warp];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    // the slot of the warp's first kept row; a group at a time, the warp
    // stages its kept rows at their ranks within the group, then writes them
    int64_t first = (int64_t)s_before[s] + s_warp[s][warp];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      uint32_t q = 0;  // the group's kept rows in earlier runs
#pragma unroll
      for (int jj = 0; jj < kRuns; ++jj) {
        const int j = kRuns * g + jj;
        uint32_t r = q + ((lane_below[s][g] >> (8 * jj)) & 0xFFu);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if ((bits[s] >> (4 * j + c)) & 1u) {
            stage[r++] =
                op.stage(item[j][c], wbase + 4 * (32 * j + lane) + c, s);
          }
        }
        q += (warp_runs[s][g] >> (8 * jj)) & 0xFFu;
      }
      __syncwarp();
      // slots first to first + q; a lane fetches kBatch slots' values
      // before it stores any, so their reads overlap
      const int64_t room = op.cap[s] - first;
      const uint32_t end =
          room < (int64_t)q ? static_cast<uint32_t>(room > 0 ? room : 0) : q;
      for (uint32_t k = lane; k < end; k += 32 * kBatch) {
        typename Op::Value v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k + 32 * b < end) v[b] = op.fetch(stage[k + 32 * b], s);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k + 32 * b < end) op.store(v[b], s, first + k + 32 * b);
        }
      }
      first += q;
      __syncwarp();  // the stage is refilled by the next group
    }
  }

  // Every block has started once the last tile's has, so the last tile's
  // block writes past the counts, waits for every block to count itself
  // finished, then leaves the counters and the status words zero.
  if (tile == gridDim.x - 1) {
    uint32_t total[K];
#pragma unroll
    for (int s = 0; s < K; ++s) total[s] = s_total[s];
    op.last_tile(total);
    if (threadIdx.x == 0) {
      while (load_acquire(counters + 1) < gridDim.x) {
      }
    }
    __syncthreads();
    for (uint32_t t = threadIdx.x; t < K * gridDim.x; t += kThreads) {
      status[t] = 0;
    }
    if (threadIdx.x == 0) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

// The one launch on `stream`. `totals` (K int32 on the device) receives each
// stream's full count; `scratch` holds compaction_scratch_words(n, K) int32
// words, 8-byte aligned and zero, and is left zero. `vec`: the Op's load4
// may be used. n is below 2^31.
template <int K, class Op>
cudaError_t compact_streams(const Op& op, int64_t n, bool vec,
                            int32_t* totals, int32_t* scratch,
                            cudaStream_t stream) {
  if (n < 0 || n >= (1ll << 31)) return cudaErrorInvalidValue;
  compact_lookback<K, Op>
      <<<(unsigned)compaction_tiles(n, tile_rows<Op>()), Op::kThreads, 0,
         stream>>>(
          op, n, vec, totals, reinterpret_cast<unsigned*>(scratch),
          reinterpret_cast<unsigned long long*>(scratch + 2));
  return cudaGetLastError();
}

}  // namespace
}  // namespace dbt
