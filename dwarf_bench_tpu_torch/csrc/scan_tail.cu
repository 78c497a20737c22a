// The sparse filter's chunk-level tail: classify every chunk from its
// (stat, base) and compact two streams from one read of the chunk arrays.
//
// Replaces dwarf_bench_tpu/ops/scan_tail_pallas.py:47 scan_tail_streams.
// From stat = cnt * 512 + vsw (ops/chunk_stats.py) a chunk is
//   single: cnt == 1 and 1 <= vsw <= 255 (its one match is threshold - vsw);
//   multi:  cnt >= 1 and not single (gathered and compacted later).
// Singles' (base, threshold - vsw) compact, in chunk order, into
// (spos, sval)[:cap_single], multis' (chunk id, base) into
// (mids, mbase)[:cap_mc]; the counts n_single and n_multi are full. spos past
// n_single is set to 0x7FFFFFFF, the position sentinel the ordering sort puts
// last (the TPU wrapper does this outside its kernel). Other columns are
// garbage past their count.
//
// The TPU kernel carries two running offsets through its sequential grid;
// here the two-stream form of compact.cuh's one-pass compaction ranks every
// chunk in both streams and looks back over two status words a tile, in one
// launch with no memset. At 2^24 rows the chunk arrays are 2 x 512 KB and
// the outputs 64 KB + 4 KB, so the tail is bound by its launch and the
// look-back's chain of tiles, not by bandwidth (0.34 us of bytes). So:
//   - TailOp's tiles are small, kThreads lanes of one run of 4 chunks
//     (2048 chunks): at 2^17 chunks 64 blocks, where the engine's 8192-row
//     tile gave 16; of 512, 1024, 2048 and 4096 chunks, 2048 was the
//     fastest at 2^17 chunks on an H100 (PERF.md);
//   - a kept chunk stages its index, and its stat and base are read again
//     (from the L2) when it is written: staging its two output values in
//     shared memory instead measured no faster (PERF.md);
//   - the block of the last tile, which learns n_single, writes the
//     sentinel over spos[n_single:cap_single] (64 KB at 2^24 rows) while
//     it waits for the other blocks to finish: no second launch.
#include "compact.cuh"

namespace {

constexpr int32_t kBig = 0x7FFFFFFF;

struct TailOp {
  static constexpr int kThreads = 512;
  static constexpr int kVecs = 1;
  static constexpr int kMinBlocks = 2;
  struct Item {
    int32_t stat;
    int32_t base;
  };
  const int32_t* stat;
  const int32_t* base;
  int32_t threshold;
  int32_t* spos;
  int32_t* sval;
  int32_t* mids;
  int32_t* mbase;
  int64_t cap[2];

  __device__ Item load(int64_t i) const { return {stat[i], base[i]}; }
  __device__ void load4(int64_t i, Item (&it)[4]) const {
    const int4 s = *reinterpret_cast<const int4*>(stat + i);
    const int4 b = *reinterpret_cast<const int4*>(base + i);
    it[0] = {s.x, b.x};
    it[1] = {s.y, b.y};
    it[2] = {s.z, b.z};
    it[3] = {s.w, b.w};
  }
  __device__ void flags(const Item& it, bool (&keep)[2]) const {
    const int32_t cnt = it.stat >> 9;
    const int32_t vsw = it.stat & 511;
    keep[0] = cnt == 1 && vsw >= 1 && vsw <= 255;
    keep[1] = cnt >= 1 && !keep[0];
  }
  __device__ void prefetch(int64_t) const {}
  // a kept chunk stages its index; its stat and base are read again when
  // it is written
  __device__ uint32_t stage(const Item&, int64_t i, int) const {
    return static_cast<uint32_t>(i);
  }
  struct Value {
    int32_t a, b;  // (spos, sval) or (mids, mbase)
  };
  __device__ Value fetch(uint32_t i, int s) const {
    if (s == 0) {
      // threshold - vsw, wrapping mod 2^32 as the int32 reference does
      return {base[i], static_cast<int32_t>(static_cast<uint32_t>(threshold) -
                                            static_cast<uint32_t>(stat[i] & 511))};
    }
    return {static_cast<int32_t>(i), base[i]};
  }
  __device__ void store(const Value& v, int s, int64_t pos) const {
    (s == 0 ? spos : mids)[pos] = v.a;
    (s == 0 ? sval : mbase)[pos] = v.b;
  }
  // spos[n_single:cap] = kBig: 16 bytes a store between 16-byte boundaries
  // (spos comes from torch.empty, so it is aligned), one word at the ends
  __device__ void last_tile(const uint32_t (&count)[2]) const {
    const int64_t lo = count[0] < cap[0] ? count[0] : cap[0];
    const int64_t head = (lo + 3) & ~int64_t{3};
    const int64_t body = cap[0] & ~int64_t{3};
    const bool aligned = (reinterpret_cast<uintptr_t>(spos) & 15) == 0;
    const int64_t vlo = aligned && head < body ? head : cap[0];
    const int64_t vhi = aligned && head < body ? body : cap[0];
    for (int64_t i = lo + threadIdx.x; i < vlo; i += kThreads) spos[i] = kBig;
    for (int64_t i = vlo + 4 * threadIdx.x; i < vhi; i += 4 * kThreads) {
      *reinterpret_cast<int4*>(spos + i) = make_int4(kBig, kBig, kBig, kBig);
    }
    for (int64_t i = vhi + threadIdx.x; i < cap[0]; i += kThreads) {
      spos[i] = kBig;
    }
  }
};

}  // namespace

// counts points to two int32 on the device (n_single, n_multi); scratch holds
// dbt_compact_scratch(nch, 2) int32 words, 8-byte aligned and zero, and is
// left zero. nch is below 2^31.
extern "C" int dbt_scan_tail_streams(const int32_t* stat, const int32_t* base,
                                     int64_t nch, int32_t threshold,
                                     int32_t* spos, int32_t* sval,
                                     int64_t cap_single, int32_t* mids,
                                     int32_t* mbase, int64_t cap_mc,
                                     int32_t* counts, int32_t* scratch,
                                     void* stream) {
  TailOp op{stat, base, threshold, spos, sval, mids, mbase,
            {cap_single, cap_mc}};
  const bool vec = ((reinterpret_cast<uintptr_t>(stat) |
                     reinterpret_cast<uintptr_t>(base)) & 15) == 0;
  return static_cast<int>(dbt::compact_streams<2>(
      op, nch, vec, counts, scratch, static_cast<cudaStream_t>(stream)));
}
