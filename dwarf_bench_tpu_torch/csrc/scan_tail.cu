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
// last (the TPU wrapper does this outside its kernel; here a fourth launch
// reads n_single on the device). Other columns are garbage past their count.
//
// The TPU kernel carries two running offsets through its sequential grid;
// here the two-stream form of compact.cuh's one-pass compaction ranks every
// chunk in both streams and looks back over two status words a tile (a kept
// chunk's stat and base are read again, from the L2, when it is written),
// then a second launch fills spos past n_single: two launches a call. At
// 2^24 rows the chunk arrays are 2 x 512 KB, so the tail is launch-bound,
// not bandwidth-bound.
#include "compact.cuh"

namespace {

constexpr int32_t kBig = 0x7FFFFFFF;

struct TailOp {
  static constexpr int kVecs = 4;
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
  // a kept chunk stages its index; its stat and base are read again (from
  // the L2: 1 MB at 2^17 chunks) when it is written
  __device__ void prefetch(int64_t) const {}
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
};

__global__ void fill_past_count(int32_t* __restrict__ v, int64_t cap,
                                const int32_t* __restrict__ count,
                                int32_t value) {
  const int64_t start = *count;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = start + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += stride) {
    v[i] = value;
  }
}

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TailOp op{stat, base, threshold, spos, sval, mids, mbase,
            {cap_single, cap_mc}};
  const bool vec = ((reinterpret_cast<uintptr_t>(stat) |
                     reinterpret_cast<uintptr_t>(base)) & 15) == 0;
  const cudaError_t err =
      dbt::compact_streams<2>(op, nch, vec, counts, scratch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cap_single > 0) {
    fill_past_count<<<dbt::grid_for(cap_single, 256, 4), 256, 0, s>>>(
        spos, cap_single, counts, kBig);
  }
  return static_cast<int>(cudaGetLastError());
}
