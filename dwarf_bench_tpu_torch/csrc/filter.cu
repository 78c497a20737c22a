// copy_if(x, x < threshold) of an int32 column.
//
// Replaces dwarf_bench_tpu/ops/scan_pallas.py:80 filter_pallas: (out, count)
// with the kept values in input order in `capacity` slots and the full count.
// The TPU kernel compacts each (8, 2048) block with a roll butterfly and
// streams it out through a 128-aligned carry buffer; here the one-pass
// compaction of compact.cuh does the work: x is read once, 16 bytes a lane
// where it is 16-byte aligned and one value otherwise, and a tile's values
// stay in registers from the compare to the write. Bound by device-memory
// bandwidth: x read once (67 MB at 2^24 rows) and the kept values written;
// the TPU kernel's `tile` knob has no counterpart.
#include "compact.cuh"

namespace {

struct FilterOp {
  // 512 lanes of 8 runs and two blocks an SM: 32 of a thread's 64
  // registers hold rows
  static constexpr int kThreads = 512;
  static constexpr int kVecs = 8;
  static constexpr int kMinBlocks = 2;
  using Item = int32_t;
  const int32_t* x;
  int32_t threshold;
  int32_t* out;
  int64_t cap[1];

  __device__ Item load(int64_t i) const { return x[i]; }
  __device__ void load4(int64_t i, Item (&it)[4]) const {
    const int4 q = *reinterpret_cast<const int4*>(x + i);
    it[0] = q.x;
    it[1] = q.y;
    it[2] = q.z;
    it[3] = q.w;
  }
  __device__ void flags(Item v, bool (&keep)[1]) const {
    keep[0] = v < threshold;
  }
  __device__ void prefetch(int64_t) const {}  // the values are in registers
  using Value = uint32_t;
  __device__ uint32_t stage(Item v, int64_t, int) const {
    return static_cast<uint32_t>(v);
  }
  __device__ Value fetch(uint32_t v, int) const { return v; }
  __device__ void store(Value v, int, int64_t pos) const {
    out[pos] = static_cast<int32_t>(v);
  }
  __device__ void last_tile(const uint32_t (&)[1]) const {}
};

}  // namespace

// count points to one int32 on the device; scratch holds
// dbt_compact_scratch(n, 1) int32 words, 8-byte aligned and zero, and is left
// zero. n is below 2^31.
extern "C" int dbt_filter(const int32_t* x, int64_t n, int32_t threshold,
                          int32_t* out, int64_t capacity, int32_t* count,
                          int32_t* scratch, void* stream) {
  FilterOp op{x, threshold, out, {capacity}};
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  return static_cast<int>(dbt::compact_streams<1>(
      op, n, vec, count, scratch, static_cast<cudaStream_t>(stream)));
}
