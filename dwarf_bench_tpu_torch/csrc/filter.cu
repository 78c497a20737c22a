// copy_if(x, x < threshold) of an int32 column.
//
// Replaces dwarf_bench_tpu/ops/scan_pallas.py:80 filter_pallas: (out, count)
// with the kept values in input order in `capacity` slots and the full count.
// The TPU kernel compacts each (8, 2048) block with a roll butterfly and
// streams it out through a 128-aligned carry buffer; here the ordered
// three-phase compaction of compact.cuh does the work, with the predicate
// evaluated in both of its passes over x. Bound by reading x twice (128 MB at
// 2^24 rows); the TPU kernel's `tile` knob has no counterpart.
#include "compact.cuh"

namespace {

struct FilterOp {
  using Item = int32_t;
  const int32_t* x;
  int32_t threshold;
  int32_t* out;
  int64_t cap[1];

  __device__ Item load(int64_t i) const { return x[i]; }
  __device__ void flags(Item v, bool (&keep)[1]) const {
    keep[0] = v < threshold;
  }
  __device__ void emit(Item v, int64_t, int, int64_t pos) const {
    out[pos] = v;
  }
};

}  // namespace

// count points to one int32 on the device; scratch holds
// dbt_compact_tiles(n) int32 words.
extern "C" int dbt_filter(const int32_t* x, int64_t n, int32_t threshold,
                          int32_t* out, int64_t capacity, int32_t* count,
                          int32_t* scratch, void* stream) {
  FilterOp op{x, threshold, out, {capacity}};
  return static_cast<int>(dbt::compact_streams<1>(
      op, n, count, scratch, static_cast<cudaStream_t>(stream)));
}
