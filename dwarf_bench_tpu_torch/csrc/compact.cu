// Mask compaction of 1-3 int32 columns, and the prefix emit.
//
// dbt_compact_mask replaces dwarf_bench_tpu/ops/compact_pallas.py:195
// compact_mask_pallas (kernel _compact_mask_call, :61): copy_if of each
// column by one mask, keeping order, into `capacity` slots, with the full
// count. One set of ranks (compact.cuh) serves every column, as the TPU
// kernel's one set of butterfly routing decisions does: one launch, the
// mask read once (4 bytes a lane where it is 4-byte aligned, one otherwise),
// the columns read only at kept rows. The mask is one byte a row
// (torch.bool). Bound by device-memory bandwidth: the mask, and the kept rows
// of each column read and written. At half density every 32-byte sector of a
// column holds a kept row, so the card reads the columns whole.
//
// dbt_emit_prefix replaces compact_pallas.py:225 emit_prefix_pallas: the
// first `len` values into slots [0, len) of an uninitialised buffer, the rest
// left as it is (garbage past the caller's count, by contract). The TPU
// kernel is one DMA of the values its pair sort already ordered; the card's
// sort orders positions only, so the kernel takes an optional int64 index
// and writes out[i] = vals[index[i]], the scan's gather and its emit in one
// launch (ops/scan.py). On the scan's path it writes 80 KB, a launch's worth
// of work, so it stays a grid-stride loop of 4-byte copies: measured on an
// H100 (PERF.md), neither 16-byte vectors nor Hopper's bulk-copy engine
// (cp.async.bulk through shared memory) beat it by graph or cold time.
#include "compact.cuh"

namespace {

struct MaskOp {
  static constexpr int kThreads = 512;
  static constexpr int kVecs = 4;
  // three blocks an SM (40 registers): its rows are a byte each, so the
  // bytes in flight are the resident blocks' column reads
  static constexpr int kMinBlocks = 3;
  using Item = uint8_t;
  const uint8_t* mask;
  const int32_t* col[3];
  int32_t* out[3];
  int ncols;
  int64_t cap[1];

  __device__ Item load(int64_t i) const { return mask[i]; }
  __device__ void load4(int64_t i, Item (&it)[4]) const {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(mask + i);
    it[0] = w & 0xFFu;
    it[1] = (w >> 8) & 0xFFu;
    it[2] = (w >> 16) & 0xFFu;
    it[3] = w >> 24;
  }
  __device__ void flags(Item m, bool (&keep)[1]) const { keep[0] = m != 0; }
  __device__ void prefetch(int64_t i) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < ncols) {
        asm volatile("prefetch.global.L2 [%0];" : : "l"(col[c] + i));
      }
    }
  }
  // a kept row stages its index; the columns are read at it when written
  struct Value {
    int32_t v[3];
  };
  __device__ uint32_t stage(Item, int64_t i, int) const {
    return static_cast<uint32_t>(i);
  }
  // unrolled, so the pointer arrays are indexed by constants and stay in
  // registers (a loop bound by ncols put a copy of the Op on the stack)
  __device__ Value fetch(uint32_t row, int) const {
    Value r{};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < ncols) r.v[c] = col[c][row];
    }
    return r;
  }
  __device__ void store(const Value& r, int, int64_t pos) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < ncols) out[c][pos] = r.v[c];
    }
  }
  __device__ void last_tile(const uint32_t (&)[1]) const {}
};

// out[i] = vals[i], or with an index vals[index[i]], for i < len: one
// value a thread and step of a grid-stride loop over 256-lane blocks.
template <bool kIndexed>
__global__ void copy_prefix(const int32_t* __restrict__ vals,
                            const int64_t* __restrict__ index, int64_t len,
                            int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += stride) {
    out[i] = vals[kIndexed ? index[i] : i];
  }
}

}  // namespace

// int32 scratch words that a compaction of n rows into `streams` streams
// (dbt_compact_mask and dbt_filter: 1, dbt_scan_tail_streams: 2) needs.
extern "C" int64_t dbt_compact_scratch(int64_t n, int32_t streams) {
  return dbt::compaction_scratch_words(n, streams);
}

// cols/outs hold ncols (1-3) pointers; unused ones may be null. count points
// to one int32 on the device; scratch holds dbt_compact_scratch(n, 1) int32
// words, 8-byte aligned and zero, and is left zero, so one buffer serves
// every call on a stream. n is below 2^31.
extern "C" int dbt_compact_mask(const uint8_t* mask, const int32_t* c0,
                                const int32_t* c1, const int32_t* c2,
                                int32_t ncols, int64_t n, int32_t* o0,
                                int32_t* o1, int32_t* o2, int64_t capacity,
                                int32_t* count, int32_t* scratch,
                                void* stream) {
  MaskOp op{mask, {c0, c1, c2}, {o0, o1, o2}, ncols, {capacity}};
  const bool vec = (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  return static_cast<int>(dbt::compact_streams<1>(
      op, n, vec, count, scratch, static_cast<cudaStream_t>(stream)));
}

// out[i] = vals[i] for i < len or, with an index (len int64, each a valid
// position of vals), out[i] = vals[index[i]]; out's other slots are left as
// they are. One launch; none for len 0.
extern "C" int dbt_emit_prefix(const int32_t* vals, const int64_t* index,
                               int64_t len, int32_t* out, void* stream) {
  if (len > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = dbt::grid_for(len, 256, 8);
    if (index != nullptr) {
      copy_prefix<true><<<grid, 256, 0, s>>>(vals, index, len, out);
    } else {
      copy_prefix<false><<<grid, 256, 0, s>>>(vals, index, len, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
