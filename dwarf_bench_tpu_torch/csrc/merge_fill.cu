// Fused fill pass of the bitonic merge probe.
//
// Replaces dwarf_bench_tpu/ops/merge_fill_pallas.py:52 merge_fill_pallas. Over
// the merged order of (sk, sa[, dv]) it computes, per row i:
//   carry(i) = unsigned max of key+1 over source rows <= i (a source row has
//              bit 31 of sa clear; EMPTY + 1 wraps to 0, which means "none");
//   fill(i)  = uint32 sum of the source rows' deltas <= i: sa & 0xFFFF in
//              val16 mode, dv in 32-bit mode, nothing in membership mode;
//   found    = query row && carry == key + 1 && key != EMPTY;
//   dest     = (qidx << 1) | found for a query row whose index
//              qidx = sa & 0x7FFFFFFF is below nq, 0xFFFFFFFF elsewhere;
//   val      = found ? fill (mod 2^16 in val16 mode) : 0, and 0 in
//              membership mode.
//
// The TPU kernel carries the two running values in SMEM across its
// sequential grid. Blocks on the card run in no order, so the pass is a
// reduce-then-scan in three launches on one stream, with the two carries
// (a uint32 sum and a uint32 max, both associative) scanned as a pair:
//   1. tile_totals:  each block reduces one tile of kTile rows to a pair;
//   2. tile_offsets: one block turns the pairs, in place, into exclusive
//                    tile prefixes;
//   3. tile_fill:    each block scans its tile again from its prefix and
//                    writes dest and val.
// Each thread owns kItems consecutive rows. The input columns are read twice
// and the two outputs written once (up to 20 bytes a row in 32-bit mode), so
// the pass is bound by device-memory bandwidth. N is any length: the TPU
// kernel's multiple-of-32768 block constraint does not carry over.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kOffsetThreads = 1024;
constexpr uint32_t kTag = 0x80000000u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

enum Mode : int { kVal32 = 0, kVal16 = 1, kMembership = 2 };

struct Pair {
  uint32_t sum;
  uint32_t mx;
};

__device__ __forceinline__ Pair combine(Pair a, Pair b) {
  return {a.sum + b.sum, a.mx > b.mx ? a.mx : b.mx};
}

struct Fill {
  const uint32_t* sk;
  const uint32_t* sa;
  const uint32_t* dv;  // 32-bit mode only
  int64_t n;
  int mode;

  // A row's contribution to the two carries (the identity past n and for
  // query rows).
  __device__ __forceinline__ Pair contrib(int64_t i, uint32_t& k,
                                          uint32_t& a) const {
    if (i >= n) {
      k = a = 0u;
      return {0u, 0u};
    }
    k = sk[i];
    a = sa[i];
    if (a & kTag) return {0u, 0u};
    uint32_t v = 0u;
    if (mode == kVal16) {
      v = a & 0xFFFFu;
    } else if (mode == kVal32) {
      v = dv[i];
    }
    return {v, k + 1u};
  }
};

__device__ __forceinline__ Pair warp_inclusive(Pair v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Pair t;
    t.sum = __shfl_up_sync(0xffffffffu, v.sum, d);
    t.mx = __shfl_up_sync(0xffffffffu, v.mx, d);
    if (lane >= d) v = combine(t, v);
  }
  return v;
}

// Exclusive scan of one pair per thread across the block (blockDim.x a
// multiple of 32); writes the block's total to *total. Every thread of the
// block must call it.
__device__ __forceinline__ Pair block_exclusive(Pair v, Pair* total) {
  __shared__ Pair warp_tot[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const Pair inc = warp_inclusive(v);
  // the max has no inverse, so the exclusive value is the inclusive value
  // of the lane below
  Pair exc;
  exc.sum = __shfl_up_sync(0xffffffffu, inc.sum, 1);
  exc.mx = __shfl_up_sync(0xffffffffu, inc.mx, 1);
  if (lane == 0) exc = {0u, 0u};
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const Pair w = lane < nwarps ? warp_tot[lane] : Pair{0u, 0u};
    warp_tot[lane] = warp_inclusive(w);
  }
  __syncthreads();
  const Pair before = warp == 0 ? Pair{0u, 0u} : warp_tot[warp - 1];
  *total = warp_tot[nwarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return combine(before, exc);
}

__global__ void __launch_bounds__(kThreads)
    tile_totals(Fill f, Pair* __restrict__ tiles) {
  const int64_t first = (int64_t)blockIdx.x * kTile + threadIdx.x * kItems;
  Pair own{0u, 0u};
  uint32_t k, a;
#pragma unroll
  for (int j = 0; j < kItems; ++j) own = combine(own, f.contrib(first + j, k, a));
  Pair total;
  block_exclusive(own, &total);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kOffsetThreads)
    tile_offsets(Pair* __restrict__ tiles, int64_t ntiles) {
  Pair carry{0u, 0u};
  for (int64_t b = 0; b < ntiles; b += blockDim.x) {
    const int64_t i = b + threadIdx.x;
    const Pair v = i < ntiles ? tiles[i] : Pair{0u, 0u};
    Pair total;
    const Pair before = block_exclusive(v, &total);
    if (i < ntiles) tiles[i] = combine(carry, before);
    carry = combine(carry, total);
  }
}

__global__ void __launch_bounds__(kThreads)
    tile_fill(Fill f, const Pair* __restrict__ tiles, int64_t nq,
              uint32_t* __restrict__ dest, uint32_t* __restrict__ val) {
  const int64_t first = (int64_t)blockIdx.x * kTile + threadIdx.x * kItems;
  uint32_t k[kItems], a[kItems];
  Pair c[kItems];
  Pair own{0u, 0u};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    c[j] = f.contrib(first + j, k[j], a[j]);
    own = combine(own, c[j]);
  }
  Pair total;
  Pair run = combine(tiles[blockIdx.x], block_exclusive(own, &total));
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j;
    if (i >= f.n) break;
    run = combine(run, c[j]);  // inclusive of row i
    const bool is_src = (a[j] & kTag) == 0u;
    const bool found = !is_src && run.mx == k[j] + 1u && k[j] != kEmpty;
    uint32_t fv = run.sum;
    if (f.mode == kVal16) fv &= 0xFFFFu;
    val[i] = (found && f.mode != kMembership) ? fv : 0u;
    const uint32_t qp = a[j] & 0x7FFFFFFFu;
    const bool is_real = !is_src && (int64_t)qp < nq;
    dest[i] = is_real ? ((qp << 1) | (found ? 1u : 0u)) : kEmpty;
  }
}

inline int64_t fill_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// int32 scratch words dbt_merge_fill needs for n rows.
extern "C" int64_t dbt_merge_fill_scratch(int64_t n) {
  return 2 * fill_tiles(n);
}

// dv is read only in mode 0 (32-bit); mode 1 is val16, mode 2 membership.
// scratch holds dbt_merge_fill_scratch(n) words.
extern "C" int dbt_merge_fill(const int32_t* sk, const int32_t* sa,
                              const int32_t* dv, int64_t n, int64_t nq,
                              int32_t mode, int32_t* dest, int32_t* val,
                              int32_t* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t ntiles = fill_tiles(n);
  Fill f{reinterpret_cast<const uint32_t*>(sk),
         reinterpret_cast<const uint32_t*>(sa),
         reinterpret_cast<const uint32_t*>(dv), n, mode};
  Pair* tiles = reinterpret_cast<Pair*>(scratch);
  tile_totals<<<(unsigned)ntiles, kThreads, 0, s>>>(f, tiles);
  tile_offsets<<<1, kOffsetThreads, 0, s>>>(tiles, ntiles);
  tile_fill<<<(unsigned)ntiles, kThreads, 0, s>>>(
      f, tiles, nq, reinterpret_cast<uint32_t*>(dest),
      reinterpret_cast<uint32_t*>(val));
  return static_cast<int>(cudaGetLastError());
}
