// The counting sort's run expansion: the sorted column of a histogram.
//
// out[i] = shift + b for the b with C[b] <= i < C[b + 1], C the exclusive
// cumsum of counts (nbins int32 summing to n, nbins <= 2^14), wrapping mod
// 2^32. Replaces the expansion of dwarf_bench_tpu/ops/sort.py:79
// _expand_runs, which scatters the bin starts into an n-row zero column and
// expands it with cumsum_pallas (the port ran the same as a 512 MB zero
// fill, a scatter and the cumsum kernel at 2^27 rows: three passes over n
// words). Here each row is stored once, straight from the bin starts.
//
// Bound on the card: device-memory bandwidth, n * 4 bytes written (the
// counts, at most 64 KB, are read from the L2). The design, in one launch
// with no scratch and no memset:
//   - a grid sized from n: one block an SM at most, one block for a column
//     of a tile or less; each block owns a contiguous run of tiles of
//     kTile rows;
//   - each block loads the counts into shared memory (one coalesced batch
//     of loads a thread) and scans them there into the bin starts: thread t
//     sums bins [32t, 32t + 32) and one block scan joins the threads. The
//     starts are stored with a pad word every 32, so the 32 lanes of a warp
//     reading bins 32t + q hit 32 banks;
//   - a thread writes 16 bytes at a time, the lanes of a warp on 512
//     neighbouring bytes, with streaming stores. It keeps the bin of its
//     last row and where that bin ends, so a row inside the bin costs one
//     compare; past the end it gallops forward over the starts (one probe,
//     then 2, 4, ...) and bisects, so crossing d bins costs O(log d)
//     probes, and the cost of a row stays flat from one bin holding every
//     row to runs of one row each.
// The shift is read on the device from shift_ptr when it is not null (the
// sort's min needs no trip to the host), else taken by value.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                    // int4 stores a thread a tile
constexpr int kWarpRows = 32 * 4 * kVecs;   // 512 rows a warp a tile
constexpr int kTile = kWarps * kWarpRows;   // 8192 rows a block a tile
constexpr int kMaxBins = 1 << 14;
constexpr int kBinsPerThread = kMaxBins / kThreads;  // 32
// blocks an SM: 1 and 2 tie at 2^27 rows, 1 is 7 % faster at 2^22 (the
// plan sweep, PERF.md)
constexpr int kBlocksPerSm = 1;

static_assert(kBinsPerThread == 32, "the padded layout pads every 32 bins");

// shared-memory word of bin start b: one pad word every 32 bins
__device__ __forceinline__ int pad(int b) { return b + (b >> 5); }

// Moves (b, end) to the bin of row x: end is the start of bin b + 1, and x
// never decreases from one call to the next. st holds the starts, with
// st[pad(nbins)] = n > x, so the gallop stops at nbins at the latest.
__device__ __forceinline__ void seek(const uint32_t* st, int nbins,
                                     uint32_t x, int& b, uint32_t& end) {
  if (x < end) return;
  int lo = b + 1;  // start of bin lo <= x
  int hi;
  for (int step = 1;; step <<= 1) {
    const int probe = min(lo + step, nbins);
    const uint32_t s = st[pad(probe)];
    if (s > x) {
      hi = probe;
      end = s;
      break;
    }
    lo = probe;
  }
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    const uint32_t s = st[pad(mid)];
    if (s <= x) {
      lo = mid;
    } else {
      hi = mid;
      end = s;
    }
  }
  b = lo;
}

__global__ void __launch_bounds__(kThreads)
    expand_runs_kernel(const int32_t* __restrict__ counts, int nbins,
                       int64_t n, const int32_t* __restrict__ shift_ptr,
                       uint32_t shift_val, int32_t* __restrict__ out,
                       int64_t tiles_per_block) {
  extern __shared__ uint32_t st[];  // pad(nbins) + 1 words
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  {  // the counts, every load of a thread in flight at once
    uint32_t c[kBinsPerThread];
#pragma unroll
    for (int u = 0; u < kBinsPerThread; ++u) {
      const int k = u * kThreads + t;
      c[u] = k < nbins ? static_cast<uint32_t>(__ldg(counts + k)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBinsPerThread; ++u) {
      const int k = u * kThreads + t;
      if (k < nbins) st[pad(k)] = c[u];
    }
  }
  __syncthreads();
  const int first = kBinsPerThread * t;
  uint32_t sum = 0;
#pragma unroll
  for (int q = 0; q < kBinsPerThread; ++q) {
    if (first + q < nbins) sum += st[pad(first + q)];
  }
  uint32_t total;
  uint32_t run = dbt::block_exclusive_scan(sum, &total);
#pragma unroll
  for (int q = 0; q < kBinsPerThread; ++q) {
    if (first + q < nbins) {
      const uint32_t c = st[pad(first + q)];
      st[pad(first + q)] = run;
      run += c;
    }
  }
  if (t == 0) st[pad(nbins)] = static_cast<uint32_t>(n);
  __syncthreads();

  const uint32_t shift =
      shift_ptr ? static_cast<uint32_t>(__ldg(shift_ptr)) : shift_val;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const int64_t t0 = (int64_t)blockIdx.x * tiles_per_block;
  const int64_t t1 =
      t0 + tiles_per_block < ntiles ? t0 + tiles_per_block : ntiles;
  int b = -1;        // no row seen yet: bin -1 ends where bin 0 starts
  uint32_t end = 0;
  for (int64_t tile = t0; tile < t1; ++tile) {
    const int64_t wbase = tile * kTile + (int64_t)warp * kWarpRows;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int64_t g = wbase + 4 * (32 * j + lane);
      if (g >= n) break;
      const uint32_t x = static_cast<uint32_t>(g);
      if (g + 4 <= n) {
        uint32_t v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          seek(st, nbins, x + c, b, end);
          v[c] = shift + static_cast<uint32_t>(b);
        }
        __stcs(reinterpret_cast<int4*>(out + g),
               make_int4(static_cast<int32_t>(v[0]),
                         static_cast<int32_t>(v[1]),
                         static_cast<int32_t>(v[2]),
                         static_cast<int32_t>(v[3])));
      } else {
        for (int c = 0; g + c < n; ++c) {
          seek(st, nbins, x + c, b, end);
          out[g + c] =
              static_cast<int32_t>(shift + static_cast<uint32_t>(b));
        }
      }
    }
  }
}

}  // namespace

// out (n int32, 16-byte aligned) gets the sorted column of the nbins counts
// (1 <= nbins <= 2^14, summing to n, 0 <= n < 2^31) plus the shift:
// *shift_ptr (one int32 on the device) when shift_ptr is not null, else
// shift_val. `blocks` > 0 fixes the grid (the plan sweep); 0 takes
// kBlocksPerSm blocks an SM, no more than the tiles. Bad arguments return
// cudaErrorInvalidValue and launch nothing.
extern "C" int dbt_expand_runs(const int32_t* counts, int32_t nbins,
                               int64_t n, const int32_t* shift_ptr,
                               int32_t shift_val, int32_t* out,
                               int32_t blocks, void* stream) {
  if (nbins < 1 || nbins > kMaxBins || n < 0 || n >= (int64_t{1} << 31) ||
      blocks < 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  static std::atomic<uint64_t> ready{0};
  cudaError_t err = dbt::configure(expand_runs_kernel, false, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ntiles = (n + kTile - 1) / kTile;
  int64_t grid =
      blocks > 0 ? blocks : (int64_t)dbt::num_sms() * kBlocksPerSm;
  if (grid > ntiles) grid = ntiles;
  const int64_t per = (ntiles + grid - 1) / grid;
  grid = (ntiles + per - 1) / per;
  const size_t smem = sizeof(uint32_t) * (nbins + (nbins >> 5) + 1);
  expand_runs_kernel<<<(unsigned)grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      counts, nbins, n, shift_ptr, static_cast<uint32_t>(shift_val), out,
      per);
  return static_cast<int>(cudaGetLastError());
}
