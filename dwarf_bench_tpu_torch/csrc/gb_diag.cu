// The three diagnostic modes of the TPU's SWAR group-by block kernel.
//
// Replaces scripts/measure_r5.py:485 _gb_diag_kernel_factory. The TPU kernel
// pads keys and values with 0 to a multiple of rows * w, splits each key into
// a hi digit (k >> log2(gb)) and a lo digit (k & (gb - 1)), builds byte
// one-hots of the digits and two 7-bit value planes with SWAR arithmetic,
// and feeds them to int8 dots in blocks of rows x w. Its modes, as closed
// forms over the keys in [0, ga * gb) (others are dropped here, as by the
// groupby_small contract; the TPU's bytes alias for hi >= 256), with
// p(v) = (v & 0x7F) + (v >> 7), the two planes added without the hi plane's
// << 7, and every sum wrapping mod 2^32:
//   full:    cell k holds the sum of p(v) over the rows with key k;
//   dotonly: rows * (full over only the first w rows of each rows * w block);
//   nodot:   cell (a, c) holds, over every padded row r of w columns, with
//            k and v the key and value at column c < gb of row r,
//            -128 * [hi(k) == a] + p(v) * [lo(k) == a] (padding rows
//            count: their key 0 adds -128 to cell (0, c)).
//
// One launch, no memset: the output comes from torch.empty and is written
// whole.
//   - Blocks of 512 threads, up to two an SM. A thread loads kUnroll items
//     (keys and values, all before any add) a trip of its grid-stride loop,
//     so a trip waits on memory once: full at 2^22 rows fills two blocks an
//     SM, dotonly's 2^17 items take 64 blocks; nodot, two adds an item, takes
//     one item a thread, 16 blocks for its 8192 items. Each warp adds into
//     its own table in shared memory (no two warps' atomics meet on an
//     address). Grids with more items a thread put a small mode's atomics on
//     fewer SMs and were slower (PERF.md §6, #21n).
//   - No aggregation in registers before the shared atomic: a lane's
//     run-length fold (one add a run of one cell) measured slower on random
//     keys, where a run is one row, and a warp vote on the cell
//     (__match_any_sync, __reduce_add_sync) 5x slower in full mode: a warp
//     of random keys over 64 cells holds about 1.3 lanes a cell.
//   - A block folds its tables (the lanes of a cell over the copies, then
//     warp shuffles). A grid of one block writes the output itself.
//     Otherwise each block adds its non-zero cells into an accumulator in
//     the per-stream scratch (ops/_build.py stream_scratch) with reductions
//     it does not wait for, and thread 0 takes a ticket with one
//     acquire-release atomic after the block's barrier (the pattern of
//     CUTLASS's semaphores: the barrier orders the block's adds before the
//     release). The block with the last ticket copies the accumulator into
//     the output and zeroes it and the ticket, so the scratch is left as it
//     was found. No atomic touches the output, and no fence waits on every
//     thread.
// Bound on the card: 8 bytes read for each row the mode reads (all rows for
// full, 1/rows of them for dotonly, gb of every w columns for nodot), the
// cells written. The small modes move a few hundred kilobytes: the launch
// and the chain of one load, the block's adds and the ticket are their time.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // items a thread loads before it adds any
constexpr int kBlocksPerSm = 2;
constexpr int kMaxCopies = kThreads / 32;  // one table a warp
constexpr int kSharedBudget = 40 * 1024;
constexpr int64_t kHeader = 32;  // scratch words before the accumulator
constexpr int kFull = 0;
constexpr int kDotOnly = 1;
constexpr int kNoDot = 2;

__device__ __forceinline__ uint32_t planes(int32_t v) {
  return static_cast<uint32_t>(v & 0x7F) + static_cast<uint32_t>(v >> 7);
}

__device__ __forceinline__ uint32_t ticket_acq_rel(uint32_t* p) {
  uint32_t old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// The row that item j of the mode reads. dotonly reads the first w rows of
// each block of rows * w, nodot the first gb columns of each row of w.
template <int kMode, bool kPow2W>
__device__ __forceinline__ int64_t row_of(int64_t j, int64_t w, int wshift,
                                          int64_t block, uint32_t gb,
                                          int gshift) {
  if (kMode == kDotOnly) {
    const int64_t q = kPow2W ? j >> wshift : j / w;
    return q * block + (j - q * w);
  }
  if (kMode == kNoDot) return (j >> gshift) * w + (j & (gb - 1));
  return j;
}

// scratch[0] is the ticket, scratch[kHeader + c] the accumulator of cell c;
// both zero on entry and on exit. Shared memory: `copies` tables of `cells`
// words. `lanes` (a power of two <= 32) threads fold a cell.
template <int kMode, bool kPow2W>
__global__ void __launch_bounds__(kThreads)
    gb_diag_kernel(const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ vals, int64_t n, int64_t items,
                   uint32_t* __restrict__ out, uint32_t* scratch, uint32_t ga,
                   uint32_t gb, int gshift, int64_t w, int wshift,
                   int64_t block, uint32_t rows, uint32_t copies,
                   uint32_t lanes) {
  extern __shared__ uint32_t tables[];
  __shared__ bool s_last;
  const uint32_t cells = ga * gb;
  for (uint32_t c = threadIdx.x; c < cells * copies; c += kThreads) {
    tables[c] = 0;
  }
  __syncthreads();
  uint32_t* mine = tables + ((threadIdx.x >> 5) % copies) * cells;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j0 = (int64_t)blockIdx.x * kThreads + threadIdx.x; j0 < items;
       j0 += kUnroll * stride) {
    uint32_t kk[kUnroll];
    int32_t vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * stride;
      const int64_t i = row_of<kMode, kPow2W>(j, w, wshift, block, gb, gshift);
      // rows past n are nodot's zero padding (key 0, value 0); full and
      // dotonly skip them, as every mode skips items past its count
      const bool in = j < items && i < n;
      kk[u] = in ? static_cast<uint32_t>(keys[i]) : 0u;
      vv[u] = in ? vals[i] : 0;
      if (j >= items || (kMode != kNoDot && i >= n)) kk[u] = 0xFFFFFFFFu;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t ku = kk[u];
      if (ku >= cells) continue;
      const uint32_t p = planes(vv[u]);
      if (kMode == kNoDot) {
        const uint32_t col = static_cast<uint32_t>(j0 + u * stride) & (gb - 1);
        const uint32_t lo = ku & (gb - 1);
        atomicAdd(&mine[(ku >> gshift) * gb + col], 0xFFFFFF80u);  // -128
        if (lo < ga) atomicAdd(&mine[lo * gb + col], p);
      } else {
        atomicAdd(&mine[ku], kMode == kDotOnly ? p * rows : p);
      }
    }
  }
  __syncthreads();
  const bool single = gridDim.x == 1;
  uint32_t* acc = scratch + kHeader;
  // thread t folds copies l, l + lanes, ... of cell t / lanes (l = t %
  // lanes); the lanes of a cell are neighbours in one warp
  for (uint32_t base = 0; base < cells * lanes; base += kThreads) {
    const uint32_t t = base + threadIdx.x;
    const uint32_t c = t / lanes;
    uint32_t s = 0;
    if (c < cells) {
      for (uint32_t copy = t % lanes; copy < copies; copy += lanes) {
        s += tables[copy * cells + c];
      }
    }
    for (uint32_t d = lanes >> 1; d > 0; d >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, d);
    }
    if (c < cells && t % lanes == 0) {
      if (single) {
        out[c] = s;
      } else if (s != 0) {
        atomicAdd(acc + c, s);  // a reduction: nothing waits for it
      }
    }
  }
  if (single) return;
  __syncthreads();
  if (threadIdx.x == 0) s_last = ticket_acq_rel(scratch) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  for (uint32_t c = threadIdx.x; c < cells; c += kThreads) {
    out[c] = __ldcg(acc + c);
    acc[c] = 0;
  }
  if (threadIdx.x == 0) scratch[0] = 0;
}

}  // namespace

// out holds ga * gb int32 (a row-major (ga, gb) matrix), written whole;
// ga * gb <= 4096, gb a power of two <= w, mode 0 full, 1 dotonly, 2 nodot,
// n > 0. scratch holds scratch_words >= 32 + ga * gb int32, all zero; the
// kernel leaves them zero, so one buffer serves every call on a stream.
extern "C" int dbt_gb_diag(const int32_t* keys, const int32_t* vals,
                           int64_t n, int32_t* out, int32_t ga, int32_t gb,
                           int32_t rows, int64_t w, int32_t mode,
                           int32_t* scratch, int64_t scratch_words,
                           void* stream) {
  const int64_t cells = static_cast<int64_t>(ga) * gb;
  if (mode < kFull || mode > kNoDot || n < 1 || cells < 1 ||
      scratch_words < kHeader + cells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t block = static_cast<int64_t>(rows) * w;
  const int64_t padded = (n + block - 1) / block * block;
  int64_t items = n;
  if (mode == kDotOnly) items = padded / block * w;
  if (mode == kNoDot) items = padded / w * gb;
  int64_t copies = kSharedBudget / (cells * 4);
  if (copies > kMaxCopies) copies = kMaxCopies;
  if (copies < 1) copies = 1;
  uint32_t lanes = 1;
  while (lanes < 32 && lanes * 2 * cells <= kThreads) lanes *= 2;
  int gshift = 0;
  while ((1 << gshift) < gb) ++gshift;
  int wshift = 0;
  while ((int64_t{1} << wshift) < w) ++wshift;
  const bool pow2_w = (int64_t{1} << wshift) == w;
  const int smem = static_cast<int>(copies * cells * sizeof(uint32_t));
  // nodot makes two adds an item: one item a thread spreads its adds over
  // more SMs (16 blocks at 2^22 rows; 4 blocks of kUnroll items a thread
  // took 0.0034 ms against 0.0031)
  const int64_t per_thread = mode == kNoDot ? 1 : kUnroll;
  const int64_t grid = dbt::grid_for((items + per_thread - 1) / per_thread,
                                     kThreads, kBlocksPerSm);
  auto* o = reinterpret_cast<uint32_t*>(out);
  auto* s = reinterpret_cast<uint32_t*>(scratch);
  const auto ua = static_cast<uint32_t>(ga);
  const auto ub = static_cast<uint32_t>(gb);
  const auto ur = static_cast<uint32_t>(rows);
  const auto uc = static_cast<uint32_t>(copies);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  if (mode == kFull) {
    gb_diag_kernel<kFull, false><<<g, kThreads, smem, st>>>(
        keys, vals, n, items, o, s, ua, ub, gshift, w, wshift, block, ur, uc,
        lanes);
  } else if (mode == kNoDot) {
    gb_diag_kernel<kNoDot, false><<<g, kThreads, smem, st>>>(
        keys, vals, n, items, o, s, ua, ub, gshift, w, wshift, block, ur, uc,
        lanes);
  } else if (pow2_w) {
    gb_diag_kernel<kDotOnly, true><<<g, kThreads, smem, st>>>(
        keys, vals, n, items, o, s, ua, ub, gshift, w, wshift, block, ur, uc,
        lanes);
  } else {
    gb_diag_kernel<kDotOnly, false><<<g, kThreads, smem, st>>>(
        keys, vals, n, items, o, s, ua, ub, gshift, w, wshift, block, ur, uc,
        lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
