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
// Each block keeps `copies` private tables of ga * gb uint32 cells in shared
// memory, each warp adds into table (warp % copies) with shared-memory
// atomics, and the block merges its tables into the output with one global
// atomic a non-zero cell (as csrc/groupby.cu). Bound on the card: 8 bytes
// read for each row the mode reads (all rows for full, 1/rows of them for
// dotonly, gb of every w columns for nodot) plus shared-atomic contention on
// few cells.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSharedBudget = 48 * 1024;
constexpr int kFull = 0;
constexpr int kDotOnly = 1;
constexpr int kNoDot = 2;

__device__ __forceinline__ uint32_t planes(int32_t v) {
  return static_cast<uint32_t>(v & 0x7F) + static_cast<uint32_t>(v >> 7);
}

__global__ void gb_diag_kernel(const int32_t* __restrict__ keys,
                               const int32_t* __restrict__ vals, int64_t n,
                               int64_t items, uint32_t* __restrict__ out,
                               uint32_t ga, uint32_t gb, uint32_t shift,
                               int64_t w, int64_t block, uint32_t rows,
                               int mode, uint32_t copies) {
  extern __shared__ uint32_t tables[];
  const uint32_t cells = ga * gb;
  for (uint32_t c = threadIdx.x; c < cells * copies; c += blockDim.x) {
    tables[c] = 0;
  }
  __syncthreads();
  uint32_t* mine = tables + ((threadIdx.x >> 5) % copies) * cells;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < items;
       j += stride) {
    int64_t i = j;
    if (mode == kDotOnly) i = (j / w) * block + j % w;
    if (mode == kNoDot) i = (j / gb) * w + j % gb;
    // rows past n are the zero padding: only nodot reads them
    if (i >= n && mode != kNoDot) continue;
    const int32_t k = i < n ? keys[i] : 0;
    const int32_t v = i < n ? vals[i] : 0;
    const uint32_t ku = static_cast<uint32_t>(k);
    if (ku >= cells) continue;
    const uint32_t p = planes(v);
    if (mode == kNoDot) {
      const uint32_t col = static_cast<uint32_t>(j % gb);
      const uint32_t lo = ku & (gb - 1);
      atomicAdd(&mine[(ku >> shift) * gb + col], 0xFFFFFF80u);  // -128
      if (lo < ga) atomicAdd(&mine[lo * gb + col], p);
    } else {
      atomicAdd(&mine[ku], mode == kDotOnly ? p * rows : p);
    }
  }
  __syncthreads();
  for (uint32_t c = threadIdx.x; c < cells; c += blockDim.x) {
    uint32_t s = 0;
    for (uint32_t t = 0; t < copies; ++t) s += tables[t * cells + c];
    if (s != 0) atomicAdd(&out[c], s);
  }
}

}  // namespace

// out must hold ga * gb zeros (a row-major (ga, gb) matrix); ga * gb <= 4096,
// gb a power of two <= w, mode 0 full, 1 dotonly, 2 nodot.
extern "C" int dbt_gb_diag(const int32_t* keys, const int32_t* vals,
                           int64_t n, int32_t* out, int32_t ga, int32_t gb,
                           int32_t rows, int64_t w, int32_t mode,
                           void* stream) {
  const int64_t block = static_cast<int64_t>(rows) * w;
  const int64_t padded = (n + block - 1) / block * block;
  int64_t items = 0;
  if (mode == kFull) items = n;
  if (mode == kDotOnly) items = padded / block * w;
  if (mode == kNoDot) items = padded / w * gb;
  if (items == 0) return static_cast<int>(cudaGetLastError());
  const uint32_t cells = static_cast<uint32_t>(ga) * gb;
  uint32_t copies = kSharedBudget / (cells * sizeof(uint32_t));
  if (copies > kThreads / 32) copies = kThreads / 32;
  if (copies < 1) copies = 1;
  uint32_t shift = 0;
  while ((1u << shift) < static_cast<uint32_t>(gb)) ++shift;
  const int smem = static_cast<int>(copies * cells * sizeof(uint32_t));
  const int grid = dbt::grid_for(items, kThreads, 2);
  gb_diag_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, vals, n, items, reinterpret_cast<uint32_t*>(out),
      static_cast<uint32_t>(ga), static_cast<uint32_t>(gb), shift, w, block,
      static_cast<uint32_t>(rows), mode, copies);
  return static_cast<int>(cudaGetLastError());
}
