// Bitonic merge of 2-4 uint32 columns.
//
// Replaces dwarf_bench_tpu/ops/bitonic_pallas.py:100 merge_bitonic_pallas:
// sort a bitonic sequence of N = 2^k rows ascending under the unsigned
// lexicographic order of (col0[, col1]); every column rides the exchanges.
// The network is exactly Batcher's, as ops/bitonic.py runs it: for every
// stride s = N/2 ... 1 and every row i with (i & s) == 0, rows i and i + s
// swap in all columns iff row i + s is less than row i, and neither moves on
// equality. The same pairs and the same tie rule give the plain network's
// output bit for bit on every input, ties included.
//
// The TPU kernel runs the network in two streaming passes (a column cascade
// and a row cascade in VMEM). This first Hopper design is bound by
// device-memory traffic of one pass per global stride:
//   - strides s >= kTile: one launch per stride, one thread per pair; each
//     reads and writes every column once;
//   - strides kTile/2 ... 1: one launch in which each block loads a
//     kTile-row tile of every column into shared memory and runs the
//     remaining strides between __syncthreads().
// At N = 2^25 with three columns that is 14 + 1 launches and about 11 GB of
// traffic. The first launch reads the input and writes the output, so the
// merge is out of place without a separate copy.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 4;
constexpr int kTile = 2048;  // rows per shared-memory tile: 32 KB at 4 cols
constexpr int kTileThreads = 1024;
constexpr int kThreads = 256;

struct Cols {
  const uint32_t* src[kMaxCols];
  uint32_t* dst[kMaxCols];
  int ncols;
  int num_cmp;
};

// (a0, a1) < (b0, b1), unsigned; a1/b1 ignored when num_cmp == 1.
__device__ __forceinline__ bool less(uint32_t a0, uint32_t a1, uint32_t b0,
                                     uint32_t b1, int num_cmp) {
  return a0 < b0 || (num_cmp == 2 && a0 == b0 && a1 < b1);
}

// Row index of the low side of pair p at stride s (a power of two).
__device__ __forceinline__ int64_t low_row(int64_t p, int64_t s) {
  return ((p & ~(s - 1)) << 1) | (p & (s - 1));
}

__global__ void __launch_bounds__(kThreads)
    merge_stride(Cols c, int64_t half, int64_t s) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < half;
       p += step) {
    const int64_t i = low_row(p, s);
    const int64_t j = i + s;
    uint32_t lo[kMaxCols], hi[kMaxCols];
    // unrolled with constant indices, so the arrays stay in registers
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < c.ncols) {
        lo[k] = c.src[k][i];
        hi[k] = c.src[k][j];
      } else {
        lo[k] = hi[k] = 0u;
      }
    }
    const bool swap = less(hi[0], hi[1], lo[0], lo[1], c.num_cmp);
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < c.ncols) {
        c.dst[k][i] = swap ? hi[k] : lo[k];
        c.dst[k][j] = swap ? lo[k] : hi[k];
      }
    }
  }
}

// Each block sorts its own tile of `rows` rows (a power of two <= kTile),
// which the global strides have left bitonic: strides rows/2 ... 1.
__global__ void __launch_bounds__(kTileThreads)
    merge_tile(Cols c, int64_t rows) {
  __shared__ uint32_t sm[kMaxCols][kTile];
  const int64_t base = (int64_t)blockIdx.x * rows;
  const int r = (int)rows;
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    if (k < c.ncols) {
      for (int t = threadIdx.x; t < r; t += blockDim.x) {
        sm[k][t] = c.src[k][base + t];
      }
    }
  }
  __syncthreads();
  for (int s = r >> 1; s >= 1; s >>= 1) {
    for (int p = threadIdx.x; p < (r >> 1); p += blockDim.x) {
      const int i = ((p & ~(s - 1)) << 1) | (p & (s - 1));
      const int j = i + s;
      const uint32_t a1 = c.num_cmp == 2 ? sm[1][i] : 0u;
      const uint32_t b1 = c.num_cmp == 2 ? sm[1][j] : 0u;
      if (less(sm[0][j], b1, sm[0][i], a1, c.num_cmp)) {
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          if (k < c.ncols) {
            const uint32_t t = sm[k][i];
            sm[k][i] = sm[k][j];
            sm[k][j] = t;
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    if (k < c.ncols) {
      for (int t = threadIdx.x; t < r; t += blockDim.x) {
        c.dst[k][base + t] = sm[k][t];
      }
    }
  }
}

}  // namespace

// src/dst hold ncols (2-4) pointers each, unused ones null; n is a power of
// two (or 0), num_cmp 1 or 2. dst may equal src (in place).
extern "C" int dbt_merge_bitonic(const int32_t* s0, const int32_t* s1,
                                 const int32_t* s2, const int32_t* s3,
                                 int32_t* d0, int32_t* d1, int32_t* d2,
                                 int32_t* d3, int32_t ncols, int64_t n,
                                 int32_t num_cmp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Cols c{{reinterpret_cast<const uint32_t*>(s0),
          reinterpret_cast<const uint32_t*>(s1),
          reinterpret_cast<const uint32_t*>(s2),
          reinterpret_cast<const uint32_t*>(s3)},
         {reinterpret_cast<uint32_t*>(d0), reinterpret_cast<uint32_t*>(d1),
          reinterpret_cast<uint32_t*>(d2), reinterpret_cast<uint32_t*>(d3)},
         ncols,
         num_cmp};
  Cols in_place = c;
  for (int k = 0; k < kMaxCols; ++k) in_place.src[k] = in_place.dst[k];
  const int64_t half = n / 2;
  bool first = true;
  for (int64_t s = half; s >= kTile; s >>= 1) {
    merge_stride<<<dbt::grid_for(half, kThreads, 8), kThreads, 0, st>>>(
        first ? c : in_place, half, s);
    first = false;
  }
  const int64_t rows = n < kTile ? n : kTile;
  merge_tile<<<(unsigned)(n / rows), kTileThreads, 0, st>>>(
      first ? c : in_place, rows);
  return static_cast<int>(cudaGetLastError());
}
