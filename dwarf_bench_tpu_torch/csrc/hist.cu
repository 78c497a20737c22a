// Histograms of int32 keys, plain and weighted.
//
// histogram replaces dwarf_bench_tpu/ops/hist_pallas.py:119
// histogram_16k_swar_pallas: (nbins,) int32 counts, nbins = hi_bins * 128, of
// int32 keys; a key whose uint32 value is >= nbins (negatives, EMPTY,
// padding) counts nowhere. The TPU kernel builds SWAR byte one-hots and
// counts them on the MXU because the TPU has no atomics. Here each block keeps
// a private histogram in shared memory (64 KB at nbins = 16384, so dynamic
// shared memory above the 48 KB static limit), counts with shared-memory
// atomics, and merges its non-zero bins into the output with one global
// atomic each. Bound on the card: the key read (4 bytes a row) plus
// shared-atomic contention, which stays low for keys spread over many bins;
// the merge adds up to grid * nbins global atomics.
//
// weighted_histogram replaces dwarf_bench_tpu/ops/hist_pallas.py:482
// weighted_histogram_i8_swar_pallas and serves the same contract for
// hi_bins < 256 (dwarf_bench_tpu/ops/hist_pallas.py:383
// weighted_histogram_i8_pallas): (nbins,) int32 sums of v per bin, sums
// wrapping mod 2^32, keys >= nbins (as uint32) dropped. Any nbins is taken;
// the TPU's v < 2^14 precondition (two 7-bit int8 planes) does not apply.
// Up to 2^16 bins (256 KB) exceed one SM's shared memory, so this simple
// version adds straight into the global output, which stays in the 50 MB L2.
// Bound on the card: 8 bytes read a row plus one L2 atomic a row.
#include "common.cuh"

namespace {

constexpr int kHistThreads = 1024;
constexpr int kWeightedThreads = 256;

__global__ void histogram_kernel(const int32_t* __restrict__ keys, int64_t n,
                                 uint32_t* __restrict__ out, uint32_t nbins) {
  extern __shared__ uint32_t bins[];
  for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t k = static_cast<uint32_t>(keys[i]);
    if (k < nbins) atomicAdd(&bins[k], 1u);
  }
  __syncthreads();
  for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) {
    const uint32_t c = bins[b];
    if (c != 0) atomicAdd(&out[b], c);
  }
}

__global__ void weighted_histogram_kernel(const int32_t* __restrict__ keys,
                                          const int32_t* __restrict__ vals,
                                          int64_t n,
                                          uint32_t* __restrict__ out,
                                          uint32_t nbins) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t k = static_cast<uint32_t>(keys[i]);
    if (k < nbins) atomicAdd(&out[k], static_cast<uint32_t>(vals[i]));
  }
}

}  // namespace

// out must hold nbins zeros; nbins * 4 bytes must fit one block's shared
// memory (the wrapper allows nbins <= 16384).
extern "C" int dbt_histogram(const int32_t* keys, int64_t n, int32_t* out,
                             int32_t nbins, void* stream) {
  const int smem = nbins * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = dbt::grid_for(n, kHistThreads, 1);
  histogram_kernel<<<grid, kHistThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, n, reinterpret_cast<uint32_t*>(out),
      static_cast<uint32_t>(nbins));
  return static_cast<int>(cudaGetLastError());
}

// out must hold nbins zeros.
extern "C" int dbt_weighted_histogram(const int32_t* keys, const int32_t* vals,
                                      int64_t n, int32_t* out, int32_t nbins,
                                      void* stream) {
  const int grid = dbt::grid_for(n, kWeightedThreads, 8);
  weighted_histogram_kernel<<<grid, kWeightedThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      keys, vals, n, reinterpret_cast<uint32_t*>(out),
      static_cast<uint32_t>(nbins));
  return static_cast<int>(cudaGetLastError());
}
