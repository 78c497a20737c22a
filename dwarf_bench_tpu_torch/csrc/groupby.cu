// Group-by sum over a small dense key space.
//
// Replaces dwarf_bench_tpu/ops/groupby_pallas.py:307 groupby_small_pallas:
// (G,) uint32 sums of v per key in [0, G), G <= 4096; keys >= G (as uint32)
// are dropped and sums wrap mod 2^32. The TPU kernel splits keys into two
// digits and v into two 7-bit bf16 planes for one-hot matmuls, because the
// TPU has no atomics; that is also where its v < 2^14 precondition comes from,
// and this kernel takes any v.
//
// Each block keeps `copies` private tables of G uint32 sums in shared memory
// and each warp adds into the table (warp % copies) with shared-memory
// atomics, so that at small G (64 on the benchmark path) the warps of a block
// do not all contend for the same G words. The block then merges the copies
// and adds each non-zero sum into the output with one global atomic. Bound on
// the card: 8 bytes read a row plus shared-atomic contention, which grows as
// G shrinks (lanes of one warp that hit the same key serialize).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSharedBudget = 48 * 1024;

__global__ void groupby_small_kernel(const int32_t* __restrict__ keys,
                                     const int32_t* __restrict__ vals,
                                     int64_t n, uint32_t* __restrict__ out,
                                     uint32_t groups, uint32_t copies) {
  extern __shared__ uint32_t tables[];
  const uint32_t words = groups * copies;
  for (uint32_t b = threadIdx.x; b < words; b += blockDim.x) tables[b] = 0;
  __syncthreads();
  uint32_t* mine = tables + ((threadIdx.x >> 5) % copies) * groups;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t k = static_cast<uint32_t>(keys[i]);
    if (k < groups) atomicAdd(&mine[k], static_cast<uint32_t>(vals[i]));
  }
  __syncthreads();
  for (uint32_t g = threadIdx.x; g < groups; g += blockDim.x) {
    uint32_t s = 0;
    for (uint32_t c = 0; c < copies; ++c) s += tables[c * groups + g];
    if (s != 0) atomicAdd(&out[g], s);
  }
}

}  // namespace

// out must hold `groups` zeros; 1 <= groups <= 4096.
extern "C" int dbt_groupby_small(const int32_t* keys, const int32_t* vals,
                                 int64_t n, int32_t* out, int32_t groups,
                                 void* stream) {
  const uint32_t g = static_cast<uint32_t>(groups);
  uint32_t copies = kSharedBudget / (g * sizeof(uint32_t));
  if (copies > kThreads / 32) copies = kThreads / 32;
  if (copies < 1) copies = 1;
  const int smem = static_cast<int>(copies * g * sizeof(uint32_t));
  const int grid = dbt::grid_for(n, kThreads, 2);
  groupby_small_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      keys, vals, n, reinterpret_cast<uint32_t*>(out), g, copies);
  return static_cast<int>(cudaGetLastError());
}
