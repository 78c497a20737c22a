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
// wrapping mod 2^32, keys >= nbins (as uint32) dropped. Any nbins up to 2^16
// is taken; the TPU's v < 2^14 precondition (two 7-bit int8 planes) does not
// apply. Bound on the card: 8 bytes read a row.
//
// 2^16 int32 bins are 256 KB, more than one block's 227 KB of shared memory,
// and a private copy a block would merge 132 x 2^16 bins, far more than the
// 2^20 rows of the main path. So a thread-block cluster of `cluster` blocks
// holds one copy of the histogram in its distributed shared memory: block r
// owns bins [r * per_block, (r + 1) * per_block). Every block streams its
// share of the rows (16-byte loads where aligned, two vectors of keys and two
// of values in flight a thread) and adds each value into the owning block's
// shared memory with an atomic. A warp whose 32 rows all fall in one bin (a
// hot key) sums them first (__reduce_add_sync) and adds once, so a hot key
// costs one atomic a warp, not 32 on one word. (Grouping equal keys with
// __match_any_sync and summing each group under its own mask cost 3.5x the
// old kernel's time on uniform keys at the main-path shape on an H100.) After
// cluster.sync() each block writes its slice of the cluster's copy with plain
// stores, into the output when there is one copy, else into a (copies, nbins)
// scratch that sum_copies adds up column by column. Every bin is written, so
// the output needs no memset. cluster 1 is the same design in one block.
//
// What bounds it on the card: an add into another block's shared memory
// costs several times one into the block's own, and past a few hundred
// thousand rows the cluster adds run at the same total rate whatever the
// cluster size and count. The host (ops/hist_cuda.py weighted_plan) so keeps
// the bins in one block whenever they fit (up to 2^15 bins), takes a cluster
// of 16 for 2^16 bins, and chooses copies so that copies * nbins stays at or
// below the rows. (Staging each block's rows by owner block in its own shared
// memory, for the owners to pull with contiguous loads after a cluster.sync(),
// gained less than a fifth at 2^16 bins and 2^20 rows, so the simpler design
// stays.)
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHistThreads = 1024;
constexpr int kWeightedThreads = 512;
constexpr uint32_t kDropped = 0xFFFFFFFFu;

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

// Adds one row a lane; every lane of the warp calls it. `key` is kDropped
// for a row that is out of range or past n.
template <bool kCluster>
__device__ __forceinline__ void add_row(uint32_t* bins, uint32_t key,
                                        uint32_t v, uint32_t per_block,
                                        int lane) {
  uint32_t sum = v;
  const uint32_t key0 = __shfl_sync(0xffffffffu, key, 0);
  if (__all_sync(0xffffffffu, key == key0)) {  // one bin for the whole warp
    sum = __reduce_add_sync(0xffffffffu, v);
    if (lane != 0) return;
  }
  if (key == kDropped) return;
  if constexpr (kCluster) {
    const uint32_t owner = key / per_block;
    uint32_t* dst = cg::this_cluster().map_shared_rank(
        bins + (key - owner * per_block), owner);
    atomicAdd(dst, sum);
  } else {
    atomicAdd(bins + key, sum);
  }
}

__device__ __forceinline__ uint32_t key_of(int32_t k, uint32_t nbins) {
  const uint32_t u = static_cast<uint32_t>(k);
  return u < nbins ? u : kDropped;
}

template <bool kCluster>
__device__ __forceinline__ void sync_copy() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <bool kCluster>
__global__ void __launch_bounds__(kWeightedThreads)
    weighted_histogram_kernel(const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ vals, int64_t n,
                              uint32_t nbins, uint32_t per_block,
                              uint32_t* __restrict__ copies, bool vec) {
  extern __shared__ uint32_t bins[];
  const int lane = threadIdx.x & 31;
  for (uint32_t b = threadIdx.x; b < per_block; b += blockDim.x) bins[b] = 0;
  sync_copy<kCluster>();  // every slice of the copy is zero before any add

  // warp-uniform loops, so that every lane takes part in the warp votes
  const int64_t warp_id = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  if (vec) {
    // two vectors of keys and two of values in flight a lane
    const int64_t nvec = n >> 2;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    const int4* v4 = reinterpret_cast<const int4*>(vals);
    for (int64_t base = warp_id * 32; base < nvec; base += 2 * step) {
      int4 kk[2], vv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int64_t i = base + u * step + lane;
        kk[u] = make_int4(-1, -1, -1, -1);
        vv[u] = make_int4(0, 0, 0, 0);
        if (i < nvec) {
          kk[u] = k4[i];
          vv[u] = v4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        add_row<kCluster>(bins, key_of(kk[u].x, nbins), vv[u].x, per_block,
                          lane);
        add_row<kCluster>(bins, key_of(kk[u].y, nbins), vv[u].y, per_block,
                          lane);
        add_row<kCluster>(bins, key_of(kk[u].z, nbins), vv[u].z, per_block,
                          lane);
        add_row<kCluster>(bins, key_of(kk[u].w, nbins), vv[u].w, per_block,
                          lane);
      }
    }
    if (warp_id == 0) {  // the last n % 4 rows
      const int64_t i = (nvec << 2) + lane;
      add_row<kCluster>(bins, i < n ? key_of(keys[i], nbins) : kDropped,
                        i < n ? static_cast<uint32_t>(vals[i]) : 0u,
                        per_block, lane);
    }
  } else {
    for (int64_t base = warp_id * 32; base < n; base += step) {
      const int64_t i = base + lane;
      add_row<kCluster>(bins, i < n ? key_of(keys[i], nbins) : kDropped,
                        i < n ? static_cast<uint32_t>(vals[i]) : 0u,
                        per_block, lane);
    }
  }
  sync_copy<kCluster>();  // every add has landed; no remote access after this

  // clusters are runs of consecutive blocks along x
  const uint32_t cluster = kCluster ? cg::this_cluster().num_blocks() : 1;
  const uint32_t rank = kCluster ? cg::this_cluster().block_rank() : 0;
  uint32_t* dst = copies + (int64_t)(blockIdx.x / cluster) * nbins +
                  (int64_t)rank * per_block;
  for (uint32_t b = threadIdx.x; b < per_block; b += blockDim.x) dst[b] = bins[b];
}

// out[b] = sum over c of copies[c][b], four bins a thread (nbins is a
// multiple of 128).
__global__ void sum_copies(const uint4* __restrict__ copies, int ncopies,
                           uint32_t nbins, uint4* __restrict__ out) {
  const uint32_t q = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t nq = nbins / 4;
  if (q >= nq) return;
  uint4 s = make_uint4(0, 0, 0, 0);
  for (int c = 0; c < ncopies; ++c) {
    const uint4 a = copies[(int64_t)c * nq + q];
    s.x += a.x;
    s.y += a.y;
    s.z += a.z;
    s.w += a.w;
  }
  out[q] = s;
}

std::atomic<uint64_t> histogram_ready{0};
std::atomic<uint64_t> weighted_ready{0};
std::atomic<uint64_t> weighted_cluster_ready{0};

cudaLaunchConfig_t cluster_config(int blocks, int cluster, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kWeightedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// out must hold nbins zeros; nbins * 4 bytes must fit one block's shared
// memory (the wrapper allows nbins <= 16384).
extern "C" int dbt_histogram(const int32_t* keys, int64_t n, int32_t* out,
                             int32_t nbins, void* stream) {
  const int smem = nbins * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = dbt::configure(histogram_kernel, false, histogram_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = dbt::grid_for(n, kHistThreads, 1);
  histogram_kernel<<<grid, kHistThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, n, reinterpret_cast<uint32_t*>(out),
      static_cast<uint32_t>(nbins));
  return static_cast<int>(cudaGetLastError());
}

// Writes every bin of out (nbins, a multiple of 128 up to 2^16). cluster is a
// power of two up to 16 (so it divides nbins); nbins / cluster int32 must fit
// one block's shared memory. copies clusters each sum a share of the rows;
// with more than one copy, scratch holds copies * nbins int32.
extern "C" int dbt_weighted_histogram(const int32_t* keys, const int32_t* vals,
                                      int64_t n, int32_t* out, int32_t nbins,
                                      int32_t cluster, int32_t copies,
                                      int32_t* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t per_block = static_cast<uint32_t>(nbins / cluster);
  const int smem = static_cast<int>(per_block * sizeof(uint32_t));
  uint32_t* dst = reinterpret_cast<uint32_t*>(copies == 1 ? out : scratch);
  const bool vec = ((reinterpret_cast<uintptr_t>(keys) |
                     reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
  cudaError_t err;
  if (cluster == 1) {
    err = dbt::configure(weighted_histogram_kernel<false>, false,
                         weighted_ready);
    if (err != cudaSuccess) return static_cast<int>(err);
    weighted_histogram_kernel<false><<<copies, kWeightedThreads, smem, s>>>(
        keys, vals, n, static_cast<uint32_t>(nbins), per_block, dst, vec);
  } else {
    err = dbt::configure(weighted_histogram_kernel<true>, true,
                    weighted_cluster_ready);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(copies * cluster, cluster, smem, s, &attr);
    err = cudaLaunchKernelEx(&cfg, weighted_histogram_kernel<true>, keys, vals,
                             n, static_cast<uint32_t>(nbins), per_block, dst,
                             vec);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (copies > 1) {
    const int quads = nbins / 4;
    sum_copies<<<(quads + 255) / 256, 256, 0, s>>>(
        reinterpret_cast<const uint4*>(scratch), copies,
        static_cast<uint32_t>(nbins), reinterpret_cast<uint4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` blocks (2 to 16) of the weighted histogram
// at nbins bins the current device runs at once (cudaOccupancyMaxActiveClusters),
// or minus the CUDA error.
extern "C" int dbt_weighted_histogram_max_clusters(int32_t nbins,
                                                   int32_t cluster) {
  const int smem = nbins / cluster * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = dbt::configure(weighted_histogram_kernel<true>, true,
                              weighted_cluster_ready);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, smem, 0, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, weighted_histogram_kernel<true>,
                                       &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : count;
}
