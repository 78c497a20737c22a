// Histograms of int32 keys, plain and weighted.
//
// histogram replaces dwarf_bench_tpu/ops/hist_pallas.py:119
// histogram_16k_swar_pallas: (nbins,) int32 counts, nbins = hi_bins * 128, of
// int32 keys; a key whose uint32 value is >= nbins (negatives, EMPTY,
// padding) counts nowhere. The TPU kernel builds SWAR byte one-hots and
// counts them on the MXU because the TPU has no atomics. Here each block
// counts its share of the keys into a private copy of the bins in shared
// memory (64 KB at nbins = 16384, so dynamic shared memory above the 48 KB
// static limit) with shared-memory atomics, and the copies are merged with
// plain loads and stores, in one launch that writes every bin of the output
// once:
//   - keys are read 16 bytes a thread, two vectors in flight, from the first
//     16-byte boundary (scalar loads take the head before it and the ragged
//     tail, in the same launch);
//   - each block stores its copy into a (blocks, nbins) scratch, 16-bit
//     bins where every block counts fewer than 2^16 keys (the main paths),
//     and counts itself done with a release add it does not wait for;
//   - the last `mergers` blocks to start wait for every block to be done;
//     each adds one slice of the bins over the copies from the L2, eight
//     16-byte loads in flight a lane, and stores it into the output. The
//     last merger out puts the counters back to 0, so the scratch, one
//     lasting buffer a stream, needs no memset.
// A merger waits on blocks that may not have started, so with more than
// one block the grid is a cooperative launch: the CUDA driver starts it
// only if the context (an MPS client or a green context holds fewer SMs
// than the card) holds every block at once, and otherwise refuses it with
// cudaErrorCooperativeLaunchTooLarge, which the wrapper raises. So no plan
// can hang. (A merge that never waits, mergers that count no keys and wait
// only on the counting blocks, which started before them, took 0.0122 ms
// device at Radix's hi80 2^22 against 0.0093 on an H100: PERF.md.)
// Bound on the card: the key read (4 bytes a row) and the bins written. The
// plan (ops/hist_cuda.py histogram_plan) keeps blocks * nbins at or below
// max(nbins, n), so the copies, which mostly stay in the L2, never move
// more than the keys. The time is the shared atomics and the key read, then
// a chain of waits (the copies' stores, the done count, the mergers' loads)
// that no bandwidth hides. Measured on an H100 (PERF.md): 16-bit copies beat
// 32-bit ones by 9-13 %; summing a warp's keys of one bin first, with the
// weighted kernel's vote (add_row) a key or with one vote a 16-byte vector,
// slowed spread keys (by 29 % and 8 %), and only the vector vote sped up a
// one-bin input; and a cluster adding its blocks' copies in distributed
// shared memory first, to merge fewer copies, cost more than it saved.
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

constexpr int kWeightedThreads = 512;
constexpr uint32_t kDropped = 0xFFFFFFFFu;
// The count histogram's lanes a block, from the plan sweep of
// utils/kernel_times.py --sweep histogram on an H100 (PERF.md); the
// schedule's rendering (ops/hist_cuda.py HIST_THREADS) mirrors it.
constexpr int kHistThreads = 512;
constexpr int kCounterWords = 4;  // the histogram's counters, then its copies

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

// Vectors v and v + step of k4 (an out-of-range one counts nowhere).
__device__ __forceinline__ void load_keys(const int4* k4, int64_t v,
                                          int64_t step, int64_t nvec,
                                          int4 (&kk)[2]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int64_t i = v + u * step;
    kk[u] = i < nvec ? k4[i] : make_int4(-1, -1, -1, -1);
  }
}

// Counts one key.
__device__ __forceinline__ void count_key(uint32_t* bins, int32_t k,
                                          uint32_t nbins) {
  const uint32_t u = static_cast<uint32_t>(k);
  if (u < nbins) atomicAdd(bins + u, 1u);
}

template <bool kCluster>
__device__ __forceinline__ void sync_copy() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Adds a 16-byte word of a copy to sum: four 32-bit bins, or with kNarrow
// eight 16-bit ones.
template <bool kNarrow>
__device__ __forceinline__ void add_word(uint32_t (&sum)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kNarrow) {
      sum[2 * e] += w[e] & 0xFFFFu;
      sum[2 * e + 1] += w[e] >> 16;
    } else {
      sum[e] += w[e];
    }
  }
}

// keys[0, head) lie before the first 16-byte boundary, then nvec int4
// vectors, then the ragged tail up to n. out (nbins int32) gets every bin.
// With more than one block, rows holds a copy of nbins words a block (of
// 16-bit bins with kNarrow: every block counts fewer than 2^16 keys) and
// counters three words, zero, left zero: the blocks' start tickets, the
// blocks that have stored their copy, the mergers done. `mergers` is at
// most the blocks, and nbins / mergers a multiple of 8. With more than one
// block, every block of the grid must be resident at once (a cooperative
// launch).
template <int kThreads, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int32_t* __restrict__ keys, int64_t n,
                     int64_t head, int64_t nvec, uint32_t nbins,
                     uint32_t* __restrict__ out, uint32_t* rows,
                     unsigned* counters, int mergers) {
  extern __shared__ uint4 bins4[];
  uint32_t* bins = reinterpret_cast<uint32_t*>(bins4);
  __shared__ uint32_t s_start;
  const uint32_t nq = nbins / 4;
  const bool merge = gridDim.x > 1;
  // the start ticket: its value is waited for only at the merge
  unsigned start = 0;
  if (threadIdx.x == 0 && merge) start = atomicAdd(counters, 1u);
  // a lane's keys, two vectors a step: each step's loads are issued before
  // the previous step's keys are counted, the first ones before the bins
  // are zeroed
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const int4* k4 = reinterpret_cast<const int4*>(keys + head);
  int4 kk[2];
  load_keys(k4, tid, step, nvec, kk);
  for (uint32_t q = threadIdx.x; q < nq; q += kThreads) {
    bins4[q] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int64_t v = tid; v < nvec; v += 2 * step) {
    int4 next[2];
    load_keys(k4, v + 2 * step, step, nvec, next);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      count_key(bins, kk[u].x, nbins);
      count_key(bins, kk[u].y, nbins);
      count_key(bins, kk[u].z, nbins);
      count_key(bins, kk[u].w, nbins);
      kk[u] = next[u];
    }
  }
  if (tid < 8) {  // threads 0-3 the head, 4-7 the tail
    const int64_t i = tid < 4 ? tid : head + 4 * nvec + tid - 4;
    if (tid < 4 ? i < head : i < n) count_key(bins, keys[i], nbins);
  }
  __syncthreads();

  if (!merge) {  // one block: its copy is the histogram
    for (uint32_t q = threadIdx.x; q < nq; q += kThreads) {
      reinterpret_cast<uint4*>(out)[q] = bins4[q];
    }
    return;
  }
  // store the copy, then count the block done (a release add after the
  // barrier orders every lane's stores before it), without waiting
  if constexpr (kNarrow) {
    uint4* dst = reinterpret_cast<uint4*>(rows) + (int64_t)blockIdx.x * (nq / 2);
    for (uint32_t q = threadIdx.x; q < nq / 2; q += kThreads) {
      const uint4 a = bins4[2 * q];
      const uint4 b = bins4[2 * q + 1];
      dst[q] = make_uint4(a.x | a.y << 16, a.z | a.w << 16, b.x | b.y << 16,
                          b.z | b.w << 16);
    }
  } else {
    uint4* dst = reinterpret_cast<uint4*>(rows) + (int64_t)blockIdx.x * nq;
    for (uint32_t q = threadIdx.x; q < nq; q += kThreads) dst[q] = bins4[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    dbt::add_release(counters + 1, 1u);
    s_start = start;
  }
  __syncthreads();

  // The last `mergers` blocks to start wait for every block to be done (the
  // cooperative launch holds every block resident); each adds its slice of
  // the bins over the copies and stores it.
  const uint32_t first_merger = gridDim.x - mergers;
  if (s_start < first_merger) return;
  const uint32_t slice = nbins / mergers;
  const uint32_t lo = (s_start - first_merger) * slice;
  for (uint32_t b = threadIdx.x; b < slice; b += kThreads) bins[b] = 0;
  if (threadIdx.x == 0) {
    while (dbt::load_acquire(counters + 1) < gridDim.x) {
    }
  }
  __syncthreads();
  // `words` 16-byte words of the slice a pass, `groups` lanes a word, each
  // adding every groups-th copy with eight loads in flight, then one shared
  // add a bin
  constexpr uint32_t kBinsAWord = kNarrow ? 8 : 4;
  const uint32_t nw = slice / kBinsAWord;
  const int64_t row = nbins / kBinsAWord;
  const uint32_t words = nw < kThreads ? nw : kThreads;
  const uint32_t groups = kThreads / words;
  const uint32_t g = threadIdx.x / words;
  const int ncopies = gridDim.x;
  for (uint32_t w0 = 0; w0 < nw; w0 += words) {
    const uint32_t w = w0 + threadIdx.x % words;
    if (g < groups && w < nw) {
      // other SMs wrote the copies: read them from the L2
      const uint4* col =
          reinterpret_cast<const uint4*>(rows) + lo / kBinsAWord + w;
      uint32_t sum[8] = {};
      for (int c = g; c < ncopies; c += 8 * groups) {
        uint4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cj = c + j * groups;
          v[j] = cj < ncopies ? __ldcg(col + cj * row) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) add_word<kNarrow>(sum, v[j]);
      }
#pragma unroll
      for (uint32_t e = 0; e < kBinsAWord; ++e) {
        atomicAdd(bins + w * kBinsAWord + e, sum[e]);
      }
    }
  }
  __syncthreads();
  for (uint32_t q = threadIdx.x; q < slice / 4; q += kThreads) {
    reinterpret_cast<uint4*>(out + lo)[q] = bins4[q];
  }
  if (threadIdx.x == 0 && atomicAdd(counters + 2, 1u) == (unsigned)mergers - 1) {
    counters[0] = 0;  // every block has taken its ticket and is done
    counters[1] = 0;
    counters[2] = 0;
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

template <bool kNarrow>
cudaError_t launch_histogram(const int32_t* keys, int64_t n, int64_t head,
                             int64_t nvec, uint32_t nbins, uint32_t* out,
                             int32_t blocks, int32_t mergers,
                             int32_t* scratch, cudaStream_t s) {
  static std::atomic<uint64_t> ready{0};
  auto kernel = histogram_kernel<kHistThreads, kNarrow>;
  cudaError_t err = dbt::configure(kernel, false, ready);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kHistThreads);
  cfg.dynamicSmemBytes = nbins * sizeof(uint32_t);
  cfg.stream = s;
  // the mergers wait for every block: every block resident at once, or no
  // launch (one block waits on none)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, keys, n, head, nvec, nbins, out,
      reinterpret_cast<uint32_t*>(scratch + kCounterWords),
      reinterpret_cast<unsigned*>(scratch), mergers);
  return dbt::launched(err);
}

}  // namespace

// Writes every bin of out (nbins, a multiple of 128 up to 2^14: its int32
// fit one block's shared memory). `blocks` blocks each count a share of the
// keys into a copy; `mergers` blocks, at most `blocks`, with nbins a
// multiple of 8 * mergers, merge the copies. With more than one block the
// launch is cooperative, so a grid the context cannot hold at once returns
// cudaErrorCooperativeLaunchTooLarge and runs nothing; scratch holds
// dbt_histogram_scratch(nbins, blocks) int32 whose first 4 (the counters)
// are zero, and leaves them zero. keys needs only int32 alignment.
extern "C" int dbt_histogram(const int32_t* keys, int64_t n, int32_t* out,
                             int32_t nbins, int32_t blocks, int32_t mergers,
                             int32_t* scratch, void* stream) {
  if (nbins <= 0 || nbins % 128 || nbins > (1 << 14) || blocks < 1 ||
      mergers < 1 || mergers > blocks || nbins % (8 * mergers) ||
      (blocks > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t mis = (reinterpret_cast<uintptr_t>(keys) & 15) / 4;
  const int64_t head = mis == 0 ? 0 : (4 - mis < n ? 4 - mis : n);
  const int64_t nvec = (n - head) / 4;
  // the most keys a block counts: its vectors, and block 0 the head and
  // the tail; 16-bit copies hold them below 2^16
  const int64_t lanes = (int64_t)blocks * kHistThreads;
  const int64_t most = 4 * kHistThreads * ((nvec + lanes - 1) / lanes) + 8;
  const uint32_t nb = static_cast<uint32_t>(nbins);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  return static_cast<int>(
      most < (1 << 16)
          ? launch_histogram<true>(keys, n, head, nvec, nb, o, blocks,
                                   mergers, scratch, s)
          : launch_histogram<false>(keys, n, head, nvec, nb, o, blocks,
                                    mergers, scratch, s));
}

// int32 scratch words of dbt_histogram with `blocks` copies of nbins bins:
// the counters, then the copies.
extern "C" int64_t dbt_histogram_scratch(int32_t nbins, int32_t blocks) {
  return kCounterWords + (int64_t)nbins * blocks;
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
    err = dbt::launched(cudaLaunchKernelEx(
        &cfg, weighted_histogram_kernel<true>, keys, vals, n,
        static_cast<uint32_t>(nbins), per_block, dst, vec));
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
