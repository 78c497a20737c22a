// Histograms of int32 keys, plain and weighted.
//
// histogram replaces dwarf_bench_tpu/ops/hist_pallas.py:119
// histogram_16k_swar_pallas: (nbins,) int32 counts, nbins = hi_bins * 128, of
// int32 keys; a key whose uint32 value is >= nbins (negatives, EMPTY,
// padding) counts nowhere. With a shift s (one int32, read on the device:
// the counting sort's min) a key counts as uint32(k - s), subtracted as each
// key is loaded, so the sort never writes the shifted copy of its column
// that dwarf_bench_tpu/ops/sort.py:148 makes. The TPU kernel builds SWAR
// byte one-hots and counts them on the MXU because the TPU has no atomics.
// Here each block counts its share of the keys into a private copy of the
// bins in shared memory (64 KB at nbins = 16384, so dynamic shared memory
// above the 48 KB static limit) with shared-memory atomics, and the copies
// are merged with plain loads and stores, in one launch that writes every
// bin of the output once:
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
// Up to 2^15 bins (128 KB) one block holds a copy of the bins in its shared
// memory (weighted_histogram_kernel<false>). Each of `copies` blocks streams
// its share of the rows (16-byte loads where aligned, two vectors of keys and
// two of values in flight a thread) and adds each value into its copy with
// an atomic. A warp whose 32 rows all fall in one bin (a hot key) sums them
// first (__reduce_add_sync) and adds once, so a hot key costs one atomic a
// warp, not 32 on one word. (Grouping equal keys with __match_any_sync and
// summing each group under its own mask cost 3.5x the time on uniform keys
// at the main-path shape on an H100.) Each block then writes its copy with
// plain stores, into the output when there is one copy, else into a
// (copies, nbins) scratch that sum_copies adds up column by column. Every
// bin is written, so the output needs no memset.
//
// 2^16 int32 bins are 256 KB, more than one block's 227 KB of shared memory.
// Below 2^20 rows (ops/hist_cuda.py weighted_plan) the same kernel runs in
// clusters of 16 blocks (weighted_histogram_kernel<true>): a cluster holds
// one copy in its distributed shared memory, block r owning bins
// [r * per_block, (r + 1) * per_block), and every row's add goes to the
// owner's shared memory (map_shared_rank), 15 adds of 16 to another block.
// Those adds run at one total rate, about 54 G adds a second past a few
// hundred thousand rows, whatever the cluster size and count (2.474 ms at
// 2^27 rows on an H100, PERF.md); staging each block's rows by owner for the
// owners to pull gained under a fifth.
//
// From 2^20 rows on weighted_multicast_kernel takes the rows to the owners
// instead of the adds. Clusters of C blocks (2, or 4 in the plan sweep) each
// own nbins / C bins a block in its own shared memory, and each of the K
// clusters takes every K-th tile of rows. A tile is read from HBM once: each
// block's producer warp copies its piece of it (ranks below C / 2 the keys,
// the others the values, in 16-byte words) with a bulk copy to
// .multicast::cluster, which writes the piece into the same stage of every
// block of the cluster and counts its bytes on each block's full barrier.
// Every block's adding warps scan the whole staged tile and add the rows
// whose key the block owns with a local shared atomic (add_owned4, with
// add_row's one-bin warp vote), then each warp arrives on the stage's empty
// barrier in every block of the cluster, and a producer reuses a stage only
// once all of them have. No add crosses the cluster. Rows before the first
// 16-byte boundary and the last (n - head) % 4 take scalar loads in cluster
// 0; keys and values that lie differently mod 16 bytes take the same split
// with each block loading its cluster's rows itself, the second read served
// by the L2 (tested, not fast). After the last tile each block adds its
// slice into the output, zeroed by a memset in the same call, with one bulk
// reduction (cp.reduce.async.bulk .add.u32): no scratch, and K <= n / nbins
// slices of nbins bins, so the flush never adds more than the rows do.
//
// What bounds it on the card: the HBM read, 8 bytes a row, once the adding
// warps keep up. Taking the rows to the owners costs shared memory traffic,
// C x 8 bytes a row into the SMs and read back: 16 MB an SM at C = 2 and
// 2^27 rows, about 0.13 ms at 128 bytes a clock, under the 0.32 ms of the
// read; at C = 4 twice that, and the 4-block clusters the card holds cover
// 120 SMs, which is why the cluster stays at 2. Each block scans every row
// of its cluster, so the adding warps' votes and atomics, not the adds'
// owners, set the rate: 3968-row tiles (one 16-byte word a lane of 31
// warps) in 3 stages beside the 128 KB of bins run 2^27 rows in 0.374 ms on
// an H100, 86 % of the read's bound, against 0.41-0.60 ms for 2048- to
// 4096-row tiles of 16 warps (PERF.md). Each tile's stage and phase are
// counted along: a 64-bit division a tile cost about 0.1 ms at 2^27 rows.
// The flush bound leaves one cluster (2 SMs) a 2^16 rows, so below 2^20
// rows the remote adds, spread over more SMs, are faster.
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

// add_row for a block that owns the bins [lo, lo + owned): a row whose key
// lies elsewhere (kDropped included) is another block's or nobody's.
__device__ __forceinline__ void add_owned(uint32_t* bins, uint32_t key,
                                          uint32_t v, uint32_t lo,
                                          uint32_t owned, int lane) {
  uint32_t sum = v;
  const uint32_t key0 = __shfl_sync(0xffffffffu, key, 0);
  if (__all_sync(0xffffffffu, key == key0)) {  // one bin for the whole warp
    sum = __reduce_add_sync(0xffffffffu, v);
    if (lane != 0) return;
  }
  const uint32_t b = key - lo;  // wraps past `owned` for keys below lo
  if (b < owned) atomicAdd(bins + b, sum);
}

__device__ __forceinline__ uint32_t key_of(int32_t k, uint32_t nbins) {
  const uint32_t u = static_cast<uint32_t>(k);
  return u < nbins ? u : kDropped;
}

// add_owned for the four rows of a lane's 16-byte words of keys and values,
// the four votes taken together: where no row has one bin for the whole
// warp (the common case) the owned rows are added straight away.
__device__ __forceinline__ void add_owned4(uint32_t* bins, int4 kk, int4 vv,
                                           uint32_t nbins, uint32_t lo,
                                           uint32_t owned, int lane) {
  const uint32_t key[4] = {key_of(kk.x, nbins), key_of(kk.y, nbins),
                           key_of(kk.z, nbins), key_of(kk.w, nbins)};
  const uint32_t v[4] = {static_cast<uint32_t>(vv.x),
                         static_cast<uint32_t>(vv.y),
                         static_cast<uint32_t>(vv.z),
                         static_cast<uint32_t>(vv.w)};
  bool one = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    one |= __all_sync(0xffffffffu,
                      key[j] == __shfl_sync(0xffffffffu, key[j], 0));
  }
  if (one) {
#pragma unroll
    for (int j = 0; j < 4; ++j) add_owned(bins, key[j], v[j], lo, owned, lane);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = key[j] - lo;
    if (b < owned) atomicAdd(bins + b, v[j]);
  }
}

// Vectors v and v + step of k4; one past nvec is four keys `pad`, which
// count nowhere.
__device__ __forceinline__ void load_keys(const int4* k4, int64_t v,
                                          int64_t step, int64_t nvec,
                                          int32_t pad, int4 (&kk)[2]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int64_t i = v + u * step;
    kk[u] = i < nvec ? k4[i] : make_int4(pad, pad, pad, pad);
  }
}

// Counts one key, in bin uint32(k) - shift.
__device__ __forceinline__ void count_key(uint32_t* bins, int32_t k,
                                          uint32_t nbins, uint32_t shift) {
  const uint32_t u = static_cast<uint32_t>(k) - shift;
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
// With kShift a key k counts in bin uint32(k) - shift, the shift read once a
// lane from *shift_ptr when it is not null, else shift_val; without it the
// kernel reads no shift and subtracts nothing.
// With more than one block, rows holds a copy of nbins words a block (of
// 16-bit bins with kNarrow: every block counts fewer than 2^16 keys) and
// counters three words, zero, left zero: the blocks' start tickets, the
// blocks that have stored their copy, the mergers done. `mergers` is at
// most the blocks, and nbins / mergers a multiple of 8. With more than one
// block, every block of the grid must be resident at once (a cooperative
// launch).
template <int kThreads, bool kNarrow, bool kShift>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int32_t* __restrict__ keys, int64_t n,
                     int64_t head, int64_t nvec, uint32_t nbins,
                     const int32_t* __restrict__ shift_ptr,
                     uint32_t shift_val, uint32_t* __restrict__ out,
                     uint32_t* rows, unsigned* counters, int mergers) {
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
  uint32_t shift = 0;
  if constexpr (kShift) {
    shift = shift_ptr ? static_cast<uint32_t>(__ldg(shift_ptr)) : shift_val;
  }
  // the padding past the keys: bin 0xFFFFFFFF once shifted (-1 unshifted)
  const int32_t pad = static_cast<int32_t>(shift - 1u);
  int4 kk[2];
  load_keys(k4, tid, step, nvec, pad, kk);
  for (uint32_t q = threadIdx.x; q < nq; q += kThreads) {
    bins4[q] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int64_t v = tid; v < nvec; v += 2 * step) {
    int4 next[2];
    load_keys(k4, v + 2 * step, step, nvec, pad, next);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      count_key(bins, kk[u].x, nbins, shift);
      count_key(bins, kk[u].y, nbins, shift);
      count_key(bins, kk[u].z, nbins, shift);
      count_key(bins, kk[u].w, nbins, shift);
      kk[u] = next[u];
    }
  }
  if (tid < 8) {  // threads 0-3 the head, 4-7 the tail
    const int64_t i = tid < 4 ? tid : head + 4 * nvec + tid - 4;
    if (tid < 4 ? i < head : i < n) count_key(bins, keys[i], nbins, shift);
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

// -- the multicast kernel's PTX: mbarriers, bulk copies, bulk reductions ----

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :
               : "r"(smem_address(bar)), "r"(count)
               : "memory");
}

// One arrival on the block's own `bar` that also expects `bytes` of copies.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :
               : "r"(smem_address(bar)), "r"(bytes)
               : "memory");
}

// Waits until the phase of the block's own `bar` whose parity is `parity`
// has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_address(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One arrival on the barrier at `bar`'s offset in block `rank` of the
// cluster (this block's own included); its release orders the arriving
// warp's reads of a stage before the stage's next copy.
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 r;\n"
      " mapa.shared::cluster.u32 r, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [r];\n}"
      :
      : "r"(smem_address(bar)), "r"(rank)
      : "memory");
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global `src` to `dst`'s offset in every block of `mask`, and counts them
// on the barrier at `bar`'s offset in each.
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :
      : "r"(smem_address(dst)), "l"(src), "r"(bytes), "r"(smem_address(bar)),
        "h"(mask)
      : "memory");
}

// dst[i] += src[i] in global memory, atomically a word, for `bytes` of the
// block's shared memory at src, and waits until the copy has been done.
__device__ __forceinline__ void bulk_reduce_add(uint32_t* dst,
                                                const uint32_t* src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 "
      "[%0], [%1], %2;"
      :
      : "l"(dst), "r"(smem_address(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

constexpr int kMaxStages = 8;

// Rows [lo, hi) of a block's cluster, read from global memory with scalar
// loads by the consumer warps; each adds the rows its block owns.
__device__ __forceinline__ void add_rows_direct(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
    int64_t lo, int64_t hi, uint32_t nbins, uint32_t* bins, uint32_t first,
    uint32_t owned, int warp, int warps, int lane) {
  for (int64_t base = lo + warp * 32; base < hi; base += warps * 32) {
    const int64_t i = base + lane;
    add_owned(bins, i < hi ? key_of(keys[i], nbins) : kDropped,
              i < hi ? static_cast<uint32_t>(vals[i]) : 0u, first, owned,
              lane);
  }
}

// Rows [p0, p1) of a tile of `rows` rows that rank `piece` of the `pieces`
// ranks copying one column (keys or values) issues: equal shares of whole
// 16-byte words (rows is a multiple of 4), some empty in a short tile.
// ops/hist_cuda.py _multicast_pieces mirrors it.
__device__ __forceinline__ void piece_rows(uint32_t rows, uint32_t piece,
                                           uint32_t pieces, uint32_t* p0,
                                           uint32_t* p1) {
  const uint32_t per = ((rows + pieces - 1) / pieces + 3) & ~3u;
  *p0 = min(piece * per, rows);
  *p1 = min(*p0 + per, rows);
}

// The 2^16-bin weighted histogram: clusters of `cluster` blocks (2 or 4),
// block r of each owning bins [r * owned, (r + 1) * owned) in shared memory,
// cluster c of K taking tiles c, c + K, ... of tile_rows rows. With `bulk`
// the tiles cover rows [head, head + nbulk) (keys and values 16-byte aligned
// there, nbulk a multiple of 4), copied by the producer warps into `stages`
// stages of shared memory (keys then values, tile_rows int32 each), and the
// rows before head and from head + nbulk on take scalar loads in cluster 0;
// without, the tiles cover [0, n) and every block loads them itself. out
// (nbins int32) must be zero; each block adds its slice into it.
__global__ void __launch_bounds__(1024, 1)
    weighted_multicast_kernel(const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ vals, int64_t n,
                              int64_t head, int64_t nbulk, bool bulk,
                              uint32_t nbins, uint32_t owned,
                              uint32_t tile_rows, uint32_t stages,
                              uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  __shared__ uint64_t full[kMaxStages];   // a stage's bytes have landed
  __shared__ uint64_t empty[kMaxStages];  // every block has read a stage
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t csize = cluster.num_blocks();
  const uint32_t rank = cluster.block_rank();
  const uint32_t c = blockIdx.x / csize;  // clusters are runs along x
  const uint32_t nclusters = gridDim.x / csize;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32 - 1;  // the consumers; the last warp copies
  uint32_t* bins = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* ring = bins + owned;  // stage s: keys, then values
  const uint32_t first = rank * owned;

  for (uint32_t q = threadIdx.x; q < owned / 4; q += blockDim.x) {
    smem4[q] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (uint32_t s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);  // the block's own producer, and the bytes
      mbar_init(&empty[s], csize * warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // no copy or arrival reaches a block before its barriers and bins are set
  cluster.sync();

  const int64_t rows_all = bulk ? nbulk : n;
  const int64_t r0 = bulk ? head : 0;
  const int64_t ntiles = (rows_all + tile_rows - 1) / tile_rows;
  const int64_t mine = c < ntiles ? (ntiles - 1 - c) / nclusters + 1 : 0;
  const int64_t step = nclusters * (int64_t)tile_rows;  // between its tiles
  if (warp == warps) {  // the producer
    if (bulk && lane == 0) {
      const uint32_t pieces = csize / 2;
      const bool values = rank >= pieces;
      const int32_t* src = (values ? vals : keys) + r0;
      const uint16_t mask = static_cast<uint16_t>((1u << csize) - 1);
      uint32_t s = 0, phase = 0;  // the stage of tile i, its round's parity
      int64_t row0 = c * (int64_t)tile_rows;
      for (int64_t i = 0; i < mine; ++i) {
        // every block has read the stage's tile of the round before
        if (i >= stages) mbar_wait(&empty[s], phase ^ 1);
        const uint32_t rows =
            static_cast<uint32_t>(rows_all - row0 < tile_rows ? rows_all - row0
                                                              : tile_rows);
        mbar_expect_bytes(&full[s], rows * 8);
        uint32_t p0, p1;
        piece_rows(rows, rank % pieces, pieces, &p0, &p1);
        if (p1 > p0) {
          uint32_t* dst = ring + (2 * s + (values ? 1 : 0)) * tile_rows + p0;
          bulk_multicast(dst, src + row0 + p0, (p1 - p0) * 4, &full[s], mask);
        }
        row0 += step;
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else if (bulk) {
    uint32_t s = 0, phase = 0;
    int64_t row0 = c * (int64_t)tile_rows;
    for (int64_t i = 0; i < mine; ++i) {
      mbar_wait(&full[s], phase);
      const uint32_t nq = static_cast<uint32_t>(
          (rows_all - row0 < tile_rows ? rows_all - row0 : tile_rows) / 4);
      const int4* k4 = reinterpret_cast<const int4*>(ring + 2 * s * tile_rows);
      const int4* v4 =
          reinterpret_cast<const int4*>(ring + (2 * s + 1) * tile_rows);
      for (uint32_t q0 = warp * 32; q0 < nq; q0 += warps * 32) {
        const uint32_t q = q0 + lane;
        int4 kk = make_int4(-1, -1, -1, -1);
        int4 vv = make_int4(0, 0, 0, 0);
        if (q < nq) {
          kk = k4[q];
          vv = v4[q];
        }
        add_owned4(bins, kk, vv, nbins, first, owned, lane);
      }
      // the warp has read the stage: an arrival on its empty barrier in
      // each block of the cluster
      __syncwarp();
      if (lane < csize) mbar_arrive_at(&empty[s], lane);
      row0 += step;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    if (c == 0) {  // the rows before the first 16-byte boundary, the tail
      add_rows_direct(keys, vals, 0, head, nbins, bins, first, owned, warp,
                      warps, lane);
      add_rows_direct(keys, vals, head + nbulk, n, nbins, bins, first, owned,
                      warp, warps, lane);
    }
  } else {
    for (int64_t row0 = c * (int64_t)tile_rows; row0 < n; row0 += step) {
      const int64_t end = row0 + tile_rows < n ? row0 + tile_rows : n;
      add_rows_direct(keys, vals, row0, end, nbins, bins, first, owned, warp,
                      warps, lane);
    }
  }
  // every add has landed; the bulk reduction reads the bins through the
  // async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0 && (mine > 0 || c == 0)) {
    bulk_reduce_add(out + first, bins, owned * 4);
  }
  // no block leaves while another's arrivals may still reach its barriers
  cluster.sync();
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
std::atomic<uint64_t> multicast_ready{0};

// The multicast kernel's dynamic shared memory: its slice of the bins, then
// the stages of keys and values.
size_t multicast_smem(int32_t nbins, int32_t cluster, int32_t stages,
                      int32_t tile_rows) {
  return (static_cast<size_t>(nbins / cluster) +
          2 * static_cast<size_t>(stages) * tile_rows) * sizeof(uint32_t);
}

// A tile is 128 rows an adding warp, one 16-byte word a lane; with the
// producer warp a block holds 32 warps at most.
bool multicast_plan_ok(int32_t nbins, int32_t cluster, int32_t clusters,
                       int32_t stages, int32_t tile_rows) {
  return nbins > 0 && nbins % 128 == 0 && nbins <= (1 << 16) &&
         (cluster == 2 || cluster == 4) && clusters >= 1 && stages >= 1 &&
         stages <= kMaxStages && tile_rows >= 128 && tile_rows % 128 == 0 &&
         tile_rows <= 31 * 128;
}

cudaLaunchConfig_t cluster_config(int blocks, int cluster, int threads,
                                  size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
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

template <bool kNarrow, bool kShift>
cudaError_t launch_histogram(const int32_t* keys, int64_t n, int64_t head,
                             int64_t nvec, uint32_t nbins,
                             const int32_t* shift_ptr, uint32_t shift_val,
                             uint32_t* out, int32_t blocks, int32_t mergers,
                             int32_t* scratch, cudaStream_t s) {
  static std::atomic<uint64_t> ready{0};
  auto kernel = histogram_kernel<kHistThreads, kNarrow, kShift>;
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
      &cfg, kernel, keys, n, head, nvec, nbins, shift_ptr, shift_val, out,
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
// are zero, and leaves them zero. keys needs only int32 alignment. A key k
// counts in bin uint32(k - shift), the shift *shift_ptr (one int32 on the
// device) when shift_ptr is not null, else shift_val; with neither (null and
// 0) the kernel built without a shift runs.
extern "C" int dbt_histogram(const int32_t* keys, int64_t n, int32_t* out,
                             int32_t nbins, int32_t blocks, int32_t mergers,
                             int32_t* scratch, const int32_t* shift_ptr,
                             int32_t shift_val, void* stream) {
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
  const bool narrow = most < (1 << 16);
  const bool shifted = shift_ptr != nullptr || shift_val != 0;
  const auto launch =
      narrow ? (shifted ? launch_histogram<true, true>
                        : launch_histogram<true, false>)
             : (shifted ? launch_histogram<false, true>
                        : launch_histogram<false, false>);
  return static_cast<int>(launch(keys, n, head, nvec, nb, shift_ptr,
                                 static_cast<uint32_t>(shift_val), o, blocks,
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
        cluster_config(copies * cluster, cluster, kWeightedThreads, smem, s,
                       &attr);
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

// Writes every bin of out (nbins, a multiple of 128 up to 2^16; out 16-byte
// aligned): a memset zeroes it, then `clusters` clusters of `cluster` blocks
// (2 or 4) each add their slices into it. A stage holds tile_rows (a
// multiple of 128 up to 3968) keys and as many values, `stages` of them (1
// to 8) beside nbins / cluster bins in a block's shared memory; a block has
// an adding warp for each 128 rows of a tile, and one more that copies. No
// scratch.
extern "C" int dbt_weighted_multicast(const int32_t* keys, const int32_t* vals,
                                      int64_t n, int32_t* out, int32_t nbins,
                                      int32_t cluster, int32_t clusters,
                                      int32_t stages, int32_t tile_rows,
                                      void* stream) {
  if (!multicast_plan_ok(nbins, cluster, clusters, stages, tile_rows) ||
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // keys and values that lie alike mod 16 bytes go through the bulk copies
  // from the first boundary on
  const int64_t mis_k = (reinterpret_cast<uintptr_t>(keys) & 15) / 4;
  const int64_t mis_v = (reinterpret_cast<uintptr_t>(vals) & 15) / 4;
  const bool bulk = mis_k == mis_v;
  const int64_t head = !bulk || mis_k == 0 ? 0 : (4 - mis_k < n ? 4 - mis_k : n);
  const int64_t nbulk = bulk ? (n - head) / 4 * 4 : 0;
  cudaError_t err = dbt::configure(weighted_multicast_kernel, true,
                                   multicast_ready);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(out, 0, nbins * sizeof(int32_t), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      clusters * cluster, cluster, 32 * (tile_rows / 128 + 1),
      multicast_smem(nbins, cluster, stages, tile_rows), s, &attr);
  return static_cast<int>(dbt::launched(cudaLaunchKernelEx(
      &cfg, weighted_multicast_kernel, keys, vals, n, head, nbulk, bulk,
      static_cast<uint32_t>(nbins), static_cast<uint32_t>(nbins / cluster),
      static_cast<uint32_t>(tile_rows), static_cast<uint32_t>(stages),
      reinterpret_cast<uint32_t*>(out))));
}

// How many clusters of the multicast kernel under this plan the current
// device runs at once (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error.
extern "C" int dbt_weighted_multicast_max_clusters(int32_t nbins,
                                                   int32_t cluster,
                                                   int32_t stages,
                                                   int32_t tile_rows) {
  if (!multicast_plan_ok(nbins, cluster, 1, stages, tile_rows)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = dbt::configure(weighted_multicast_kernel, true,
                                   multicast_ready);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      cluster, cluster, 32 * (tile_rows / 128 + 1),
      multicast_smem(nbins, cluster, stages, tile_rows), 0, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, weighted_multicast_kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : count;
}
