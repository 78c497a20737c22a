// Phase-A chunk statistics of the sparse filter.
//
// Replaces dwarf_bench_tpu/ops/chunk_stats_pallas.py:268 chunk_stats_pallas
// and serves the same contract for :54 chunk_stats_roll_pallas and :138
// chunk_stats_fused (ops/chunk_stats.py states it): over x viewed as
// (nch, 128) int32 rows, per chunk
//   cnt  = matches x < t,
//   vsum = sum of clip(t - max(x, t - 512), 0, 256), clamped to 511,
//   stat = cnt * 512 + vsum.
// The TPU kernels reduce the 128-lane chunks with segment matmuls on the MXU
// (bf16 planes, exact because every partial stays below 2^24) or with lane
// rolls. Here one warp owns one chunk: each lane loads 4 rows, packs
// p = (x < t ? 65536 : 0) + clip(...) and the warp adds the 32 partials with
// one __reduce_add_sync. A chunk's sum is at most 128 * 65792 < 2^24, so the
// count sits in the bits above 16 and the window sum below, both exact.
// t - 512 and t - max(x, t - 512) wrap mod 2^32 as the plain version's int32
// arithmetic does: they are computed in uint32_t (signed overflow is
// undefined in C++), so a threshold near INT32_MIN gives the same garbage
// bit for bit.
//
// The kernel also writes the counts one slot late, cnt[0] = 0 and
// cnt[c + 1] = cnt of chunk c, so that the cumsum kernel (csrc/cumsum.cu)
// over cnt[0:nch] gives base, the exclusive cumsum, in one more launch, as
// chunk_stats_roll_pallas takes it from cumsum_pallas.
//
// It reads 4 bytes a row once and writes 8 bytes a chunk, so it is bound by
// device-memory bandwidth: 64 MiB + 1 MiB at 2^24 rows, about 20 us at the
// 3.35 TB/s peak. Where x is 16-byte aligned each lane reads its 4 rows as
// one int4 (a warp reads its chunk's 512 bytes in one coalesced request);
// a misaligned view takes 4 scalar loads a lane, still coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunksPerBlock = kThreads / 32;

__device__ __forceinline__ uint32_t packed_term(int32_t x, int32_t t,
                                                int32_t lo) {
  const int32_t m = x > lo ? x : lo;
  const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(t) -
                                         static_cast<uint32_t>(m));
  const uint32_t clip = d < 0 ? 0u : (d > 256 ? 256u : static_cast<uint32_t>(d));
  return (x < t ? 65536u : 0u) + clip;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    chunk_stats_kernel(const int32_t* __restrict__ x, int64_t nch, int32_t t,
                       int32_t* __restrict__ stat, int32_t* __restrict__ cnt) {
  const int64_t chunk =
      (int64_t)blockIdx.x * kChunksPerBlock + (threadIdx.x >> 5);
  if (chunk >= nch) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int32_t lo =
      static_cast<int32_t>(static_cast<uint32_t>(t) - 512u);
  const int32_t* row = x + chunk * 128;
  uint32_t p;
  if (kVec) {
    const int4 v = reinterpret_cast<const int4*>(row)[lane];
    p = packed_term(v.x, t, lo) + packed_term(v.y, t, lo) +
        packed_term(v.z, t, lo) + packed_term(v.w, t, lo);
  } else {
    p = packed_term(row[lane], t, lo) + packed_term(row[lane + 32], t, lo) +
        packed_term(row[lane + 64], t, lo) + packed_term(row[lane + 96], t, lo);
  }
  p = __reduce_add_sync(0xffffffffu, p);
  if (lane == 0) {
    const uint32_t c = p >> 16;
    const uint32_t vs = p & 65535u;
    stat[chunk] = static_cast<int32_t>(c * 512u + (vs < 511u ? vs : 511u));
    cnt[chunk + 1] = static_cast<int32_t>(c);
    if (chunk == 0) cnt[0] = 0;
  }
}

}  // namespace

// x holds nch * 128 int32 rows; stat nch int32, cnt nch + 1.
extern "C" int dbt_chunk_stats(const int32_t* x, int64_t nch, int32_t t,
                               int32_t* stat, int32_t* cnt, void* stream) {
  if (nch <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t grid = (nch + kChunksPerBlock - 1) / kChunksPerBlock;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    chunk_stats_kernel<true><<<(unsigned)grid, kThreads, 0, s>>>(x, nch, t,
                                                                 stat, cnt);
  } else {
    chunk_stats_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(x, nch, t,
                                                                  stat, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
