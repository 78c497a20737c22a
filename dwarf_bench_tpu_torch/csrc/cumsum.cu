// Inclusive int32 prefix sum plus a carry.
//
// Replaces dwarf_bench_tpu/ops/cumsum_pallas.py:35 cumsum_pallas:
// out[i] = carry_init + x[0] + ... + x[i], wrapping mod 2^32. The TPU kernel
// runs the scan as f32 matmuls against triangular ones matrices on the MXU and
// carries a scalar through its sequential grid; that is where its
// preconditions (|x| < 2^15, block sums < 2^24) come from. This scan adds in
// uint32_t throughout, so it is exact for every input and wraps as the
// contract asks (signed overflow would be undefined in C++).
//
// Bound on the card: device-memory bandwidth, 8 bytes a row (x read once, out
// written once). Blocks run in no order, so nothing carries between them the
// way the TPU's grid carries its scalar; this is Merrill & Garland's
// single-pass scan with decoupled look-back, in one launch:
//   - a block takes the next tile from an atomic counter, so every tile
//     before it has started and the look-back cannot wait on a tile that
//     never runs;
//   - it loads its kTile values (16-byte loads, each warp a contiguous
//     stretch), scans them in registers and shared memory, and publishes its
//     aggregate in a 64-bit status word (flag in the high half, value in the
//     low half, so one store makes both visible together);
//   - warp 0 then walks back over its predecessors' status words, 32 at a
//     time, adding aggregates until it meets an inclusive prefix, publishes
//     its own inclusive prefix, and the block writes its tile.
// Tile 0 publishes carry + aggregate at once. The carry is read on the device
// from carry_ptr when it is not null (a carry computed by an earlier kernel,
// the counting sort's min - 1, needs no trip to the host), else taken by
// value from carry_val. The tile counter and the status words start at zero
// and the kernel leaves them so: the last block to finish its look-back
// (a second counter says which) zeroes them, so the wrapper keeps one scratch
// buffer for each stream and no call needs a memset.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                    // int4 loads a thread
constexpr int kWarpItems = 32 * 4 * kVecs;  // 512 values a warp
constexpr int kTile = kWarps * kWarpItems;  // 8192 values a block

// status word: flag << 32 | value; 0 means "not published yet"
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// The exclusive prefix of tile `tile` (> 0), read by warp 0 from its
// predecessors' status words: lane l looks at tile last - l, and the window
// moves back 32 tiles while no lane sees an inclusive prefix.
__device__ uint32_t look_back(const volatile unsigned long long* status,
                              uint32_t tile, int lane) {
  uint32_t before = 0;
  int64_t last = (int64_t)tile - 1;
  while (true) {
    const int64_t idx = last - lane;
    unsigned long long s;
    do {
      s = idx >= 0 ? status[idx] : kPrefix;
    } while (__any_sync(0xffffffffu, (s >> 32) == 0));
    const unsigned prefixes = __ballot_sync(0xffffffffu, (s >> 32) == 2);
    // lanes up to the nearest inclusive prefix contribute
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    before += __reduce_add_sync(0xffffffffu,
                                lane <= stop ? static_cast<uint32_t>(s) : 0u);
    if (prefixes) return before;
    last -= 32;
  }
}

__global__ void __launch_bounds__(kThreads)
    scan_lookback(const int32_t* __restrict__ x, int64_t n,
                  const int32_t* __restrict__ carry_ptr, uint32_t carry_val,
                  int32_t* __restrict__ out, unsigned* __restrict__ counters,
                  unsigned long long* status, bool vec) {
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_before;
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counters, 1u);
  __syncthreads();
  const uint32_t tile = s_tile;
  // lane l's vector j holds values wbase + 4 * (32 * j + l) + [0, 4)
  const int64_t wbase = (int64_t)tile * kTile + (int64_t)warp * kWarpItems;
  const bool full = vec && wbase + kWarpItems <= n;

  uint32_t v[kVecs][4];
  if (full) {
    const int4* src = reinterpret_cast<const int4*>(x + wbase);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int4 q = src[32 * j + lane];
      v[j][0] = q.x;
      v[j][1] = q.y;
      v[j][2] = q.z;
      v[j][3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t i = wbase + 4 * (32 * j + lane) + c;
        v[j][c] = i < n ? static_cast<uint32_t>(x[i]) : 0u;
      }
    }
  }

  // each vector scanned in the thread, then across the warp's lanes; the
  // vectors chain one after the other
  uint32_t run = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    v[j][1] += v[j][0];
    v[j][2] += v[j][1];
    v[j][3] += v[j][2];
    const uint32_t inc = dbt::warp_inclusive_scan(v[j][3]);
    const uint32_t excl = run + inc - v[j][3];
    run += __shfl_sync(0xffffffffu, inc, 31);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[j][c] += excl;
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  if (warp == 0) {
    const uint32_t w = lane < kWarps ? s_warp[lane] : 0u;
    const uint32_t winc = dbt::warp_inclusive_scan(w);
    if (lane < kWarps) s_warp[lane] = winc - w;
    const uint32_t aggregate = __shfl_sync(0xffffffffu, winc, 31);
    volatile unsigned long long* st = status;
    uint32_t before;
    if (tile == 0) {
      before = carry_ptr ? static_cast<uint32_t>(*carry_ptr) : carry_val;
    } else {
      if (lane == 0) st[tile] = kAggregate | aggregate;
      before = look_back(st, tile, lane);
    }
    if (lane == 0) {
      st[tile] = kPrefix | static_cast<uint32_t>(before + aggregate);
      s_before = before;
      // every status read of this block is done: count it finished
      __threadfence();
      s_last = atomicAdd(counters + 1, 1u) == gridDim.x - 1;
      __threadfence();
    }
  }
  __syncthreads();
  if (s_last) {  // no block reads a status word any more: leave them zero
    for (uint32_t t = threadIdx.x; t < gridDim.x; t += kThreads) status[t] = 0;
    if (threadIdx.x == 0) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }

  const uint32_t off = s_before + s_warp[warp];
  if (full) {
    int4* dst = reinterpret_cast<int4*>(out + wbase);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      dst[32 * j + lane] = make_int4(
          static_cast<int32_t>(v[j][0] + off), static_cast<int32_t>(v[j][1] + off),
          static_cast<int32_t>(v[j][2] + off), static_cast<int32_t>(v[j][3] + off));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t i = wbase + 4 * (32 * j + lane) + c;
        if (i < n) out[i] = static_cast<int32_t>(v[j][c] + off);
      }
    }
  }
}

}  // namespace

// Number of int32 scratch words dbt_cumsum needs for n values: the tile
// counter and the finished-block counter, then one 64-bit status word a tile.
extern "C" int64_t dbt_cumsum_scratch(int64_t n) {
  return 2 * (1 + (n + kTile - 1) / kTile);
}

// The carry is *carry_ptr (one int32 on the device) when carry_ptr is not
// null, else carry_val. scratch holds at least dbt_cumsum_scratch(n) int32
// words, 8-byte aligned and zero; the kernel leaves them zero. Work on one
// stream runs in order, so one scratch buffer serves every call on a stream.
extern "C" int dbt_cumsum(const int32_t* x, int64_t n, const int32_t* carry_ptr,
                          int32_t carry_val, int32_t* out, int32_t* scratch,
                          void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t ntiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  scan_lookback<<<(unsigned)ntiles, kThreads, 0, s>>>(
      x, n, carry_ptr, static_cast<uint32_t>(carry_val), out,
      reinterpret_cast<unsigned*>(scratch),
      reinterpret_cast<unsigned long long*>(scratch + 2), vec);
  return static_cast<int>(cudaGetLastError());
}
