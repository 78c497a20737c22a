// Fused fill pass of the bitonic merge probe.
//
// Replaces dwarf_bench_tpu/ops/merge_fill_pallas.py:52 merge_fill_pallas. Over
// the merged order of (sk, sa[, dv]) it computes, per row i:
//   carry(i) = unsigned max of key+1 over source rows <= i (a source row has
//              bit 31 of sa clear; EMPTY + 1 wraps to 0, which means "none");
//   fill(i)  = uint32 sum of the source rows' deltas <= i: sa & 0xFFFF in
//              val16 mode, dv in 32-bit mode, nothing in membership mode;
//   found    = query row && carry == key + 1 && key != EMPTY;
//   dest     = (qidx << 1) | found for a query row whose index
//              qidx = sa & 0x7FFFFFFF is below nq, 0xFFFFFFFF elsewhere;
//   val      = found ? fill (mod 2^16 in val16 mode) : 0, and 0 in
//              membership mode.
//
// The TPU kernel carries the two running values in SMEM across its
// sequential grid. Blocks on the card run in no order, so the pass is
// Merrill & Garland's single-pass scan with decoupled look-back, in one
// launch (as csrc/cumsum.cu), over the pair (uint32 sum, unsigned max): both
// halves are associative and commutative, and (0, 0) is the identity.
//   - A block takes the next tile of kTile rows from an atomic counter, so
//     every earlier tile has started and the look-back never waits on a tile
//     that never runs.
//   - It loads each column with 16-byte streaming loads, each warp a
//     contiguous stretch; when a column is not 16-byte aligned, or the tile
//     is partial, it loads scalars. It scans the pair within each thread's
//     vector, across lanes by shuffles and across warps through shared
//     memory. The max has no inverse, so a lane's exclusive value is the
//     inclusive value of the lane below.
//   - It publishes its aggregate; warp 0 then walks back over its
//     predecessors' status, 32 tiles at a time, combining aggregates
//     (__reduce_add_sync, __reduce_max_sync) up to the nearest inclusive
//     prefix, publishes its own inclusive prefix, and the block writes dest
//     and val.
//
// Status words. A flag and the pair take 66 bits, more than one 64-bit word,
// so each tile has two: flag << 32 | sum and flag << 32 | max, each written by
// one single-copy-atomic 64-bit store. The two stores may become visible to
// another SM in either order, so a reader can see one word of a tile's
// aggregate and the other of its prefix. It takes a tile only when both words
// carry the same non-zero flag, and reads both again otherwise. An aggregate
// half cannot be mixed with a prefix half: the walk stops at a prefix and
// goes on past an aggregate, and one tile cannot do both (stopping would drop
// the earlier tiles' maxima, going on would add their sums a second time).
// The tile counter, a finished-block counter and the status words start at
// zero and the kernel leaves them so: the last block to finish its look-back
// zeroes them, so the wrapper keeps one scratch buffer a stream and no call
// needs a memset.
//
// Bound on the card: device-memory bandwidth. Each column is read once and
// dest and val are written once: 20 bytes a row in 32-bit mode, 16 in val16
// and membership mode. N is any length: the TPU kernel's multiple-of-32768
// block constraint does not carry over.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
// Two blocks an SM cap a thread at 64 registers: the 32-bit mode takes 80
// without the cap, which leaves one block of 512 threads an SM and measured
// 5-10 % slower on an H100.
constexpr int kMinBlocks = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                     // 16-byte loads a column a thread
constexpr int kWarpRows = 32 * 4 * kVecs;    // 512 rows a warp
constexpr int kTile = kWarps * kWarpRows;    // 8192 rows a block
constexpr uint32_t kTag = 0x80000000u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "one scan of warp totals");

// status word: flag << 32 | value; 0 means "not published yet"
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

enum Mode : int { kVal32 = 0, kVal16 = 1, kMembership = 2 };

struct Pair {
  uint32_t sum;
  uint32_t mx;
};

__device__ __forceinline__ Pair combine(Pair a, Pair b) {
  return {a.sum + b.sum, a.mx > b.mx ? a.mx : b.mx};
}

// A row's contribution to the pair: the identity for a query row.
template <int kMode>
__device__ __forceinline__ Pair contrib(uint32_t k, uint32_t a, uint32_t d) {
  if (a & kTag) return {0u, 0u};
  const uint32_t v = kMode == kVal32 ? d : kMode == kVal16 ? a & 0xFFFFu : 0u;
  return {v, k + 1u};
}

// Shuffles of a pair; the sum is 0 throughout in membership mode.
template <int kMode>
__device__ __forceinline__ Pair shfl_up(Pair v, int d) {
  return {kMode == kMembership ? 0u : __shfl_up_sync(kFull, v.sum, d),
          __shfl_up_sync(kFull, v.mx, d)};
}

template <int kMode>
__device__ __forceinline__ Pair shfl_from(Pair v, int lane) {
  return {kMode == kMembership ? 0u : __shfl_sync(kFull, v.sum, lane),
          __shfl_sync(kFull, v.mx, lane)};
}

template <int kMode>
__device__ __forceinline__ Pair warp_inclusive(Pair v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair t = shfl_up<kMode>(v, d);
    if (lane >= d) v = combine(t, v);
  }
  return v;
}

// The exclusive value of each lane, given its inclusive one.
template <int kMode>
__device__ __forceinline__ Pair lane_below(Pair inc, int lane) {
  const Pair below = shfl_up<kMode>(inc, 1);
  return lane == 0 ? Pair{0u, 0u} : below;
}

// The exclusive prefix of tile `tile` (> 0), read by warp 0 from its
// predecessors' status words: lane l looks at tile last - l, and the window
// moves back 32 tiles while no lane sees an inclusive prefix. A tile whose two
// words are unpublished or carry different flags is read again.
__device__ Pair look_back(const volatile unsigned long long* status,
                          uint32_t tile, int lane) {
  Pair before{0u, 0u};
  int64_t last = (int64_t)tile - 1;
  while (true) {
    const int64_t idx = last - lane;
    unsigned long long s, m;
    do {
      s = m = kPrefix;  // before tile 0: the identity, as a prefix
      if (idx >= 0) {
        s = status[2 * idx];
        m = status[2 * idx + 1];
      }
    } while (__any_sync(kFull, (s >> 32) == 0 || (s >> 32) != (m >> 32)));
    const unsigned prefixes = __ballot_sync(kFull, (s >> 32) == 2);
    // lanes up to the nearest inclusive prefix contribute
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    const bool in = lane <= stop;
    before.sum += __reduce_add_sync(kFull, in ? static_cast<uint32_t>(s) : 0u);
    const uint32_t mx =
        __reduce_max_sync(kFull, in ? static_cast<uint32_t>(m) : 0u);
    before.mx = before.mx > mx ? before.mx : mx;
    if (prefixes) return before;
    last -= 32;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fill_lookback(const uint32_t* __restrict__ sk,
                  const uint32_t* __restrict__ sa,
                  const uint32_t* __restrict__ dv, int64_t n, uint32_t nq,
                  uint32_t* __restrict__ dest, uint32_t* __restrict__ val,
                  unsigned* __restrict__ counters, unsigned long long* status,
                  bool vec) {
  __shared__ uint32_t s_tile;
  __shared__ Pair s_warp[kWarps];
  __shared__ Pair s_before;
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counters, 1u);
  __syncthreads();
  const uint32_t tile = s_tile;
  // lane l's vector j holds rows wbase + 4 * (32 * j + l) + [0, 4)
  const int64_t wbase = (int64_t)tile * kTile + (int64_t)warp * kWarpRows;
  const bool full = vec && wbase + kWarpRows <= n;

  uint32_t k[kVecs][4], a[kVecs][4], d[kVecs][4];
  if (full) {
    const uint4* k4 = reinterpret_cast<const uint4*>(sk + wbase) + lane;
    const uint4* a4 = reinterpret_cast<const uint4*>(sa + wbase) + lane;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const uint4 qk = __ldcs(k4 + 32 * j);
      const uint4 qa = __ldcs(a4 + 32 * j);
      k[j][0] = qk.x, k[j][1] = qk.y, k[j][2] = qk.z, k[j][3] = qk.w;
      a[j][0] = qa.x, a[j][1] = qa.y, a[j][2] = qa.z, a[j][3] = qa.w;
      if (kMode == kVal32) {
        const uint4 qd =
            __ldcs(reinterpret_cast<const uint4*>(dv + wbase) + lane + 32 * j);
        d[j][0] = qd.x, d[j][1] = qd.y, d[j][2] = qd.z, d[j][3] = qd.w;
      } else {
        d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0u;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t i = wbase + 4 * (32 * j + lane) + c;
        const bool in = i < n;
        k[j][c] = in ? sk[i] : 0u;
        a[j][c] = in ? sa[i] : kTag;  // past n: a query row, the identity
        d[j][c] = kMode == kVal32 && in ? dv[i] : 0u;
      }
    }
  }

  // each vector reduced in the thread and scanned across the warp's lanes;
  // the vectors chain one after the other
  Pair excl[kVecs];
  Pair run{0u, 0u};
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    Pair own{0u, 0u};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      own = combine(own, contrib<kMode>(k[j][c], a[j][c], d[j][c]));
    }
    const Pair inc = warp_inclusive<kMode>(own, lane);
    excl[j] = combine(run, lane_below<kMode>(inc, lane));
    run = combine(run, shfl_from<kMode>(inc, 31));
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  if (warp == 0) {
    const Pair w = lane < kWarps ? s_warp[lane] : Pair{0u, 0u};
    const Pair winc = warp_inclusive<kMode>(w, lane);
    const Pair wexcl = lane_below<kMode>(winc, lane);
    const Pair aggregate = shfl_from<kMode>(winc, 31);
    if (lane < kWarps) s_warp[lane] = wexcl;
    volatile unsigned long long* st = status;
    Pair before{0u, 0u};
    if (tile != 0) {
      if (lane == 0) {
        st[2 * tile] = kAggregate | aggregate.sum;
        st[2 * tile + 1] = kAggregate | aggregate.mx;
      }
      before = look_back(st, tile, lane);
    }
    if (lane == 0) {
      const Pair inc = combine(before, aggregate);
      st[2 * tile] = kPrefix | inc.sum;
      st[2 * tile + 1] = kPrefix | inc.mx;
      s_before = before;
      // every status read of this block is done: count it finished
      __threadfence();
      s_last = atomicAdd(counters + 1, 1u) == gridDim.x - 1;
      __threadfence();
    }
  }
  __syncthreads();
  if (s_last) {  // no block reads a status word any more: leave them zero
    for (uint32_t t = threadIdx.x; t < 2 * gridDim.x; t += kThreads) {
      status[t] = 0;
    }
    if (threadIdx.x == 0) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }

  const Pair off = combine(s_before, s_warp[warp]);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    Pair r = combine(off, excl[j]);
    uint32_t o_dest[4], o_val[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t kc = k[j][c], ac = a[j][c];
      r = combine(r, contrib<kMode>(kc, ac, d[j][c]));  // inclusive of row
      const bool is_src = (ac & kTag) == 0u;
      const bool found = !is_src && r.mx == kc + 1u && kc != kEmpty;
      const uint32_t fv = kMode == kVal16 ? r.sum & 0xFFFFu : r.sum;
      o_val[c] = found && kMode != kMembership ? fv : 0u;
      const uint32_t qp = ac & 0x7FFFFFFFu;
      o_dest[c] = !is_src && qp < nq ? (qp << 1) | (found ? 1u : 0u) : kEmpty;
    }
    if (full) {
      __stcs(reinterpret_cast<uint4*>(dest + wbase) + 32 * j + lane,
             make_uint4(o_dest[0], o_dest[1], o_dest[2], o_dest[3]));
      __stcs(reinterpret_cast<uint4*>(val + wbase) + 32 * j + lane,
             make_uint4(o_val[0], o_val[1], o_val[2], o_val[3]));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t i = wbase + 4 * (32 * j + lane) + c;
        if (i < n) {
          dest[i] = o_dest[c];
          val[i] = o_val[c];
        }
      }
    }
  }
}

}  // namespace

// Number of int32 scratch words dbt_merge_fill needs for n rows: the tile
// counter and the finished-block counter, then two 64-bit status words a
// tile.
extern "C" int64_t dbt_merge_fill_scratch(int64_t n) {
  return 2 + 4 * ((n + kTile - 1) / kTile);
}

// dv is read only in mode 0 (32-bit); mode 1 is val16, mode 2 membership.
// scratch holds at least dbt_merge_fill_scratch(n) int32 words, 8-byte
// aligned and zero; the kernel leaves them zero. Work on one stream runs in
// order, so one scratch buffer serves every call on a stream. nq is below
// 2^31.
extern "C" int dbt_merge_fill(const int32_t* sk, const int32_t* sa,
                              const int32_t* dv, int64_t n, int64_t nq,
                              int32_t mode, int32_t* dest, int32_t* val,
                              int32_t* scratch, void* stream) {
  if (mode < kVal32 || mode > kMembership || nq < 0 || nq >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned ntiles = static_cast<unsigned>((n + kTile - 1) / kTile);
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(sk) | reinterpret_cast<uintptr_t>(sa) |
      (mode == kVal32 ? reinterpret_cast<uintptr_t>(dv) : 0) |
      reinterpret_cast<uintptr_t>(dest) | reinterpret_cast<uintptr_t>(val);
  const bool vec = (bits & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = reinterpret_cast<const uint32_t*>(sk);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(sa);
  const uint32_t* d = reinterpret_cast<const uint32_t*>(dv);
  uint32_t* o_dest = reinterpret_cast<uint32_t*>(dest);
  uint32_t* o_val = reinterpret_cast<uint32_t*>(val);
  unsigned* counters = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + 2);
  const uint32_t q = static_cast<uint32_t>(nq);
  if (mode == kVal32) {
    fill_lookback<kVal32><<<ntiles, kThreads, 0, s>>>(
        k, a, d, n, q, o_dest, o_val, counters, status, vec);
  } else if (mode == kVal16) {
    fill_lookback<kVal16><<<ntiles, kThreads, 0, s>>>(
        k, a, d, n, q, o_dest, o_val, counters, status, vec);
  } else {
    fill_lookback<kMembership><<<ntiles, kThreads, 0, s>>>(
        k, a, d, n, q, o_dest, o_val, counters, status, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
