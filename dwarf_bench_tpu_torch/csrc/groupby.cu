// Group-by sum over a small dense key space.
//
// Replaces dwarf_bench_tpu/ops/groupby_pallas.py:307 groupby_small_pallas:
// (G,) uint32 sums of v per key in [0, G), G <= 4096; keys >= G (as uint32)
// are dropped and sums wrap mod 2^32. The TPU kernel splits keys into two
// digits and v into two 7-bit bf16 planes for one-hot matmuls, because the
// TPU has no atomics; that is also where its v < 2^14 precondition comes from,
// and this kernel takes any v.
//
// Bound on the card: 8 bytes a row read once, 33.6 MB at 2^22 rows, 10.0 us
// at 3.35 TB/s when the rows come from memory. Such a read is paced by the
// bytes each SM keeps in flight: a loop of one 4-byte key and value a
// thread, waited on before its add, keeps about 8 KB in flight an SM and
// reads at 1.2 TB/s.
// Shared-memory atomics pace one hot key (the lanes of a warp that hit one
// word serialize), and at G = 4096 the tables' zeroing, folding and global
// reductions, G words a block each, weigh against the rows.
//
// The plan (ops/groupby_cuda.py groupby_plan, chosen by the plan sweep of
// utils/kernel_times.py --sweep groupby, PERF.md) picks one of two loops:
//   - vector: 16-byte loads, `depth` int4 of keys and of values a thread in
//     registers before its first add (2: 64 KB in flight an SM at two blocks
//     of 512 an SM), grid-stride over the rows. It starts at row `head`, the
//     first whose key and value lie on 16 bytes; the head rows and the tail
//     past the last int4 take scalar loads in block 0. An int4 of four rows
//     of one key makes one add of their sum, so a hot key serializes a
//     quarter of the adds. A ring of bulk copies (cp.async.bulk into 2-6
//     stages of 2048-8192 rows with an mbarrier a stage, one producer warp,
//     one block an SM) kept up to 192 KB in flight an SM and measured no
//     faster cold, and slower on a hot key (PERF.md §6 #3);
//   - scalar: 4-byte loads, `depth` rows a thread before its first add, for
//     keys and values whose addresses differ mod 16 bytes.
// Each warp adds into table (warp % tables) of G words in shared memory,
// dynamic shared memory above 48 KB where the plan asks for it.
//
// One launch, no memset: the output comes from torch.empty and is written
// whole. A block folds its tables; a grid of one block writes the output
// itself. Otherwise each block adds its non-zero sums into an accumulator in
// the per-stream scratch (ops/_build.py stream_scratch) with reductions it
// does not wait for, and thread 0 takes a ticket with one acquire-release
// atomic after the block's barrier. The block with the last ticket copies
// the accumulator into the output and zeroes it and the ticket, so the
// scratch is left as it was found. Nothing spins across blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kHeader = 32;  // scratch words before the accumulator
constexpr int kScalar = 0;
constexpr int kVector = 1;

__device__ __forceinline__ uint32_t ticket_acq_rel(uint32_t* p) {
  uint32_t old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

__device__ __forceinline__ void add_row(uint32_t* table, uint32_t groups,
                                        int32_t k, int32_t v) {
  const uint32_t ku = static_cast<uint32_t>(k);
  if (ku < groups) atomicAdd(table + ku, static_cast<uint32_t>(v));
}

// Four rows; four rows of one key take one add of their sum (mod 2^32), so
// a hot key costs a quarter of the serialized adds.
__device__ __forceinline__ void add_row(uint32_t* table, uint32_t groups,
                                        int4 k, int4 v) {
  if (k.x == k.y && k.y == k.z && k.z == k.w) {
    const uint32_t ku = static_cast<uint32_t>(k.x);
    if (ku < groups) {
      atomicAdd(table + ku,
                static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y) +
                    static_cast<uint32_t>(v.z) + static_cast<uint32_t>(v.w));
    }
    return;
  }
  add_row(table, groups, k.x, v.x);
  add_row(table, groups, k.y, v.y);
  add_row(table, groups, k.z, v.z);
  add_row(table, groups, k.w, v.w);
}

__device__ __forceinline__ void no_row(int32_t& k) { k = -1; }
__device__ __forceinline__ void no_row(int4& k) {
  k = make_int4(-1, -1, -1, -1);
}

// The rows before `head` and from `body_end` to n, scalar, in block 0.
__device__ __forceinline__ void edge_rows(const int32_t* keys,
                                          const int32_t* vals, int64_t n,
                                          int64_t head, int64_t body_end,
                                          uint32_t* table, uint32_t groups) {
  const int64_t t = threadIdx.x;
  if (blockIdx.x != 0 || t >= head + (n - body_end)) return;
  const int64_t i = t < head ? t : body_end + (t - head);
  add_row(table, groups, keys[i], vals[i]);
}

// Fold the block's tables and hand the sums on (see the header). Every
// thread of the block calls it.
__device__ void finish(const uint32_t* tables, uint32_t groups,
                       uint32_t ntables, uint32_t* __restrict__ out,
                       uint32_t* scratch) {
  __shared__ bool s_last;
  const bool single = gridDim.x == 1;
  uint32_t* acc = scratch + kHeader;
  __syncthreads();
  for (uint32_t g = threadIdx.x; g < groups; g += blockDim.x) {
    uint32_t s = 0;
    for (uint32_t c = 0; c < ntables; ++c) s += tables[c * groups + g];
    if (single) {
      out[g] = s;
    } else if (s != 0) {
      atomicAdd(acc + g, s);  // a reduction: nothing waits for it
    }
  }
  if (single) return;
  __syncthreads();
  if (threadIdx.x == 0) s_last = ticket_acq_rel(scratch) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  for (uint32_t g = threadIdx.x; g < groups; g += blockDim.x) {
    out[g] = __ldcg(acc + g);
    acc[g] = 0;
  }
  if (threadIdx.x == 0) scratch[0] = 0;
}

// The vector (V = int4) and scalar (V = int32_t) loops: `kDepth` V of keys
// and of values a thread loaded before any add.
template <typename V, int kDepth>
__global__ void __launch_bounds__(kThreads, 2)
    groupby_loads_kernel(const int32_t* __restrict__ keys,
                         const int32_t* __restrict__ vals, int64_t n,
                         int64_t head, uint32_t* __restrict__ out,
                         uint32_t* scratch, uint32_t groups,
                         uint32_t ntables) {
  extern __shared__ uint32_t tables[];
  constexpr int kRows = sizeof(V) / sizeof(int32_t);
  for (uint32_t w = threadIdx.x; w < groups * ntables; w += kThreads) {
    tables[w] = 0;
  }
  __syncthreads();
  uint32_t* mine = tables + ((threadIdx.x >> 5) % ntables) * groups;
  const int64_t nv = (n - head) / kRows;
  edge_rows(keys, vals, n, head, head + nv * kRows, mine, groups);
  const V* kv = reinterpret_cast<const V*>(keys + head);
  const V* vv = reinterpret_cast<const V*>(vals + head);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j0 = (int64_t)blockIdx.x * kThreads + threadIdx.x; j0 < nv;
       j0 += kDepth * stride) {
    V k[kDepth], v[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const int64_t j = j0 + u * stride;
      if (j < nv) {
        k[u] = __ldg(kv + j);
        v[u] = __ldg(vv + j);
      } else {
        no_row(k[u]);
        v[u] = k[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) add_row(mine, groups, k[u], v[u]);
  }
  finish(tables, groups, ntables, out, scratch);
}

// The loop's kernel, allowed the card's opt-in shared memory once a device.
template <typename V, int kDepth>
cudaError_t launch(const int32_t* keys, const int32_t* vals, int64_t n,
                   int64_t head, uint32_t* out, uint32_t* scratch,
                   uint32_t groups, uint32_t ntables, int blocks, int smem,
                   cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  auto kernel = groupby_loads_kernel<V, kDepth>;
  const cudaError_t err = dbt::configure(kernel, false, done);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, st>>>(keys, vals, n, head, out, scratch,
                                         groups, ntables);
  return cudaGetLastError();
}

}  // namespace

// out holds `groups` int32, written whole; 1 <= groups <= 4096, n >= 0.
// The plan (design, blocks, tables, depth, smem, head) comes from
// ops/groupby_cuda.py groupby_plan; a plan the loops cannot run returns
// cudaErrorInvalidValue and launches nothing. With more than one block,
// scratch holds scratch_words >= 32 + groups int32, all zero; the kernel
// leaves them zero, so one buffer serves every call on a stream.
extern "C" int dbt_groupby_small(const int32_t* keys, const int32_t* vals,
                                 int64_t n, int32_t* out, int32_t groups,
                                 int32_t design, int32_t blocks,
                                 int32_t tables, int32_t depth, int32_t smem,
                                 int32_t head, int32_t* scratch,
                                 int64_t scratch_words, void* stream) {
  const auto on16 = [&](const int32_t* p) {
    return (reinterpret_cast<uintptr_t>(p + head) & 15) == 0;
  };
  bool ok = n >= 0 && groups >= 1 && groups <= 4096 && blocks >= 1 &&
            tables >= 1 && tables <= kWarps &&
            smem >= int64_t{4} * tables * groups &&
            (blocks == 1 || scratch_words >= kHeader + groups);
  if (design == kScalar) {
    ok = ok && head == 0 && depth == 8;
  } else if (design == kVector) {
    ok = ok && head >= 0 && head <= 3 && on16(keys) && on16(vals) &&
         (depth == 1 || depth == 2 || depth == 4);
  } else {
    ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t h = head < n ? head : n;
  auto* o = reinterpret_cast<uint32_t*>(out);
  auto* s = reinterpret_cast<uint32_t*>(scratch);
  const auto g = static_cast<uint32_t>(groups);
  const auto c = static_cast<uint32_t>(tables);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define DBT_GROUPBY(V, D) \
  err = launch<V, D>(keys, vals, n, h, o, s, g, c, blocks, smem, st)
  if (design == kVector) {
    if (depth == 1) DBT_GROUPBY(int4, 1);
    if (depth == 2) DBT_GROUPBY(int4, 2);
    if (depth == 4) DBT_GROUPBY(int4, 4);
  } else {
    if (depth == 8) DBT_GROUPBY(int32_t, 8);
  }
#undef DBT_GROUPBY
  return static_cast<int>(err);
}
