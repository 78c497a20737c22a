// Bitonic merge of 2-4 uint32 columns.
//
// Replaces dwarf_bench_tpu/ops/bitonic_pallas.py:100 merge_bitonic_pallas:
// sort a bitonic sequence of N = 2^m rows ascending under the unsigned
// lexicographic order of (col0[, col1]); every column rides the exchanges.
// The network is exactly Batcher's, as ops/bitonic.py runs it: for every
// stride s = N/2 ... 1 and every row i with (i & s) == 0, rows i and i + s
// swap in all columns iff row i + s is less than row i, and neither moves on
// equality. The same pairs and the same tie rule give the plain network's
// output bit for bit on every input, ties included.
//
// Bound on the card: device-memory traffic. Every stage touches every row,
// so what counts is how many stages share one trip through device memory.
// The TPU kernel runs the network in two streaming passes (a column cascade
// and a row cascade in VMEM); this one runs it in a few passes over tiles of
// 2^L rows (L = tile_bits, 9-12), 3 at N = 2^25:
//   - a pass runs the stages of the stride bits [lo, hi). Stages of one
//     stride are independent, so a tile that holds every row differing only
//     in those bits can run them alone, and any grouping of consecutive
//     stages into passes gives the network's output. A strided pass's tile
//     is the 2^(hi-lo) rows of those bits times a run of 2^(L-(hi-lo)) >= 32
//     consecutive rows, so each warp load and store is at least one whole
//     128-byte line of a column; the last pass (lo = 0) takes 2^L
//     consecutive rows and every stride below 2^L.
//   - a thread holds 16 rows of every column in registers, loaded straight
//     from device memory and stored straight back. In layout A its rows
//     differ in the tile's local bits [L-4, L), in layout B in [5, 9); in
//     both, the 32 lanes of a warp are local bits [0, 5). Stages on local
//     bits >= L-4 run in layout A, those on [5, L-4) in layout B after one
//     exchange through shared memory (the only __syncthreads), and those on
//     bits [0, 5) with warp shuffles; no stage waits on another warp.
// The plan, the list of passes, is ops/bitonic_cuda.py merge_plan. The first
// pass reads src and writes dst; later passes work in place in dst (each tile
// reads and writes only its own rows).
#include "common.cuh"

namespace {

constexpr int kMaxCols = 4;
constexpr int kRegBits = 4;  // a thread holds 2^4 rows
constexpr int kRows = 1 << kRegBits;
constexpr int kLaneBits = 5;
constexpr int kMinTileBits = kLaneBits + kRegBits;  // one warp a tile
constexpr int kMaxTileBits = 12;  // 4096 rows: 64 KB at 4 cols
constexpr int kMaxThreads = 1 << (kMaxTileBits - kRegBits);
constexpr int kMaxPasses = 32;

struct Cols {
  const uint32_t* src[kMaxCols];
  uint32_t* dst[kMaxCols];
};

// One pass. Local bits [0, run_bits) of a tile are global row bits
// [0, run_bits), local bits [run_bits, L) are global bits [lo, lo + L -
// run_bits); the tile number fills the other global bits, low ones first.
// Stages run on local bits [a_lo, a_hi) in layout A, then [b_lo, b_hi) in
// layout B, then [c_lo, c_hi) across lanes, each range highest bit first.
struct Pass {
  int64_t n;  // rows; one tile longer than n skips the rows past it
  int tile_bits;
  int lo;
  int run_bits;
  int a_lo, a_hi, b_lo, b_hi, c_lo, c_hi;
};

__device__ __forceinline__ int64_t global_of(const Pass& p, int64_t j) {
  return (j & ((int64_t{1} << p.run_bits) - 1)) | ((j >> p.run_bits) << p.lo);
}

__device__ __forceinline__ int64_t tile_base(const Pass& p) {
  const int64_t t = blockIdx.x;
  const int low_bits = p.lo - p.run_bits;
  return ((t & ((int64_t{1} << low_bits) - 1)) << p.run_bits) |
         ((t >> low_bits) << (p.lo + p.tile_bits - p.run_bits));
}

// Row r of the thread is local index j0 | r << held; rows past n read 0 and
// are not written (they never pair with a row below n).
template <int NC>
__device__ __forceinline__ void load_rows(uint32_t (&v)[NC][kRows],
                                          const Cols& c, const Pass& p,
                                          int64_t base, int64_t j0, int held) {
  const int64_t g0 = base + global_of(p, j0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t g = g0 + global_of(p, int64_t{r} << held);
#pragma unroll
    for (int k = 0; k < NC; ++k) v[k][r] = g < p.n ? c.src[k][g] : 0u;
  }
}

template <int NC>
__device__ __forceinline__ void store_rows(const uint32_t (&v)[NC][kRows],
                                           const Cols& c, const Pass& p,
                                           int64_t base, int64_t j0, int held) {
  const int64_t g0 = base + global_of(p, j0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t g = g0 + global_of(p, int64_t{r} << held);
    if (g < p.n) {
#pragma unroll
      for (int k = 0; k < NC; ++k) c.dst[k][g] = v[k][r];
    }
  }
}

// Row j is less than row i in the compare order.
template <int NCMP>
__device__ __forceinline__ bool less(uint32_t j0, uint32_t j1, uint32_t i0,
                                     uint32_t i1) {
  return j0 < i0 || (NCMP == 2 && j0 == i0 && j1 < i1);
}

// Stages on the register bits [p_lo, p_hi), highest first: rows r and
// r | 2^p of the thread swap iff the upper one is less.
template <int NC, int NCMP>
__device__ __forceinline__ void register_stages(uint32_t (&v)[NC][kRows],
                                                int p_lo, int p_hi) {
#pragma unroll
  for (int p = kRegBits - 1; p >= 0; --p) {
    if (p < p_lo || p >= p_hi) continue;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i & (1 << p)) continue;
      const int j = i | (1 << p);
      const bool sw = less<NCMP>(v[0][j], v[1][j], v[0][i], v[1][i]);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const uint32_t a = v[k][i];
        const uint32_t b = v[k][j];
        v[k][i] = sw ? b : a;
        v[k][j] = sw ? a : b;
      }
    }
  }
}

// Stages on the lane bits [b_lo, b_hi), highest first: lane l and lane
// l ^ 2^b hold rows i (bit b clear) and j of a pair; both compute the same
// swap and the one that swaps takes its partner's values.
template <int NC, int NCMP>
__device__ __forceinline__ void lane_stages(uint32_t (&v)[NC][kRows],
                                            int b_lo, int b_hi, int lane) {
#pragma unroll
  for (int b = kLaneBits - 1; b >= 0; --b) {
    if (b < b_lo || b >= b_hi) continue;
    const bool upper = (lane >> b) & 1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      uint32_t o[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        o[k] = __shfl_xor_sync(0xffffffffu, v[k][r], 1 << b);
      }
      const uint32_t i0 = upper ? o[0] : v[0][r];
      const uint32_t j0 = upper ? v[0][r] : o[0];
      const uint32_t i1 = upper ? o[1] : v[1][r];
      const uint32_t j1 = upper ? v[1][r] : o[1];
      if (less<NCMP>(j0, j1, i0, i1)) {
#pragma unroll
        for (int k = 0; k < NC; ++k) v[k][r] = o[k];
      }
    }
  }
}

template <int NC, int NCMP>
__global__ void __launch_bounds__(kMaxThreads) merge_pass(Cols c, Pass p) {
  extern __shared__ uint32_t sm[];
  const int lane = threadIdx.x & 31;
  const int64_t warp = threadIdx.x >> kLaneBits;
  const int L = p.tile_bits;
  const int held_a = L - kRegBits;
  const int held_b = kLaneBits;
  const int64_t ja = lane | (warp << kLaneBits);
  const int64_t jb = lane | (warp << (kLaneBits + kRegBits));
  const int64_t base = tile_base(p);
  const bool do_a = p.a_lo < p.a_hi;
  const bool do_b = p.b_lo < p.b_hi;

  uint32_t v[NC][kRows];
  load_rows<NC>(v, c, p, base, do_a ? ja : jb, do_a ? held_a : held_b);
  if (do_a) register_stages<NC, NCMP>(v, p.a_lo - held_a, p.a_hi - held_a);
  if (do_a && do_b) {
    // layout A to layout B; a warp's 32 lanes touch 32 consecutive words on
    // both sides, so no bank is hit twice
#pragma unroll
    for (int k = 0; k < NC; ++k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sm[(int64_t{k} << L) | ja | (int64_t{r} << held_a)] = v[k][r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NC; ++k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        v[k][r] = sm[(int64_t{k} << L) | jb | (int64_t{r} << held_b)];
      }
    }
  }
  if (do_b) register_stages<NC, NCMP>(v, p.b_lo - held_b, p.b_hi - held_b);
  lane_stages<NC, NCMP>(v, p.c_lo, p.c_hi, lane);
  const bool in_b = do_b || !do_a;
  store_rows<NC>(v, c, p, base, in_b ? jb : ja, in_b ? held_b : held_a);
}

std::atomic<uint64_t> configured[kMaxCols + 1][3];

template <int NC, int NCMP>
cudaError_t launch_pass(const Cols& c, const Pass& p, cudaStream_t st) {
  cudaError_t err = dbt::configure(merge_pass<NC, NCMP>, false,
                                   configured[NC][NCMP]);
  if (err != cudaSuccess) return err;
  const bool exchange = p.a_lo < p.a_hi && p.b_lo < p.b_hi;
  const size_t smem = exchange ? (size_t{NC} * sizeof(uint32_t)) << p.tile_bits
                               : 0;
  const int64_t tiles = p.n >> p.tile_bits;
  merge_pass<NC, NCMP><<<(unsigned)(tiles > 0 ? tiles : 1),
                         1 << (p.tile_bits - kRegBits), smem, st>>>(c, p);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_cols(const Cols& c, const Pass& p, int num_cmp,
                        cudaStream_t st) {
  return num_cmp == 1 ? launch_pass<NC, 1>(c, p, st)
                      : launch_pass<NC, 2>(c, p, st);
}

int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The launch parameters of the pass over stride bits [lo, hi), or false if
// it is not one of a valid plan's passes.
bool make_pass(int64_t n, int m, int tile_bits, int lo, int hi, Pass* p) {
  p->n = n;
  p->tile_bits = tile_bits;
  int s_lo;
  if (lo == 0) {  // consecutive rows, every stride below 2^hi
    if (hi != (m < tile_bits ? m : tile_bits)) return false;
    p->lo = 0;
    p->run_bits = 0;
    s_lo = 0;
  } else {
    const int w = hi - lo;
    if (w < 1 || w > tile_bits - kLaneBits || lo < tile_bits) return false;
    p->lo = lo;
    p->run_bits = tile_bits - w;
    s_lo = p->run_bits;
  }
  const int s_hi = lo == 0 ? hi : tile_bits;
  const int split = tile_bits - kRegBits;
  p->a_lo = clamp_int(s_lo, split, s_hi);
  p->a_hi = s_hi > split ? s_hi : split;
  p->b_lo = clamp_int(s_lo, kLaneBits, split);
  p->b_hi = clamp_int(s_hi, kLaneBits, split);
  p->c_lo = clamp_int(s_lo, 0, kLaneBits);
  p->c_hi = clamp_int(s_hi, 0, kLaneBits);
  return true;
}

}  // namespace

// src/dst hold ncols (2-4) pointers each, unused ones null; n is a power of
// two (or 0), num_cmp 1 or 2. dst may equal src (in place). plan holds
// npasses (lo, hi) pairs of stride bits, highest first, from
// ops/bitonic_cuda.py merge_plan: they cover [0, log2 n) with no gap, every
// pass but the last (lo = 0) at most tile_bits - 5 bits wide with lo >=
// tile_bits, the last pass min(log2 n, tile_bits) wide. A plan that breaks
// this launches nothing and returns cudaErrorInvalidValue.
extern "C" int dbt_merge_bitonic(const int32_t* s0, const int32_t* s1,
                                 const int32_t* s2, const int32_t* s3,
                                 int32_t* d0, int32_t* d1, int32_t* d2,
                                 int32_t* d3, int32_t ncols, int64_t n,
                                 int32_t num_cmp, int32_t tile_bits,
                                 int32_t npasses, const int32_t* plan,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int m = 0;
  while ((int64_t{1} << m) < n) ++m;
  Pass passes[kMaxPasses];
  bool ok = (n & (n - 1)) == 0 && ncols >= 2 && ncols <= kMaxCols &&
            (num_cmp == 1 || num_cmp == 2) && tile_bits >= kMinTileBits &&
            tile_bits <= kMaxTileBits && npasses >= 1 &&
            npasses <= kMaxPasses;
  int top = m;
  for (int i = 0; ok && i < npasses; ++i) {
    const int lo = plan[2 * i];
    const int hi = plan[2 * i + 1];
    ok = hi == top && lo <= hi && (lo > 0) == (i + 1 < npasses) &&
         make_pass(n, m, tile_bits, lo, hi, &passes[i]);
    top = lo;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Cols c{{reinterpret_cast<const uint32_t*>(s0),
          reinterpret_cast<const uint32_t*>(s1),
          reinterpret_cast<const uint32_t*>(s2),
          reinterpret_cast<const uint32_t*>(s3)},
         {reinterpret_cast<uint32_t*>(d0), reinterpret_cast<uint32_t*>(d1),
          reinterpret_cast<uint32_t*>(d2), reinterpret_cast<uint32_t*>(d3)}};
  for (int i = 0; i < npasses; ++i) {
    cudaError_t err;
    switch (ncols) {
      case 2: err = launch_cols<2>(c, passes[i], num_cmp, st); break;
      case 3: err = launch_cols<3>(c, passes[i], num_cmp, st); break;
      default: err = launch_cols<4>(c, passes[i], num_cmp, st); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int k = 0; k < kMaxCols; ++k) c.src[k] = c.dst[k];
  }
  return static_cast<int>(cudaGetLastError());
}
