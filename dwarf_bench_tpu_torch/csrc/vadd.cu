// Elementwise add of two contiguous tensors of one 4-byte type.
//
// Replaces examples/vadd.py:21 vadd_pallas, a whole-array a + b in the TPU's
// VMEM. float32 adds with __fadd_rn (round to nearest even, never contracted
// into a fused multiply-add), so the sum equals XLA's add bit for bit; int32
// adds wrap mod 2^32.
//
// Bound on the card: device-memory bandwidth, 12 bytes a row (two reads, one
// write). One launch, one tile of kTile values a block and no grid-stride
// loop, so the hardware's block scheduler balances the last wave over the
// SMs. Each thread first issues kVecs 16-byte loads of a and kVecs of b,
// then adds, then stores. Streaming hints (__ldcs, __stcs) measured about
// 3 % slower on an H100, and the tile's shape moved the time by less.
// Where a, b and out all sit on 16-byte boundaries, the values after the last
// whole vector (the tail, fewer than 4) are scalars taken by the first block
// in the same launch. Where any does not, every value is a scalar load,
// 4 * kVecs a thread over the same tiles, still in one launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;                 // 16-byte loads an array a thread
constexpr int kTileVecs = kThreads * kVecs;
constexpr int kTile = 4 * kTileVecs;     // 2048 values a block

template <bool kFloat>
__device__ __forceinline__ uint32_t add1(uint32_t a, uint32_t b) {
  if (kFloat) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  return a + b;
}

template <bool kFloat>
__device__ __forceinline__ uint4 add4(uint4 x, uint4 y) {
  return make_uint4(add1<kFloat>(x.x, y.x), add1<kFloat>(x.y, y.y),
                    add1<kFloat>(x.z, y.z), add1<kFloat>(x.w, y.w));
}

// nvec = n / 4 16-byte vectors, then scalars up to n. Block t takes vectors
// [t, t + 1) * kTileVecs.
template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
    vadd_vec(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             uint32_t* __restrict__ out, int64_t n, int64_t nvec) {
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const int64_t i0 = (int64_t)blockIdx.x * kTileVecs + threadIdx.x;
  if (i0 + (kVecs - 1) * kThreads < nvec) {
    uint4 x[kVecs], y[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) x[u] = av[i0 + u * kThreads];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) y[u] = bv[i0 + u * kThreads];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      ov[i0 + u * kThreads] = add4<kFloat>(x[u], y[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < nvec) ov[i] = add4<kFloat>(av[i], bv[i]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    const int64_t i = 4 * nvec + threadIdx.x;
    if (i < n) out[i] = add1<kFloat>(a[i], b[i]);
  }
}

// Every value a scalar; block t takes values [t, t + 1) * kTile.
template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
    vadd_scalar(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, int64_t n) {
  constexpr int kItems = 4 * kVecs;
  const int64_t i0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
  if (i0 + (kItems - 1) * kThreads < n) {
    uint32_t x[kItems], y[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) x[u] = a[i0 + u * kThreads];
#pragma unroll
    for (int u = 0; u < kItems; ++u) y[u] = b[i0 + u * kThreads];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      out[i0 + u * kThreads] = add1<kFloat>(x[u], y[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < n) out[i] = add1<kFloat>(a[i], b[i]);
    }
  }
}

template <bool kFloat>
void vadd(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
          cudaStream_t stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out);
  if ((bits & 15) == 0) {
    const int64_t nvec = n / 4;
    const int64_t grid = nvec > 0 ? (nvec + kTileVecs - 1) / kTileVecs : 1;
    vadd_vec<kFloat><<<(unsigned)grid, kThreads, 0, stream>>>(a, b, out, n,
                                                              nvec);
  } else {
    vadd_scalar<kFloat><<<(unsigned)((n + kTile - 1) / kTile), kThreads, 0,
                          stream>>>(a, b, out, n);
  }
}

}  // namespace

// a, b and out hold n contiguous 4-byte values, each at 4-byte alignment;
// dtype 0 is float32, 1 int32.
extern "C" int dbt_vadd(const void* a, const void* b, void* out, int64_t n,
                        int32_t dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const uint32_t* x = static_cast<const uint32_t*>(a);
  const uint32_t* y = static_cast<const uint32_t*>(b);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    vadd<true>(x, y, o, n, s);
  } else {
    vadd<false>(x, y, o, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
