// Elementwise add of two contiguous tensors of one 4-byte type.
//
// Replaces examples/vadd.py:21 vadd_pallas, a whole-array a + b in the TPU's
// VMEM. float32 adds with __fadd_rn (round to nearest even, never contracted
// into a fused multiply-add), so the sum equals XLA's add bit for bit; int32
// adds wrap mod 2^32. Bound on the card: 12 bytes a row (two reads, one
// write). Where all three pointers are 16-byte aligned each thread moves
// 16-byte vectors, and a second launch takes the last n % 4 rows; otherwise
// one scalar launch takes all rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kFloat>
__device__ __forceinline__ uint32_t add1(uint32_t a, uint32_t b) {
  if (kFloat) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  return a + b;
}

template <bool kFloat>
__global__ void vadd_vec4_kernel(const uint4* __restrict__ a,
                                 const uint4* __restrict__ b,
                                 uint4* __restrict__ out, int64_t n4) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const uint4 x = a[i];
    const uint4 y = b[i];
    uint4 r;
    r.x = add1<kFloat>(x.x, y.x);
    r.y = add1<kFloat>(x.y, y.y);
    r.z = add1<kFloat>(x.z, y.z);
    r.w = add1<kFloat>(x.w, y.w);
    out[i] = r;
  }
}

template <bool kFloat>
__global__ void vadd_scalar_kernel(const uint32_t* __restrict__ a,
                                   const uint32_t* __restrict__ b,
                                   uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = add1<kFloat>(a[i], b[i]);
  }
}

template <bool kFloat>
void vadd(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
          cudaStream_t stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out);
  const int64_t n4 = (bits & 15) == 0 ? n / 4 : 0;
  if (n4 > 0) {
    vadd_vec4_kernel<kFloat><<<dbt::grid_for(n4, kThreads, 8), kThreads, 0,
                               stream>>>(
        reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
        reinterpret_cast<uint4*>(out), n4);
  }
  const int64_t done = 4 * n4;
  if (n > done) {
    vadd_scalar_kernel<kFloat><<<dbt::grid_for(n - done, kThreads, 8),
                                 kThreads, 0, stream>>>(
        a + done, b + done, out + done, n - done);
  }
}

}  // namespace

// a, b and out hold n contiguous 4-byte values; dtype 0 is float32, 1 int32.
extern "C" int dbt_vadd(const void* a, const void* b, void* out, int64_t n,
                        int32_t dtype, void* stream) {
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
