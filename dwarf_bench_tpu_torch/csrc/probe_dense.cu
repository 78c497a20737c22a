// Lookup of the dense CSR join's probe.
//
// Replaces dwarf_bench_tpu/ops/probe_pallas.py:174 probe_dense_rel_pallas and
// :43 probe_dense_cat_pallas (limit = hi_rows * 128; rel is hi_rows = 128).
// Per query key k (int32, min-shifted):
//   u = uint32(k); u >= limit (negatives, EMPTY, keys past the table)
//     -> (pos, cnt) = (0, 0);
//   otherwise rel = packed3[u], cnt = rel & 1023,
//     pos = cnt > 0 ? base128[u >> 7] + (rel >> 10) : 0.
// The TPU kernels find packed3[u] and base128[u >> 7] with one-hot matmuls on
// the MXU: f32 planes (rel) or three 8-bit bf16 planes (cat), which are exact
// only for packed3 and base128 below 2^24 (the packed3_ok precondition of
// csr_join.build_dense). Here a thread reads the two entries directly: the
// result is the contract's for any table, and equal to the TPU kernels' where
// their precondition holds. The sum wraps mod 2^32 (uint32_t arithmetic).
//
// The tables are 64 KB and 512 B and stay in L1/L2 (read through __ldg);
// each query reads 4 bytes and writes 8, so the kernel is bound by
// device-memory bandwidth: 12 MiB at 2^20 queries, about 3.8 us at the
// 3.35 TB/s peak.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    probe_dense_kernel(const int32_t* __restrict__ packed3,
                       const int32_t* __restrict__ base128,
                       const int32_t* __restrict__ ki, int64_t n,
                       uint32_t limit, int32_t* __restrict__ pos,
                       int32_t* __restrict__ cnt) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t u = static_cast<uint32_t>(ki[i]);
    int32_t p = 0;
    int32_t c = 0;
    if (u < limit) {
      const int32_t rel = __ldg(packed3 + u);
      c = rel & 1023;
      if (c > 0) {
        p = static_cast<int32_t>(
            static_cast<uint32_t>(__ldg(base128 + (u >> 7))) +
            static_cast<uint32_t>(rel >> 10));
      }
    }
    pos[i] = p;
    cnt[i] = c;
  }
}

}  // namespace

// packed3 holds at least `limit` entries and base128 at least limit / 128.
extern "C" int dbt_probe_dense(const int32_t* packed3, const int32_t* base128,
                               const int32_t* ki, int64_t n, int32_t limit,
                               int32_t* pos, int32_t* cnt, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = dbt::grid_for(n, kThreads, 8);
  probe_dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed3, base128, ki, n, static_cast<uint32_t>(limit), pos, cnt);
  return static_cast<int>(cudaGetLastError());
}
