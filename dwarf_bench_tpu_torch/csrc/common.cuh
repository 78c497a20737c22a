// Shared helpers for the hand-written Hopper kernels of dwarf_bench_tpu_torch.
//
// Every entry point has a plain C interface (loaded with ctypes from
// ops/_build.py), launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so that a refused launch surfaces in Python.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dbt {

// Streaming multiprocessors of the current device (132 on an H100 SXM).
inline int num_sms() {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Grid for a grid-stride loop over n elements: enough blocks to cover n,
// at most `per_sm` blocks on each SM, at least one block.
inline int grid_for(int64_t n, int threads, int per_sm) {
  int64_t want = (n + threads - 1) / threads;
  int64_t cap = (int64_t)num_sms() * per_sm;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

}  // namespace dbt
