// A device-wide spin lock taken once by every block, around an increment.
//
// Replaces examples/lock_add.py:20 grid_accumulate, the TPU analog of the
// reference's example/lock_add/lock_add.cpp:50-63 (every work-group takes a
// global CAS spin lock and increments one counter). The TPU's grid runs its
// steps in order on one core, so they add into a scalar without a lock, and
// step 0 zeroes it. Blocks on the card run in parallel and in no order, so
// this kernel takes the reference's lock: thread 0 of each of the n_steps
// blocks spins on atomicCAS(lock, 0, 1) (with a short sleep between tries,
// so that the spinning blocks leave the lock word's L2 slice to the
// holder), increments the counter with a volatile read-modify-write between
// two fences, and releases with atomicExch. The lock and the counter are
// zeroed by memsets on the stream before the launch, never by block 0, which
// may run after other blocks.
//
// Bound on the card: the n_steps acquisitions are serialized through one
// word in L2; each needs at least one L2 round trip.
#include "common.cuh"

namespace {

__global__ void lock_add_kernel(int32_t* lock, int32_t* counter) {
  if (threadIdx.x != 0) return;
  while (atomicCAS(lock, 0, 1) != 0) {
    __nanosleep(32);
  }
  __threadfence();
  volatile int32_t* c = counter;
  *c = *c + 1;
  __threadfence();
  atomicExch(lock, 0);
}

}  // namespace

// lock and counter are one int32 each; the counter ends at n_steps >= 1.
extern "C" int dbt_lock_add(int32_t* lock, int32_t* counter, int32_t n_steps,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(lock, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counter, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  lock_add_kernel<<<n_steps, 32, 0, s>>>(lock, counter);
  return static_cast<int>(cudaGetLastError());
}
