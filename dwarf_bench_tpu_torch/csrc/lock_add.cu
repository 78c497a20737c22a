// A counter incremented under a device-wide ticket lock, once by every block.
//
// Replaces examples/lock_add.py:20 grid_accumulate, the TPU analog of the
// reference's example/lock_add/lock_add.cpp:50-63 (every work-group takes a
// global CAS spin lock and increments one counter). The TPU's grid runs its
// steps in order on one core, so they add into a scalar without a lock, and
// step 0 zeroes it. Blocks on the card run in parallel and in no order, so
// this kernel keeps the reference's lock, as a ticket lock built for the card:
//   - thread 0 of each of the n_steps blocks takes a ticket t with one
//     atomicAdd on `next`. Tickets go to blocks as they start, so a block
//     waits only on blocks that have started, and no context can hang it;
//   - it polls one 8-byte word with loads until the word's low half, the
//     ticket served, reads t. The next in line polls without a pause; a
//     block further back sleeps in proportion to its distance from the head
//     of the line between polls, so the blocks far back leave the word's L2
//     line to the holder and its successor (with a CAS a try from every
//     waiter, each handoff waits behind thousands of atomics: PERF.md);
//   - the word's high half is the counter. The holder adds one to the value
//     its load delivered and hands over with one store of (counter + 1,
//     t + 1): one round trip of the word a handoff. The lock guards nothing
//     outside the word, so its loads and stores are relaxed at device
//     scope: coherence orders every value of one word, and each holder's
//     store follows the load of its predecessor's. (Acquire loads and a
//     release store, the fences a lock needs for other data, doubled the
//     time a handoff on an H100: PERF.md.)
//   - the last ticket (n_steps - 1) writes the counter to out and puts
//     `next` and the word back to zero, so the scratch, one lasting buffer a
//     stream (ops/_build.py stream_scratch), needs no memset: one launch.
//
// Bound on the card: the n_steps acquisitions are serialized through one
// word in the L2, each at least one round trip of the L2 after the last;
// dbt_l2_round_trip measures that round trip.
#include "common.cuh"

namespace {

// The sleep between polls a block of distance from the head of the line:
// below a handoff, so that a waiter is polling when its turn comes.
constexpr unsigned kBackoffNs = 64;
constexpr unsigned kMaxDistance = 4096;  // caps the sleep near 262 us
// The scratch: the ticket counter at word 0, the (counter, served) word 128
// bytes on (ops/lock_add_cuda.py LOCK_SCRATCH_WORDS).
constexpr int kWordOffset = 32;

// A load and a store of the word, relaxed at device scope: they go to the
// L2, never to a stale L1 line.
__device__ __forceinline__ unsigned long long load_relaxed64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed64(unsigned long long* p,
                                                unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :
               : "l"(p), "l"(v)
               : "memory");
}

// next: the ticket counter; word: (counter << 32) | ticket served, on
// another L2 line. Both zero, and left zero.
__global__ void lock_add_kernel(unsigned* next, unsigned long long* word,
                                int32_t* out, uint32_t n_steps) {
  if (threadIdx.x != 0) return;
  const uint32_t t = atomicAdd(next, 1u);
  unsigned long long w = load_relaxed64(word);
  while (static_cast<uint32_t>(w) != t) {
    const uint32_t d = t - static_cast<uint32_t>(w) - 1;  // blocks ahead
    if (d > 0) __nanosleep((d < kMaxDistance ? d : kMaxDistance) * kBackoffNs);
    w = load_relaxed64(word);
  }
  const uint32_t counter = static_cast<uint32_t>(w >> 32) + 1;  // locked
  if (t + 1 == n_steps) {  // every other block has taken and left the lock
    *out = static_cast<int32_t>(counter);
    *next = 0;
    *word = 0;
  } else {
    store_relaxed64(word, static_cast<unsigned long long>(counter) << 32 |
                              (t + 1));
  }
}

// One thread runs `chain` atomic adds of one on one word, each at an
// address computed from the value the one before returned (word + v / 2^31,
// the word itself while v < 2^31), so that no add can start before the last
// one is back, and writes the chain's nanoseconds on the global timer and
// the word's last value. (Where only the added value depended on the last
// result, the compiler sent three of every four adds without waiting.)
__global__ void round_trip_kernel(unsigned* word, int32_t chain,
                                  int64_t* out) {
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) : : "memory");
  unsigned v = 0;
  for (int32_t i = 0; i < chain; ++i) v = atomicAdd(word + (v >> 31), 1u);
  out[1] = v;  // waits for the last add's result
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) : : "memory");
  out[0] = static_cast<int64_t>(t1 - t0);
}

}  // namespace

// scratch holds 64 int32, zero, 128-byte aligned, and is left zero: the
// ticket counter, and the 8-byte (counter, ticket served) word on an L2 line
// of its own, so that blocks taking tickets do not queue on the line the
// holder hands over. out (one int32) ends at n_steps >= 1. One launch, no
// memset.
extern "C" int dbt_lock_add(int32_t* scratch, int32_t* out, int32_t n_steps,
                            void* stream) {
  if (n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  lock_add_kernel<<<n_steps, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<unsigned*>(scratch),
      reinterpret_cast<unsigned long long*>(scratch + kWordOffset), out,
      static_cast<uint32_t>(n_steps));
  return static_cast<int>(cudaGetLastError());
}

// One block of one thread: `chain` >= 1 dependent atomicAdds on *word;
// out[0] gets the nanoseconds they took, out[1] the word's last value. The
// time over `chain` is one L2 round trip of an atomic, the least a lock
// handoff between two blocks can take.
extern "C" int dbt_l2_round_trip(int32_t* word, int32_t chain, int64_t* out,
                                 void* stream) {
  if (chain < 1) return static_cast<int>(cudaErrorInvalidValue);
  round_trip_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<unsigned*>(word), chain, out);
  return static_cast<int>(cudaGetLastError());
}
