// The grid barriers of the port's cooperative launches and the capacity
// query that sizes them: grid_barrier for packed_maxsum.cu (K1's mixed
// branch) and sharded.cu (K7), word_barrier for packed_maxsum.cu (K1's
// binary branch), mgm2.cu (K6), local_search.cu (K4, K5) and
// dpop_sweep.cu (K10).  A cooperative launch
// (cudaLaunchCooperativeKernel) keeps every block of its grid resident,
// or is refused, so the blocks may wait for one another here.
#pragma once

#include <cuda_runtime.h>

namespace {

// All blocks of a cooperative launch meet here; the stores made before it
// are visible to every block after it (read them with __ldcg: a block's
// L1 may hold a line another block wrote).  bar[0] counts the blocks that
// arrived and returns to 0; bar[1] is the generation the last one bumps.
// The two words belong to the caller: zero before the first launch that
// uses them, and never shared by launches that may run at the same time.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// All blocks of the cooperative launch meet here; the stores made before
// it are visible to every block after it (read them with __ldcg).  One
// word, one atomic a block: block 0 adds 2^31 - (gridDim.x - 1), every
// other block 1, so the word's top bit flips when the last block arrives
// and its low bits come back to where they were; a block waits until the
// top bit differs from the one it found.  K6 meets six barriers a cycle,
// and on an H100 this one took 4 us a cycle off the 10k/30k colouring
// against grid_barrier above (two atomics and a generation read a
// block).  The word belongs to the call: zero before the launch, shared
// by no other.
__device__ __forceinline__ void word_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    volatile unsigned* word = bar;
    while (((old ^ *word) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The resident-block capacity of a cooperative kernel launched with
// `threads` threads a block and `shared` bytes of dynamic shared memory
// on the current device (0 when it cannot be asked).
inline int coop_capacity(const void* kernel, int threads, size_t shared = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    shared) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace
