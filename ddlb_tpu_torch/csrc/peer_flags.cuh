// The flag protocol and the cooperative launch shared by K2/K3
// (csrc/collective_matmul.cu) and K6 (csrc/alltoall_matmul.cu).
//
//  - Flags are uint32 counters in peer memory that only grow: a signal is
//    red.release.sys after a system fence, a wait polls ld.acquire.sys
//    until the counter reaches its target (compared modulo 2^32). A wait
//    of 20 s traps rather than holding the card.
//  - Waits and signals come block-wide (__syncthreads) or for one named
//    barrier's threads in a warp-specialised block.
//  - Every block spins on flags that other blocks and cards write, so a
//    kernel is launched cooperatively with the grid the card holds at once.

#pragma once

#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

namespace peer {

__device__ __forceinline__ unsigned ld_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(f)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* f, unsigned v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;\n" ::"l"(f), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait this long means a peer never signalled (a rank that did not
// launch, or a protocol fault): trap, so the launch fails with an error
// instead of holding the card forever.
constexpr unsigned long long WAIT_LIMIT_NS = 20ull * 1000 * 1000 * 1000;

// One thread: wait until *f >= target (mod 2^32).
__device__ __forceinline__ void spin_wait(const unsigned* f, unsigned target) {
  const unsigned long long start = globaltimer_ns();
  while (static_cast<int>(ld_acquire(f) - target) < 0) {
    __nanosleep(64);
    if (globaltimer_ns() - start > WAIT_LIMIT_NS) __trap();
  }
}

// Block-wide: wait until *f >= target (mod 2^32), then every thread may
// read what the signallers wrote before they signalled.
__device__ __forceinline__ void block_wait(const unsigned* f,
                                           unsigned target) {
  if (threadIdx.x == 0) spin_wait(f, target);
  __syncthreads();
}

// Block-wide: publish every thread's earlier writes, then add one to *f.
__device__ __forceinline__ void block_signal(unsigned* f) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(f, 1u);
}

// block_wait and block_signal for the `threads` threads of named barrier
// `bar` (this one is `tid`), in a warp-specialised block.
__device__ __forceinline__ void group_wait(const unsigned* f, unsigned target,
                                           int tid, int bar, int threads) {
  if (tid == 0) spin_wait(f, target);
  hopper::named_sync(bar, threads);
}

__device__ __forceinline__ void group_signal(unsigned* f, int tid, int bar,
                                             int threads) {
  __threadfence_system();
  hopper::named_sync(bar, threads);
  if (tid == 0) red_release_add(f, 1u);
}

// Blocks a virtual rank gets: what the card holds at once, shared by the
// ranks of the launch (a cooperative launch of more would be refused).
// Dynamic shared memory above 48 KB is allowed first, so that the
// occupancy counts what the launch will ask for.
template <typename K>
int grid_for(K kernel, int threads, int smem, int vranks, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms / vranks;
  return *blocks >= 2 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// One cooperative launch of `blocks` x `vranks` blocks of `threads` threads
// with `smem` bytes of dynamic shared memory; 0 or a cudaError.
template <typename K, typename Args>
int launch_coop(K kernel, Args& p, int blocks, int vranks, int threads, int smem,
                cudaStream_t s) {
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks, vranks), dim3(threads), args,
      smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace peer
