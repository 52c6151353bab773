// Hand-offs between CTAs of one launch through counters in device memory,
// shared by csrc/rho_mid.cu (the replay role's ring of iterates) and
// csrc/streamk_mid.cu (the 'helpers' schedule's rings of H and of pairs):
// one thread of a CTA waits until a count is reached (wait_count; a barrier
// of the CTA after it shows what the counted CTAs published to all its
// threads), another publishes its CTA's writes, or its finished reads, by
// adding one (signal_count, after a barrier of the CTA). The CTAs counted
// are running, so a wait takes at most about a step; one past WAIT_LIMIT_NS
// traps, so that a fault of a hand-off fails the launch instead of holding
// the card.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr unsigned long long WAIT_LIMIT_NS = 20000000000ull;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void wait_count(const int* p, int target) {
  if (ld_acquire(p) >= target) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(p) < target) {
    __nanosleep(64);
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

__device__ __forceinline__ void signal_count(int* p) {
  __threadfence();
  atomicAdd(p, 1);
}

}  // namespace
