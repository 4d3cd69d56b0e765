// Hopper's asynchronous copies from global into shared memory, completing
// on one mbarrier (sm_90; PTX ISA "cp.async.bulk", "cp.async",
// "mbarrier"). Used by the microbenchmark X5 (exp_smem_tables.cu).
//
// The barrier's phase completes when every expected arrival has come and
// its transaction count is back to zero:
//   - `mbar_arrive_expect_tx` arrives once and adds the bytes the bulk
//     copies will bring; each `bulk_g2s` (cp.async.bulk, 16-byte aligned
//     source and destination, a multiple of 16 bytes) takes its bytes off
//     when they land;
//   - `cp_async16` / `cp_async4` (cp.async of 16 or 4 bytes, through L1)
//     are tracked per thread: `cp_async_arrive_noinc` makes the barrier
//     receive one arrival from this thread once all of its earlier cp.async
//     copies have landed (.noinc: the arrival is one of those counted at
//     `mbar_init`).
// A thread that sees the phase complete (`mbar_wait`) sees every byte.
#pragma once

#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One thread initialises the barrier for `count` arrivals; the block then
// synchronises before any thread uses it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Through L1 (.ca, not .cg): every block stages the same tables, and from
// L1 the blocks on an SM share them; from L2 each block's copy costs its SM
// about 1.1 us at X5's K1 shape (PERF.md §6, X5).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

}  // namespace ptx
