// Asynchronous copies from device memory into shared memory, shared by the
// recurrence (lstm_common.cuh) and CTC (ctc_common.cuh) kernels: cp.async
// by thread, grouped by commit and waited for by group; and the bulk copy
// (the TMA unit moves a contiguous run, issued by one thread), which reports
// its bytes to an mbarrier in shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 and 8 bytes (through L1: only for data no block writes
// during the launch) and of 16 bytes at L2 only.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An mbarrier (8 bytes of shared memory): init by one thread with the
// count of arrivals a phase needs (then fence.mbarrier_init and a block
// sync before any use); arrive with the bytes the phase's bulk copies will
// deliver; wait for the completion of the phase of parity `parity` (a
// barrier's k-th phase, from 0, has parity k & 1).
__device__ __forceinline__ void mbar_init(void* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(void* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(void* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; src and dst 16-byte aligned) from device
// memory into shared memory by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
