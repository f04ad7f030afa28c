// Bulk asynchronous copies global -> shared (sm_90's cp.async.bulk, the
// one-dimensional form of the Tensor Memory Accelerator) completed on an
// mbarrier transaction count: the Hopper counterpart of one
// `pltpu.make_async_copy` descriptor and its DMA semaphore.  Shared by the
// window kernels K8 (exp_window_copy.cu) and K9 (exp_window_gather.cu) and
// by K10 (exp_bandmm.cu: W and its ring's barriers).
//
// A copy moves a multiple of 16 bytes between 16-byte aligned addresses;
// one barrier phase counts at most 2^20 - 1 bytes, more than a block's
// shared memory holds.
#pragma once

#include <cstdint>

#include "mma.cuh"

constexpr int kMaxSmemBytes = 232448;  // 227 KB: a block's opt-in shared memory
// the dynamic shared memory a bulk buffer may take, beside a block's static
// barriers
constexpr int kMaxBulkBytes = kMaxSmemBytes - 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
  // make the initialised barrier visible to the async proxy
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` more of transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// arrive once, with no transactions (release: this thread's earlier
// shared-memory writes and reads are ordered before the phase completes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Thread 0 copies `bytes` (a multiple of 16, at most kMaxBulkBytes: one
// barrier phase) from global `src` into shared `dst` as one bulk copy;
// every thread of the block returns once it has landed.  `bar` is
// initialised here.  Call it from every thread of the block, once per
// barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, bytes);
    bulk_copy_g2s(dst, src, bytes, bar);
  }
  mbar_wait(bar, 0);
}
