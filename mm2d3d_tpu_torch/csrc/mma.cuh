// Tensor-core building blocks shared by the bf16 kernels (K5, K6):
// cp.async copies into shared memory, ldmatrix, and the m16n8k16 bf16 mma
// with fp32 sums.  sm_80 instructions, all available on sm_90a.
//
// Fragment layout of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//                           a2 = A[g][2t+8..],   a3 = A[g+8][2t+8..]
//   B (16 x 8):             b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..]
// `ldmatrix_x4` with lane l pointing at row (l % 16), column (l / 16) * 8 of
// a 16 x 16 bf16 tile gives a0..a3 of A; `ldmatrix_x4_trans` with the same
// addressing on a row-major [k][n] tile gives (b0, b1) of the n-tile at
// columns 0-7 and (b0, b1) of the n-tile at columns 8-15.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; zero-fills the 16 bytes when !pred (no
// bytes are read then, but `src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a @ b on one 16 x 8 tile, bf16 inputs, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (round to nearest even), x low
__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}
