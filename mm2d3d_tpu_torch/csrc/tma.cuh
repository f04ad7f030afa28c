// Two-dimensional tensor copies global -> shared (the Tensor Memory
// Accelerator's tiled mode) completed on an mbarrier transaction count.
// The host encodes a CUtensorMap with libcuda's cuTensorMapEncodeTiled,
// fetched through the runtime so that no library links against libcuda;
// the kernel takes the map as a __grid_constant__ parameter.  Used by K10
// (exp_bandmm.cu).
//
// A copy moves one box of the map into shared memory, rows of the box one
// after another; with CU_TENSOR_MAP_SWIZZLE_128B (box rows of at most 128
// bytes) the 16-byte chunk c of box row r lands at chunk c ^ (r % 8) of its
// row, so a 1024-byte aligned destination gives eight rows read at one
// logical chunk eight distinct banks.  Elements past the tensor's end are
// filled with zeros, and the transaction count is always the whole box.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null where the runtime cannot find
// it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over `rows` rows of `cols` elements, `row_bytes` apart (a
// multiple of 16), copied in boxes of (box_cols, box_rows).
inline bool tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                          uint64_t cols, uint64_t rows, uint64_t row_bytes, uint32_t box_cols,
                          uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the box at element (c0, row c1) of `map` into `dst` (128-byte aligned;
// 1024 with the 128-byte swizzle), completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
