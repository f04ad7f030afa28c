// 3x3, stride-2, pad-1 max pool over NHWC (K4): the ResNet stem pool.
//
// Replaces the TPU kernel mm2d3d_tpu/ops/pallas/maxpool.py::_kernel (called
// by maxpool3x3s2 -> _pool_pallas).  Semantics of torch MaxPool2d(3, 2, 1):
// out[b, i, j, c] = max over rows 2i-1..2i+1 and columns 2j-1..2j+1 of the
// input, padding as -inf; Ho = ceil(H / 2), Wo = ceil(W / 2).  Ties keep the
// first element in row-major window order and a NaN wins, as torch's kernel
// does, so the result is bit-identical to F.max_pool2d in fp32 and bf16.
//
// What bounds it on the H100: bytes.  At the flagship stem output,
// (8, 240, 400, 64) read once and (8, 120, 200, 64) written, that is 197 MB
// + 49 MB in fp32 (98 + 25 MB in bf16): ~73 us (37 us) at 3.35 TB/s.  The nine
// window reads per output overlap 2.25x, and those repeats are served by
// L1/L2, not device memory.
//
// What the design does about it: one thread per output pixel and 8 channels
// (channels are the minor axis), loaded as 16-byte vectors - one for bf16,
// two for fp32 - so a warp reads 512 (1,024) contiguous bytes per window
// element.  The whole pool is one pass; the TPU kernel left its W stage to
// XLA.  The channel count must be a multiple of 8 and both pointers 16-byte
// aligned (the stem gives C = 64 in a fresh allocation); the Python wrapper
// refuses anything else.
#include "common.cuh"

#include <math_constants.h>

namespace {

// CPT values of type T held as whole 16-byte words, for vector loads/stores
template <typename T, int CPT>
struct Pack {
  static_assert(sizeof(T) * CPT % 16 == 0, "pack must be whole 16-byte words");
  static constexpr int kWords = sizeof(T) * CPT / 16;
  uint4 u[kWords];
  __device__ __forceinline__ T* v() { return reinterpret_cast<T*>(u); }
};

template <typename T>
__device__ __forceinline__ void take_max(T cand, float& m, T& best) {
  const float f = to_float(cand);
  if (f > m || isnan(f)) {
    m = f;
    best = cand;
  }
}

template <typename T, int CPT>
__global__ void maxpool_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int B, int H, int W, int C, int Ho, int Wo) {
  const int groups = C / CPT;
  const size_t total = static_cast<size_t>(B) * Ho * Wo * groups;
  const size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (idx >= total) return;
  const int g = idx % groups;
  size_t r = idx / groups;
  const int wo = r % Wo;
  r /= Wo;
  const int ho = r % Ho;
  const int b = r / Ho;

  float m[CPT];
  Pack<T, CPT> best;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    m[j] = -CUDART_INF_F;
    best.v()[j] = from_float<T>(-CUDART_INF_F);
  }
  for (int dh = 0; dh < 3; ++dh) {
    const int h = 2 * ho - 1 + dh;
    if (h < 0 || h >= H) continue;
    for (int dw = 0; dw < 3; ++dw) {
      const int w = 2 * wo - 1 + dw;
      if (w < 0 || w >= W) continue;
      const size_t off = ((static_cast<size_t>(b) * H + h) * W + w) * C + g * CPT;
      Pack<T, CPT> in;
      const uint4* p = reinterpret_cast<const uint4*>(x + off);
#pragma unroll
      for (int q = 0; q < Pack<T, CPT>::kWords; ++q) in.u[q] = p[q];
#pragma unroll
      for (int j = 0; j < CPT; ++j) take_max(in.v()[j], m[j], best.v()[j]);
    }
  }
  const size_t out = ((static_cast<size_t>(b) * Ho + ho) * Wo + wo) * C + g * CPT;
  uint4* q = reinterpret_cast<uint4*>(y + out);
#pragma unroll
  for (int w = 0; w < Pack<T, CPT>::kWords; ++w) q[w] = best.u[w];
}

template <typename T>
int launch(const void* x, void* y, int B, int H, int W, int C,
           cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int threads = 256;
  const size_t n = static_cast<size_t>(B) * Ho * Wo * (C / 8);
  if (n > 0) {
    maxpool_kernel<T, 8><<<(n + threads - 1) / threads, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), B, H, W, C, Ho, Wo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, C) -> y (B, ceil(H/2), ceil(W/2), C), both NHWC-contiguous.
// dtype: 0 = fp32, 1 = bf16.  Requires C % 8 == 0 and 16-byte aligned
// pointers (checked by the Python wrapper).
extern "C" int maxpool3x3s2(const void* x, void* y, int B, int H, int W, int C,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(x, y, B, H, W, C, s);
  }
  return launch<float>(x, y, B, H, W, C, s);
}
