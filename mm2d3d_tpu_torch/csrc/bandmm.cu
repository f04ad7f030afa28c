// Slot-compacted sparse convolution apply (K1): a tiled gather-GEMM.
//
// Replaces the TPU kernel mm2d3d_tpu/ops/pallas/bandmm.py::_apply_kernel_t
// (with _build_e_t; called by slot_conv_apply -> _apply_pallas).
//
// What it computes:
//   out[v, :] = sum_h [0 <= tap[h, v] < K] x_src[h, v, :] @ W[tap[h, v]]
//             (+ xm[v, :] @ W[13] when the masked centre features are given)
// with x_src (H, V, Ci) the already-gathered slot rows, tap (H, V) int32 and
// W (K, Ci, Co); out (V, Co) is fp32 whatever the input type (fp32 or bf16).
// K = 27 for the submanifold 3^3 tiers, K = 8 with H = 1 for the strided
// down and up convolutions.  Any Ci (the Ci = 3 input convolution included).
//
// What bounds it on the H100: bytes and latency, not FLOPs.  At the flagship
// level 0 (V = 65,536, tier 1 with H = 3, Ci = Co = 16, bf16) one call does
// 65,536 * 4 * 16 * 16 * 2 = 134 MFLOP against ~8 MB of x_src/xm read and
// 4 MB of fp32 output: ~17 FLOP/byte, two orders of magnitude under the
// card's tensor-core ridge.  The TPU kernel's banded matrix E turns the 27
// tap products into one deep MXU contraction, but on this card it would be
// 27x zero work and 27x the bytes staged, so it is not carried over.
//
// What the design does about it: one block per tile of 16 voxels and up to
// 128 output channels.  For each slot the block stages the tile's 16 rows of
// x_src (converted to fp32) and their taps in shared memory with coalesced
// loads; each thread then owns one voxel and 8 output channels with the fp32
// accumulators in registers, and reads that voxel's W[tap] rows (consecutive
// output channels across the warp's lanes) through L1/L2 - the largest
// weight, (27, 192, 96) bf16, is ~1 MB and stays resident in the 50 MB L2.
// Empty slots skip their weight reads.  Tensor cores (wgmma), TMA and
// grouping voxels by tap are later work.
#include "common.cuh"

namespace {

constexpr int kVT = 16;   // voxels per block
constexpr int kCT = 16;   // threads along the output channels
constexpr int kCPT = 8;   // output channels per thread (stride kCT)
constexpr int kCenter = 13;

template <typename T>
__global__ void __launch_bounds__(kVT * kCT)
apply_kernel(const T* __restrict__ xm, const T* __restrict__ x_src,
             const int* __restrict__ tap, const T* __restrict__ w,
             float* __restrict__ out, int V, int H, int Ci, int Co, int K) {
  extern __shared__ float xs[];  // [kVT][Ci]
  __shared__ int tap_s[kVT];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCT + tx;
  const int v0 = blockIdx.x * kVT;
  const int co0 = blockIdx.y * (kCT * kCPT);
  const size_t nv = static_cast<size_t>(V);

  float acc[kCPT];
#pragma unroll
  for (int j = 0; j < kCPT; ++j) acc[j] = 0.f;

  const int n_stage = H + (xm != nullptr ? 1 : 0);
  for (int s = 0; s < n_stage; ++s) {
    const bool center = s == H;  // the centre band goes last
    const T* src = center ? xm : x_src + static_cast<size_t>(s) * nv * Ci;
    for (int i = tid; i < kVT * Ci; i += kVT * kCT) {
      const int r = i / Ci, c = i - r * Ci;
      const int vr = v0 + r;
      xs[i] = vr < V ? to_float(src[static_cast<size_t>(vr) * Ci + c]) : 0.f;
    }
    if (tid < kVT) {
      const int vr = v0 + tid;
      tap_s[tid] = vr >= V ? K : (center ? kCenter : tap[s * nv + vr]);
    }
    __syncthreads();
    const int t = tap_s[ty];
    if (t >= 0 && t < K) {
      const T* wt = w + static_cast<size_t>(t) * Ci * Co;
      const float* xr = xs + ty * Ci;
      for (int ci = 0; ci < Ci; ++ci) {
        const float xv = xr[ci];
        const T* wr = wt + static_cast<size_t>(ci) * Co;
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          const int co = co0 + tx + j * kCT;
          if (co < Co) acc[j] = fmaf(xv, to_float(wr[co]), acc[j]);
        }
      }
    }
    __syncthreads();
  }

  const int v = v0 + ty;
  if (v < V) {
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int co = co0 + tx + j * kCT;
      if (co < Co) out[static_cast<size_t>(v) * Co + co] = acc[j];
    }
  }
}

template <typename T>
int launch(const void* xm, const void* x_src, const void* tap, const void* w,
           void* out, int V, int H, int Ci, int Co, int K,
           cudaStream_t stream) {
  const dim3 block(kCT, kVT);
  const dim3 grid((V + kVT - 1) / kVT, (Co + kCT * kCPT - 1) / (kCT * kCPT));
  const size_t smem = static_cast<size_t>(kVT) * Ci * sizeof(float);
  if (V > 0) {
    apply_kernel<T><<<grid, block, smem, stream>>>(
        static_cast<const T*>(xm), static_cast<const T*>(x_src),
        static_cast<const int*>(tap), static_cast<const T*>(w),
        static_cast<float*>(out), V, H, Ci, Co, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xm (V, Ci) or null; x_src (H, V, Ci) or null (then H = 0); tap (H, V) int32;
// w (K, Ci, Co); out (V, Co) fp32.  dtype: 0 = fp32, 1 = bf16 (xm, x_src, w).
// Ci <= 512 (the staged tile is 16 * Ci fp32 of shared memory).
extern "C" int slot_conv_apply(const void* xm, const void* x_src,
                               const void* tap, const void* w, void* out,
                               int V, int H, int Ci, int Co, int K, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(xm, x_src, tap, w, out, V, H, Ci, Co, K, s);
  }
  return launch<float>(xm, x_src, tap, w, out, V, H, Ci, Co, K, s);
}
