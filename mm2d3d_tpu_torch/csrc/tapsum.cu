// Dense 27-tap contraction of the submanifold convolution (K6).
//
// Replaces the TPU kernel mm2d3d_tpu/ops/pallas/tapsum.py::_kernel
// (called by tapsum -> _tapsum_pallas).
//
// What it computes:
//   out[v, :] = sum_k g[k, v, :] @ w[k]        (K taps, here 27)
// with g (K, V, Ci) the gathered neighbourhood rows, w (K, Ci, Co) and out
// (V, Co) fp32 whatever the input type (fp32 or bf16).  Any V, Ci, Co.
// Seen as one matrix product: out = G @ W with G[v, k * Ci + ci] =
// g[k, v, ci] and W = w reshaped (K * Ci, Co), so the reduction runs over
// R = K * Ci rows and small Ci (the input conv's 3) wastes nothing.
//
// What bounds it on the H100: bytes.  At the flagship level 0 (V = 65,536,
// Ci = Co = 16, bf16) it reads 56.6 MB of g and writes 4.2 MB for
// 0.9 GFLOP: ~15 FLOP per byte, far under the tensor cores' ridge (~295);
// the HBM floor is ~18 us.  At the level-5 decoder concat (V = 4,096,
// Ci = 192, Co = 96) it reads 42 MB for 4.1 GFLOP (~100 FLOP/byte), still
// memory-side in bf16 but near the fp32 CUDA-core rate.
//
// What the design does about it: the TPU kernel kept all 27 taps' weights
// and a 512-row tile in VMEM (~1 MB at the L5 concat, over a block's
// 227 KB).  Here one block owns 32 voxels and 16 or 32 output channels
// (one warp per 8 channels) and walks the R reduction rows in stages of
// 32: each stage stages the tile's G rows (converted to fp32, transposed to
// [r][v] with a padded row, so both the staging stores and the reads are
// free of bank conflicts) and the matching 32 rows of W in shared memory,
// 6 KB at most.  Each staging thread keeps one reduction row of a stage, so
// its (tap, channel) split costs one division per stage.  Each thread owns
// one voxel and 8 output channels with the fp32 sums in registers: per
// reduction row, one read of G, two float4 reads of W (the same address
// across the warp: a broadcast) and 8 FMAs.  The small tile gives the grid
// ~15 blocks per SM at level 0 and still fills the card at the deep
// levels (V = 2,048-4,096); measured against 64- and 128-voxel tiles, it
// was the fastest at all five flagship shapes.  The g tensor is read once,
// coalesced along (tap, channel); W comes from L2.  Tensor cores (mma /
// wgmma), TMA and the gather inside the kernel are later work.
#include "common.cuh"

namespace {

constexpr int kBV = 32;   // voxels per block: one per lane
constexpr int kRC = 32;   // reduction rows per stage
constexpr int kCPT = 8;   // output channels per thread (one warp per group)

template <typename T, int kBC>
__global__ void __launch_bounds__(32 * (kBC / kCPT))
tapsum_kernel(const T* __restrict__ g, const T* __restrict__ w,
              float* __restrict__ out, int K, int V, int Ci, int Co) {
  constexpr int kThreads = 32 * (kBC / kCPT);
  constexpr int kVStep = kThreads / kRC;
  __shared__ float gs[kRC][kBV + 1];
  __shared__ __align__(16) float ws[kRC][kBC];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = tid >> 5;
  const int v0 = blockIdx.x * kBV;
  const int co0 = blockIdx.y * kBC;
  const int R = K * Ci;
  const size_t plane = static_cast<size_t>(V) * Ci;
  // staging: this thread's reduction row of each stage, and its voxels
  const int rl_s = tid % kRC;
  const int vl_s = tid / kRC;

  float acc[kCPT];
#pragma unroll
  for (int j = 0; j < kCPT; ++j) acc[j] = 0.f;

  for (int r0 = 0; r0 < R; r0 += kRC) {
    // G[v0 : v0 + kBV, r0 : r0 + kRC] (G[v, k * Ci + ci] = g[k, v, ci]):
    // consecutive lanes read consecutive channels of one voxel's taps
    const int r = r0 + rl_s;
    const int k = r < R ? r / Ci : 0;
    const T* src = g + k * plane + (r - k * Ci);
#pragma unroll
    for (int vl = vl_s; vl < kBV; vl += kVStep) {
      const int v = v0 + vl;
      gs[rl_s][vl] = (r < R && v < V)
                         ? to_float(src[static_cast<size_t>(v) * Ci]) : 0.f;
    }
    for (int e = tid; e < kRC * kBC; e += kThreads) {
      const int rl = e / kBC, cl = e - rl * kBC;
      const int rw = r0 + rl, co = co0 + cl;
      ws[rl][cl] = (rw < R && co < Co)
                       ? to_float(w[static_cast<size_t>(rw) * Co + co]) : 0.f;
    }
    __syncthreads();
    const int nr = min(kRC, R - r0);
    for (int rl = 0; rl < nr; ++rl) {
      const float xv = gs[rl][lane];
      const float4 wa = *reinterpret_cast<const float4*>(&ws[rl][cg * kCPT]);
      const float4 wb = *reinterpret_cast<const float4*>(&ws[rl][cg * kCPT + 4]);
      const float wv[kCPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < kCPT; ++j) acc[j] = fmaf(xv, wv[j], acc[j]);
    }
    __syncthreads();
  }

  const int v = v0 + lane;
  if (v < V) {
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int co = co0 + cg * kCPT + j;
      if (co < Co) out[static_cast<size_t>(v) * Co + co] = acc[j];
    }
  }
}

template <typename T, int kBC>
void launch_bc(const void* g, const void* w, void* out, int K, int V, int Ci,
               int Co, cudaStream_t stream) {
  const dim3 grid((V + kBV - 1) / kBV, (Co + kBC - 1) / kBC);
  tapsum_kernel<T, kBC><<<grid, 32 * (kBC / kCPT), 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<float*>(out), K, V, Ci, Co);
}

template <typename T>
int launch(const void* g, const void* w, void* out, int K, int V, int Ci,
           int Co, cudaStream_t stream) {
  if (V > 0 && Co > 0) {
    // 16-channel blocks where Co <= 16 (the level-0 convs), so no thread
    // sums zero weights there; 32-channel blocks elsewhere
    if (Co <= 16) {
      launch_bc<T, 16>(g, w, out, K, V, Ci, Co, stream);
    } else {
      launch_bc<T, 32>(g, w, out, K, V, Ci, Co, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (K, V, Ci), w (K, Ci, Co) in fp32 (dtype 0) or bf16 (dtype 1);
// out (V, Co) fp32.  Returns cudaGetLastError().
extern "C" int tapsum(const void* g, const void* w, void* out, int K, int V,
                      int Ci, int Co, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(g, w, out, K, V, Ci, Co, s);
  }
  return launch<float>(g, w, out, K, V, Ci, Co, s);
}
