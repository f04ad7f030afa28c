// Slot-compacted sparse convolution weight gradient (K2): a deterministic
// two-pass reduction over chunks of voxels.
//
// Replaces the TPU kernel mm2d3d_tpu/ops/pallas/bandmm.py::_dw_kernel_t
// (with _build_e_t; called by slot_conv_dw -> _dw_pallas).
//
// What it computes:
//   dW[k, ci, co] = sum_{h, v : tap[h, v] == k} x_src[h, v, ci] * g[v, co]
//                   (+ sum_v xm[v, ci] * g[v, co] into k = 13 when the masked
//                    centre features are given)
// with x_src (H, V, Ci) the gathered slot rows, tap (H, V) int32 (K marks an
// empty slot), g (V, Co) the output gradient at the same rows; dW (K, Ci, Co)
// is fp32 whatever the input type (fp32 or bf16).  K = 27 for the
// submanifold tiers, K = 8 with H = 1 for the strided convolutions.
//
// The TPU kernel builds the banded matrix E (V, K * Ci) tile by tile and
// accumulates E^T @ g over the sequential grid.  On this card E would be 27x
// zero work, and blocks run in parallel with nothing carried between them,
// so the port computes the function directly and reduces across blocks in a
// second pass instead of with float atomics: two calls on the same inputs
// give the same bits.
//
// What bounds it: latency, not bytes or FLOPs.  At the flagship level 0
// (V = 65,536, tier 1 with H = 3 plus the centre, Ci = Co = 16) one call is
// 67 M multiply-adds over ~10 MB of input.  Each multiply-add lands on a
// dynamically chosen tap k, so the accumulators cannot stay in registers.
//
// Design: pass 1 gives each block a chunk of voxel rows and a tile of
// (ci, co) pairs, one pair per thread (co the fast index).  Each thread keeps
// its pair's K fp32 sums in shared memory at acc[k][thread], a slot no other
// thread touches.  The block walks its chunk kRows rows at a time: it stages
// the rows' taps, their x_src / xm values for its ci tile and their g values
// for its co tile in shared memory with coalesced loads, then every thread
// accumulates from shared memory, rows in order, slots in order, the centre
// last.  It writes its K sums to a per-chunk workspace (n_chunks, K, Ci,
// Co).  Pass 2 sums the chunks of each output element in chunk order.
// Tensor cores, TMA and a tap-sorted layout are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // voxel rows staged per step
constexpr int kCenter = 13;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const T* __restrict__ xm, const T* __restrict__ x_src,
                  const int* __restrict__ tap, const T* __restrict__ g,
                  float* __restrict__ partial, int V, int H, int Ci, int Co,
                  int K, int co_tile, int rows_per_chunk) {
  const int ci_tile = kThreads / co_tile;
  const int n_slot = H + (xm != nullptr ? 1 : 0);  // the centre is slot H
  extern __shared__ float smem[];
  float* acc = smem;                          // [K][kThreads]
  float* xs = acc + K * kThreads;             // [n_slot][kRows][ci_tile]
  float* gs = xs + n_slot * kRows * ci_tile;  // [kRows][co_tile]
  int* ts = reinterpret_cast<int*>(gs + kRows * co_tile);  // [n_slot][kRows]

  const int tid = threadIdx.x;
  const int ci_l = tid / co_tile, co_l = tid % co_tile;
  const int ci0 = blockIdx.y * ci_tile, co0 = blockIdx.z * co_tile;
  const bool active = ci0 + ci_l < Ci && co0 + co_l < Co;
  for (int k = 0; k < K; ++k) acc[k * kThreads + tid] = 0.f;

  const size_t nv = static_cast<size_t>(V);
  const int v0 = blockIdx.x * rows_per_chunk;
  const int v1 = min(V, v0 + rows_per_chunk);
  for (int vb = v0; vb < v1; vb += kRows) {
    const int nr = min(kRows, v1 - vb);
    __syncthreads();  // the previous rows are consumed
    for (int i = tid; i < n_slot * kRows; i += kThreads) {
      const int s = i / kRows, r = i - s * kRows;
      ts[i] = r >= nr ? K
              : (s == H ? kCenter : tap[static_cast<size_t>(s) * nv + vb + r]);
    }
    for (int i = tid; i < n_slot * kRows * ci_tile; i += kThreads) {
      const int c = i % ci_tile, sr = i / ci_tile;
      const int s = sr / kRows, r = sr - s * kRows;
      const int cc = ci0 + c;
      float x = 0.f;
      if (r < nr && cc < Ci) {
        const size_t row = s == H ? static_cast<size_t>(vb + r)
                                  : static_cast<size_t>(s) * nv + vb + r;
        x = to_float((s == H ? xm : x_src)[row * Ci + cc]);
      }
      xs[i] = x;
    }
    for (int i = tid; i < kRows * co_tile; i += kThreads) {
      const int r = i / co_tile, cc = co0 + i % co_tile;
      gs[i] = r < nr && cc < Co
                  ? to_float(g[static_cast<size_t>(vb + r) * Co + cc]) : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int r = 0; r < nr; ++r) {
        const float gv = gs[r * co_tile + co_l];
        for (int s = 0; s < n_slot; ++s) {
          const int t = ts[s * kRows + r];
          if (t >= 0 && t < K) {
            float& a = acc[t * kThreads + tid];
            a = fmaf(xs[(s * kRows + r) * ci_tile + ci_l], gv, a);
          }
        }
      }
    }
  }

  if (active) {
    const int ci = ci0 + ci_l, co = co0 + co_l;
    float* out = partial + static_cast<size_t>(blockIdx.x) * K * Ci * Co;
    for (int k = 0; k < K; ++k) {
      out[(static_cast<size_t>(k) * Ci + ci) * Co + co] = acc[k * kThreads + tid];
    }
  }
}

// out[i] = sum over chunks c, in order, of partial[c][i]
__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int n_chunks,
                                 size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[static_cast<size_t>(c) * n + i];
  out[i] = s;
}

template <typename T>
int launch(const void* xm, const void* x_src, const void* tap, const void* g,
           void* partial, void* out, int V, int H, int Ci, int Co, int K,
           int co_tile, int rows_per_chunk, int n_chunks,
           cudaStream_t stream) {
  if (n_chunks > 0) {
    const int ci_tile = kThreads / co_tile;
    const dim3 grid(n_chunks, (Ci + ci_tile - 1) / ci_tile,
                    (Co + co_tile - 1) / co_tile);
    const int n_slot = H + (xm != nullptr ? 1 : 0);
    const size_t smem =
        (static_cast<size_t>(K) * kThreads + n_slot * kRows * ci_tile +
         kRows * co_tile + n_slot * kRows) * sizeof(float);
    dw_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(xm), static_cast<const T*>(x_src),
        static_cast<const int*>(tap), static_cast<const T*>(g),
        static_cast<float*>(partial), V, H, Ci, Co, K, co_tile,
        rows_per_chunk);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  const size_t n = static_cast<size_t>(K) * Ci * Co;
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    dw_reduce_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), n_chunks,
        n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xm (V, Ci) or null; x_src (H, V, Ci) or null (then H = 0); tap (H, V)
// int32; g (V, Co); partial (n_chunks, K, Ci, Co) fp32 scratch; out
// (K, Ci, Co) fp32.  dtype: 0 = fp32, 1 = bf16 (xm, x_src, g).  co_tile is
// 16 or 32 (threads along Co per block); chunk c covers rows
// [c * rows_per_chunk, min(V, (c + 1) * rows_per_chunk)).  Shared memory
// per block: K KB of sums plus the staged rows, at most 42 KB for K = 27
// and H <= 26, under the 48 KB a launch gets without opting in.
extern "C" int slot_conv_dw(const void* xm, const void* x_src, const void* tap,
                            const void* g, void* partial, void* out, int V,
                            int H, int Ci, int Co, int K, int co_tile,
                            int rows_per_chunk, int n_chunks, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(xm, x_src, tap, g, partial, out, V, H, Ci, Co,
                                 K, co_tile, rows_per_chunk, n_chunks, s);
  }
  return launch<float>(xm, x_src, tap, g, partial, out, V, H, Ci, Co, K,
                       co_tile, rows_per_chunk, n_chunks, s);
}
