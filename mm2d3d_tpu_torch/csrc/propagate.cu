// Octree neighbour propagation + tier-1 slot build (K3), one thread per voxel.
//
// Replaces the TPU kernel mm2d3d_tpu/ops/pallas/propagate.py::_prop_kernel
// (called by propagate_slots_kernel from hierarchy.propagate_nbr_slots).
//
// What it computes, per fine voxel v (V is the minor axis of every array):
//   for each tap k of the 3x3x3 stencil in ascending order:
//     nbr[k, v] = the candidate picked from the 8x8 gathered child-table rows
//                 crows[blk, slot, v] by the voxel's coordinate parity
//                 (k = 13, the centre, is v itself or the miss V if invalid);
//     the first h1 off-centre hits go to src1/tap1 in ascending-k order;
//   cnt[v] counts every off-centre hit.  Misses: src V, tap 27.
//
// What bounds it on the H100: bytes.  At the flagship level 0 (V = 65,536)
// it reads 64 candidate ints + 4 per voxel (~17.8 MB) and writes 27 + 2*h1 + 1
// ints (~8.9 MB at h1 = 3); the select network is a few hundred integer ops
// per voxel, far under the card's integer rate.  At 3.35 TB/s that is about
// 8 us.
//
// What the design does about it: one thread per voxel, so every load and
// store of a warp touches 32 consecutive ints of one row (fully coalesced,
// because V is the minor axis).  The parity select is resolved into a single
// index per tap, so each tap reads exactly one candidate instead of the 8 the
// TPU's vector select tree read.  Slots are written directly to their rows;
// no shared memory, no synchronisation.
#include "common.cuh"

namespace {

__device__ __forceinline__ void axis_sel(int d, int p, int& a, int& s) {
  // per-axis (parent-block index a, child slot s) for tap offset d
  // (mirrors hierarchy._axis_sel)
  a = d == -1 ? 0 : (d == 1 ? 1 : 1 - p);
  s = d == 0 ? p : 1 - p;
}

__global__ void propagate_kernel(const int* __restrict__ crows,
                                 const int* __restrict__ par,
                                 const int* __restrict__ valid,
                                 int* __restrict__ nbr, int* __restrict__ src1,
                                 int* __restrict__ tap1, int* __restrict__ cnt,
                                 int V, int h1) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const size_t n = static_cast<size_t>(V);
  const int px = par[v] == 1, py = par[n + v] == 1, pz = par[2 * n + v] == 1;
  for (int h = 0; h < h1; ++h) {
    src1[h * n + v] = V;
    tap1[h * n + v] = 27;
  }
  int c = 0;
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    if (k == 13) {
      nbr[13 * n + v] = valid[v] != 0 ? v : V;
      continue;
    }
    int ax, sx, ay, sy, az, sz;
    axis_sel(k / 9 - 1, px, ax, sx);
    axis_sel((k / 3) % 3 - 1, py, ay, sy);
    axis_sel(k % 3 - 1, pz, az, sz);
    const int row = (ax * 4 + ay * 2 + az) * 8 + (sx * 4 + sy * 2 + sz);
    const int col = crows[row * n + v];
    nbr[k * n + v] = col;
    if (col != V) {
      if (c < h1) {
        src1[c * n + v] = col;
        tap1[c * n + v] = k;
      }
      ++c;
    }
  }
  cnt[v] = c;
}

}  // namespace

// crows (8, 8, V), par (3, V), valid (V,) int32 -> nbr (27, V),
// src1 (h1, V), tap1 (h1, V), cnt (V,) int32.  Returns cudaGetLastError().
extern "C" int propagate_slots(const void* crows, const void* par,
                               const void* valid, void* nbr, void* src1,
                               void* tap1, void* cnt, int V, int h1,
                               void* stream) {
  const int threads = 256;
  const int blocks = (V + threads - 1) / threads;
  if (blocks > 0) {
    propagate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(crows), static_cast<const int*>(par),
        static_cast<const int*>(valid), static_cast<int*>(nbr),
        static_cast<int*>(src1), static_cast<int*>(tap1),
        static_cast<int*>(cnt), V, h1);
  }
  return static_cast<int>(cudaGetLastError());
}
