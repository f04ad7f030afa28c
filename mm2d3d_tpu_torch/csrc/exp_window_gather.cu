// Gather from a resident window (K9), a probe of row selection out of
// on-chip memory.
//
// Replaces the TPU probe kernel tools/exp_dma_gather.py::make_onehot.
// onehot_kernel (rows selected from a VMEM-resident (w, Ci) window by a
// (T, w) one-hot @ (w, Ci) product: Mosaic has no dynamic row select).
//
// What it computes: out[q] = xw[idx[q]] for every entry q of idx (H, V)
// int32 local row ids, with xw (w, C) of any type and out (H, V, C); an id
// outside [0, w) gives a row of zeros (the plain version states the same).
// A bf16 one-hot product selects exactly, so this is bit-equal to the TPU
// kernel's result where every id is in range.
//
// What bounds it on the H100: bytes (idx read once, out written once, the
// window once).  Design: a thread-block cluster of 2 or 4 CTAs, one CTA per
// SM, shares one window by multicast: CTA r loads rows [r * S, (r + 1) * S)
// once from L2 and one cp.async.bulk .multicast::cluster lands them in every
// CTA of the cluster, each CTA's barrier counting the whole window, so the
// cluster reads the window from L2 once and every CTA then gathers from its
// own shared memory.  (The other form, the window sharded over the cluster
// and read through distributed shared memory, ran slower at every probe
// case, a half or three quarters of its reads being remote; it is not
// kept.)
//   - The CTA's first ids are asked for before the window, from global
//     memory, one load per row (the lanes of a row read one address).
//   - Each warp owns whole rows: a step of the warp covers 32 / (row bytes /
//     16) rows, lane l on 16-byte chunk l % chunks of row l / chunks (both
//     divisions once per thread), so the warp's 16-byte stores are one
//     contiguous range of out.  Every lane keeps kUnroll rows in flight and
//     the next step's ids loading while it copies.  32-bit index math.
//   - The grid: a whole number of clusters, at most one CTA per SM and no
//     more clusters than the card holds at once (no second wave), each CTA
//     a contiguous range of rows; a CTA whose range is empty still loads
//     its part of the window for the others.
//   - Cluster barriers: one after the barriers are initialised (before any
//     copy can land), and a split one whose arrive follows the CTA's window
//     and whose wait ends the kernel, so that no CTA leaves while a copy it
//     issued may still be landing elsewhere.
#include <cooperative_groups.h>

#include "common.cuh"
#include "bulk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

// cp.async.bulk of `bytes` into `dst` of every CTA in `mask`, each copy
// completing on the barrier at `bar`'s offset in its own CTA
__device__ __forceinline__ void bulk_copy_g2s_multicast(void* dst, const void* src,
                                                        unsigned bytes, uint64_t* bar,
                                                        uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
window_gather_kernel(const unsigned char* __restrict__ xw, const int* __restrict__ idx,
                     unsigned char* __restrict__ out, int w, int row_bytes, int rows,
                     int rows_per_cta, int part_rows) {
  extern __shared__ __align__(128) unsigned char win[];
  __shared__ __align__(8) uint64_t bar;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n_ctas = static_cast<int>(cg::this_cluster().num_blocks());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const int q0 = static_cast<int>(first < rows ? first : rows);
  const int n = min(rows - q0, rows_per_cta);
  // each warp step covers rps whole rows; lane l takes chunk lc of row lr
  const int chunks = row_bytes >> 4;
  const int rps = chunks >= 32 ? 1 : 32 / chunks;
  const int lr = chunks >= 32 ? 0 : lane / chunks;
  const int lc = lane - lr * chunks;
  const int step = (kThreads / 32) * rps;
  const int* ids = idx + q0;
  // the first rows' ids are asked for before the window is
  int next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int row = warp * rps + u * step + lr;
    next[u] = row < n ? ids[row] : -1;
  }

  // 1. the window: this CTA's part, multicast to the whole cluster
  if (threadIdx.x == 0) mbar_init(&bar, 1);
  cluster_arrive_relaxed();  // every CTA's barrier is initialised before a copy lands
  cluster_wait();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, static_cast<unsigned>(w) * row_bytes);
    const int r0 = min(w, rank * part_rows), r1 = min(w, r0 + part_rows);
    if (r1 > r0) {
      bulk_copy_g2s_multicast(win + static_cast<size_t>(r0) * row_bytes,
                              xw + static_cast<size_t>(r0) * row_bytes,
                              static_cast<unsigned>(r1 - r0) * row_bytes, &bar,
                              static_cast<uint16_t>((1u << n_ctas) - 1));
    }
  }
  mbar_wait(&bar, 0);
  cluster_arrive_relaxed();  // this CTA's window is whole: nothing lands in it any more

  // 2. the rows, whole rows per warp step, the next step's ids in flight
  unsigned char* dst0 = out + static_cast<size_t>(q0) * row_bytes;
  for (int base = warp * rps; base < n; base += step * kUnroll) {
    int id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      id[u] = next[u];
      const int row = base + (kUnroll + u) * step + lr;
      next[u] = row < n ? ids[row] : -1;
    }
    for (int c = lc; c < chunks && lr < rps; c += 32) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = static_cast<unsigned>(id[u]) < static_cast<unsigned>(w)
                   ? *reinterpret_cast<const int4*>(win + id[u] * row_bytes + c * 16)
                   : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = base + u * step + lr;
        if (row < n) {
          *reinterpret_cast<int4*>(dst0 + static_cast<size_t>(row) * row_bytes + c * 16) = v[u];
        }
      }
    }
  }
  cluster_wait();  // every CTA's window is whole: no copy is still landing
}

}  // namespace

// xw (w, C), idx (rows,) int32, out (rows, C); row_bytes = C * the element
// size, a multiple of 16, w * row_bytes at most kMaxBulkBytes; xw and out
// 16-byte aligned.  `cluster` (2 or 4) CTAs share the window, CTA r
// multicasting rows [r * part_rows, (r + 1) * part_rows) (part_rows *
// cluster >= w); `ctas` (a multiple of `cluster`) from the wrapper's plan,
// cut to the clusters the card holds at once.  Returns
// cudaErrorInvalidValue for another plan, else the launch's
// cudaGetLastError().
extern "C" int window_gather(const void* xw, const void* idx, void* out, int w,
                             int row_bytes, int rows, int cluster, int ctas, int part_rows,
                             void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || w <= 0 || rows < 0 ||
      static_cast<long long>(w) * row_bytes > kMaxBulkBytes ||
      (cluster != 2 && cluster != 4) || ctas <= 0 || ctas % cluster != 0 ||
      part_rows <= 0 || static_cast<long long>(part_rows) * cluster < w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      window_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBulkBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(w) * row_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  int active = 0;  // no more clusters than the card holds at once: no second wave
  if (cudaOccupancyMaxActiveClusters(&active, window_gather_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a query that failed leaves the plan as it is, and its error
  } else if (active > 0 && active * cluster < ctas) {
    ctas = active * cluster;
    cfg.gridDim = dim3(ctas);
  }
  const int per_cta = static_cast<int>((rows + ctas - 1) / ctas);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, window_gather_kernel, static_cast<const unsigned char*>(xw),
      static_cast<const int*>(idx), static_cast<unsigned char*>(out), w, row_bytes, rows,
      per_cta, part_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
