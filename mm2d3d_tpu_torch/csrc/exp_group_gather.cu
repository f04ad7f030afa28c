// Row-group gather (K7), a probe of how fast the card gathers slot rows.
//
// Replaces the TPU probe kernel tools/exp_dma_gather.py::make_grp.kern
// (one `pltpu.make_async_copy` per 8-row group, started all at once and
// waited on one DMA semaphore; 8 rows were the finest grain Mosaic could
// address).
//
// What it computes, for output tile j < n / T, slot h < H, t < T, r < G:
//   out[((j * H + h) * T + t) * G + r] = x[idx[h, j * T + t] * G + r]
// with x (N, C) viewed as N / G groups of G rows, idx (H, n) int32 group
// ids and out (n / T * H * T * G, C).  A group id outside [0, N / G) gives
// G rows of zeros (the plain version states the same).  G is a parameter:
// 8 is the TPU's grain, 1 is a per-row gather, which Mosaic could not
// express.  The kernel copies bytes: any type whose group is a multiple of
// 16 bytes.
//
// What bounds it on the H100: bytes (every byte read once, written once,
// no arithmetic).  Design: each thread copies U 16-byte chunks of the
// output, consecutive threads on consecutive chunks, with cp.async
// global -> shared (the counterpart of the TPU's async copy; the chunks
// of one group are contiguous in x), waits on its own copies and stores
// them out with 16-byte stores, so both sides are coalesced within a
// group.  One block per 256 * U chunks; many blocks in flight keep the
// copies overlapped.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte chunks per thread

__global__ void __launch_bounds__(kThreads)
group_gather_kernel(const unsigned char* __restrict__ x, const int* __restrict__ idx,
                    unsigned char* __restrict__ out, long long n_groups, int H,
                    int n, int T, int group_bytes, long long n_chunks) {
  __shared__ __align__(16) int4 buf[kUnroll * kThreads];
  const int cpg = group_bytes / 16;  // chunks per group
  const long long ht = static_cast<long long>(H) * T;
  const long long base = static_cast<long long>(blockIdx.x) * kUnroll * kThreads;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = base + u * kThreads + threadIdx.x;
    if (e >= n_chunks) break;
    const long long q = e / cpg;  // output group
    const int c = static_cast<int>(e - q * cpg);
    const long long j = q / ht;
    const int rem = static_cast<int>(q - j * ht);
    const int h = rem / T, t = rem - h * T;
    const long long g = idx[static_cast<long long>(h) * n + j * T + t];
    const bool ok = g >= 0 && g < n_groups;
    const unsigned char* src = ok ? x + g * group_bytes + c * 16 : x;
    cp_async16(&buf[u * kThreads + threadIdx.x], src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();  // this thread's own copies have landed
  int4* dst = reinterpret_cast<int4*>(out);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = base + u * kThreads + threadIdx.x;
    if (e >= n_chunks) break;
    dst[e] = buf[u * kThreads + threadIdx.x];
  }
}

}  // namespace

// x (N, C) of any type, N = n_groups * G rows; idx (H, n) int32, n a
// multiple of T; out (n / T * H * T * G, C).  group_bytes = G * C * the
// element size, a multiple of 16; x and out 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int group_gather(const void* x, const void* idx, void* out,
                            long long n_groups, int H, int n, int T,
                            int group_bytes, void* stream) {
  if (group_bytes <= 0 || group_bytes % 16 != 0 || T <= 0 || n % T != 0 || H < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_chunks =
      static_cast<long long>(n) * H * (group_bytes / 16);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  const long long per_block = static_cast<long long>(kUnroll) * kThreads;
  const unsigned grid = static_cast<unsigned>((n_chunks + per_block - 1) / per_block);
  group_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<const int*>(idx),
      static_cast<unsigned char*>(out), n_groups, H, n, T, group_bytes, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
