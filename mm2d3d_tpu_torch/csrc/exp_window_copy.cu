// Contiguous window copy (K8), a probe of the transfer a window-based
// gather design would ride.
//
// Replaces the TPU probe kernel tools/exp_dma_gather.py::make_win.kern
// (one `pltpu.make_async_copy` of a w-row window HBM -> VMEM per grid step,
// started and waited on at once).
//
// What it computes: out[j] = x[offs[j] : offs[j] + w] for each window j,
// with x (V, C) of any type, offs (n,) int32 and out (n, w, C).  A window
// that does not lie inside x (offs[j] < 0 or offs[j] + w > V) gives w rows
// of zeros (the plain version states the same).
//
// What bounds it on the H100: bytes (each window read once and written
// once).  Design: each window is one bulk asynchronous copy global ->
// shared (cp.async.bulk, completed on an mbarrier's transaction count:
// bulk.cuh), the counterpart of one DMA descriptor, then stored out by the
// block's threads with coalesced 16-byte stores.  A window of more bytes
// than a block's shared memory holds (226 KB beside its barrier) is split
// into chunks of `chunk_rows` rows, one block and one copy each; Ci = 48
// bf16 at w = 2048 (196,608 B) is still one copy.  A row must be a multiple of 16 bytes,
// which keeps every window's start 16-byte aligned: the wrapper refuses
// other rows and a misaligned x.
#include <algorithm>

#include "common.cuh"
#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_copy_kernel(const unsigned char* __restrict__ x, const int* __restrict__ offs,
                   unsigned char* __restrict__ out, int V, int w, int row_bytes,
                   int chunk_rows, int n_chunks) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar;
  const int win = blockIdx.x / n_chunks, c = blockIdx.x - win * n_chunks;
  const int r0 = c * chunk_rows;
  const int rows = min(chunk_rows, w - r0);
  const size_t bytes = static_cast<size_t>(rows) * row_bytes;
  int4* dst = reinterpret_cast<int4*>(
      out + (static_cast<size_t>(win) * w + r0) * row_bytes);
  const int off = offs[win];
  const size_t n16 = bytes / 16;
  if (off < 0 || off > V - w) {  // the same for the whole block
    for (size_t i = threadIdx.x; i < n16; i += kThreads) dst[i] = make_int4(0, 0, 0, 0);
    return;
  }
  bulk_load(buf, x + (static_cast<size_t>(off) + r0) * row_bytes,
            static_cast<unsigned>(bytes), &bar);
  const int4* src = reinterpret_cast<const int4*>(buf);
  for (size_t i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
}

}  // namespace

// x (V, C), offs (n,) int32, out (n, w, C); row_bytes = C * the element
// size, a multiple of 16; x and out 16-byte aligned; chunk_rows * row_bytes
// at most kMaxBulkBytes (the wrapper's plan: the whole window where it
// fits).
// Returns cudaGetLastError().
extern "C" int window_copy(const void* x, const void* offs, void* out, int n, int V,
                           int w, int row_bytes, int chunk_rows, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || chunk_rows <= 0 || w <= 0 ||
      static_cast<long long>(chunk_rows) * row_bytes > kMaxBulkBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      window_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBulkBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int rows = std::min(chunk_rows, w);
  const int n_chunks = (w + rows - 1) / rows;
  const size_t smem = static_cast<size_t>(rows) * row_bytes;
  window_copy_kernel<<<static_cast<unsigned>(n) * n_chunks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<const int*>(offs),
      static_cast<unsigned char*>(out), V, w, row_bytes, rows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
