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
// window once).  Design: no product.  Each block stages the whole window
// in shared memory with one bulk asynchronous copy (bulk.cuh), then its
// threads fill a contiguous range of output rows, consecutive threads on
// consecutive 16-byte chunks of the output, each reading its chunk of row
// idx[q] from shared memory.  The window must fit a block's shared memory
// (Ci = 48 bf16 at w = 2048 is 196,608 B): the wrapper refuses a larger
// one.  Every block reads the window again (from L2 after the first), so
// the wrapper keeps the grid near one wave.
#include "common.cuh"
#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const unsigned char* __restrict__ xw, const int* __restrict__ idx,
                     unsigned char* __restrict__ out, int w, int row_bytes,
                     long long rows, long long rows_per_block) {
  extern __shared__ __align__(128) unsigned char win[];
  __shared__ __align__(8) uint64_t bar;
  const long long q0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long q1 = q0 + rows_per_block < rows ? q0 + rows_per_block : rows;
  if (q0 >= q1) return;  // the same for the whole block
  bulk_load(win, xw, static_cast<unsigned>(w) * row_bytes, &bar);
  const int cpr = row_bytes / 16;  // chunks per row
  const int4* src = reinterpret_cast<const int4*>(win);
  int4* dst = reinterpret_cast<int4*>(out);
  const long long n = (q1 - q0) * cpr;
  for (long long e = threadIdx.x; e < n; e += kThreads) {
    const long long q = q0 + e / cpr;
    const int c = static_cast<int>(e % cpr);
    const int i = idx[q];
    dst[q * cpr + c] = (i >= 0 && i < w) ? src[i * cpr + c] : make_int4(0, 0, 0, 0);
  }
}

}  // namespace

// xw (w, C), idx (rows,) int32, out (rows, C); row_bytes = C * the element
// size, a multiple of 16; w * row_bytes at most kMaxBulkBytes; xw and out
// 16-byte aligned; `blocks` from the wrapper.  Returns cudaGetLastError().
extern "C" int window_gather(const void* xw, const void* idx, void* out, int w,
                             int row_bytes, long long rows, int blocks, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || w <= 0 || blocks <= 0 ||
      static_cast<long long>(w) * row_bytes > kMaxBulkBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      window_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBulkBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const long long per_block = (rows + blocks - 1) / blocks;
  const unsigned grid = static_cast<unsigned>((rows + per_block - 1) / per_block);
  window_gather_kernel<<<grid, kThreads, static_cast<size_t>(w) * row_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(xw), static_cast<const int*>(idx),
      static_cast<unsigned char*>(out), w, row_bytes, rows, per_block);
  return static_cast<int>(cudaGetLastError());
}
