// Slot-row gather of the sparse convolutions.
//
// Replaces no Pallas kernel: it stands for XLA's `jnp.take` of the feature
// map padded by `_pad_zero_row` in mm2d3d_tpu/ops/spconv.py, which every
// sparse convolution runs forward and backward, once per tier of its slot
// tables.
//
// What it computes, for ids (N,) int32 (any shape, flattened) and x (V, C)
// read through a row stride:
//   out[n, :] = x[ids[n], :]   if 0 <= ids[n] < V
//   out[n, :] = 0              otherwise (the pad id V, a dumped parent)
// It copies bytes, so it is exact in every type.
//
// What bounds it on the H100: bytes.  The least it must move is the output,
// written once, and the distinct rows the ids reach, read once.  Most ids of
// a slot table name the pad (93% of the 5^3 stem's): PyTorch's gather over a
// padded copy read that one zero row for each of them, so every block
// hammered one address, and it paid for the padded copy and an int64 copy
// of the ids besides.
//
// What the design does about it:
// - a missing row is stored as zeros without any load;
// - each warp copies 32 consecutive output rows: every lane loads one id
//   (one coalesced 128-byte read), and the lanes that copy a row take its
//   id from the owner lane by a shuffle, so an id is read once per row, not
//   once per chunk;
// - the 32 rows' chunks are dealt to the lanes in output order, so every
//   store of the warp is contiguous, and a row's chunks are contiguous reads;
// - a chunk is the widest vector (16, 8, 4, 2 or 1 bytes) that divides the
//   row's bytes, the source's row stride and both addresses (the wrapper
//   picks it: 16 for C >= 8 bf16, 2 for the stem's 6-byte rows of 3 bf16);
// - each lane starts kUnroll loads before its stores, and one tile per warp
//   with eight warps a block keeps up to 2,048 rows in flight on an SM, which
//   covers the latency of the id load that each row load depends on;
// - x is read through its row stride, so a channel slice needs no copy.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // chunks a lane loads before it stores

template <typename V>
__global__ void __launch_bounds__(kThreads)
slot_gather_kernel(const unsigned char* __restrict__ x, unsigned long long x_rows,
                   long long x_stride, const int* __restrict__ ids, long long n,
                   int cpr, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  if (row0 >= n) return;  // uniform over the warp
  const int rows = static_cast<int>(n - row0 < 32 ? n - row0 : 32);
  const int id = lane < rows ? __ldg(ids + row0 + lane) : -1;
  const int items = rows * cpr;  // chunks of this tile, in output order
  const int step_r = 32 / cpr, step_c = 32 % cpr;
  int r = lane / cpr, c = lane - (lane / cpr) * cpr;  // this lane's (row, chunk)
  V* dst = out + row0 * cpr;
  for (int base = 0; base < items; base += 32 * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int src = __shfl_sync(0xffffffffu, id, r & 31);
      v[u] = V{};
      if (base + u * 32 + lane < items &&
          static_cast<unsigned long long>(static_cast<long long>(src)) < x_rows) {
        v[u] = __ldg(reinterpret_cast<const V*>(x + src * x_stride) + c);
      }
      r += step_r;
      c += step_c;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * 32 + lane;
      if (i < items) dst[i] = v[u];
    }
  }
}

template <typename V>
int launch(const void* x, long long x_rows, long long x_stride, const void* ids,
           long long n, int row_bytes, void* out, cudaStream_t stream) {
  const long long tiles = (n + 31) / 32;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  slot_gather_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned long long>(x_rows),
      x_stride, static_cast<const int*>(ids), n,
      row_bytes / static_cast<int>(sizeof(V)), static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: x_rows rows of row_bytes bytes, row r at x + r * x_stride (bytes);
// ids: n int32; out: n * row_bytes bytes, contiguous.  vec_bytes (1, 2, 4,
// 8 or 16) divides row_bytes, x_stride and both addresses (checked here and
// by the Python wrapper).  Returns cudaGetLastError().
extern "C" int slot_gather(const void* x, long long x_rows, long long x_stride,
                           const void* ids, long long n, int row_bytes,
                           int vec_bytes, void* out, void* stream) {
  const bool width_ok = vec_bytes == 1 || vec_bytes == 2 || vec_bytes == 4 ||
                        vec_bytes == 8 || vec_bytes == 16;
  if (!width_ok || n < 0 || x_rows < 0 || row_bytes <= 0 || row_bytes > (1 << 20) ||
      row_bytes % vec_bytes != 0 || x_stride % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(x) % vec_bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % vec_bytes != 0 ||
      (n + 31) / 32 > 0x7fffffffLL * kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch<uint4>(x, x_rows, x_stride, ids, n, row_bytes, out, s);
    case 8: return launch<uint2>(x, x_rows, x_stride, ids, n, row_bytes, out, s);
    case 4: return launch<unsigned int>(x, x_rows, x_stride, ids, n, row_bytes, out, s);
    case 2: return launch<unsigned short>(x, x_rows, x_stride, ids, n, row_bytes, out, s);
    default: return launch<unsigned char>(x, x_rows, x_stride, ids, n, row_bytes, out, s);
  }
}
