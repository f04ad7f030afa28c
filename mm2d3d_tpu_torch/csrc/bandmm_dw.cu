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
// accumulates E^T @ g over the sequential grid.  Here blocks run in
// parallel with nothing carried between them, so each block sums one chunk
// of voxels and a second pass adds the chunks' fp32 partials in chunk order
// instead of float atomics: two calls on the same inputs give the same bits.
//
// What bounds it on the H100: bytes.  At the flagship level 0 (V = 65,536,
// tier 1 with H = 3 plus the centre, Ci = Co = 16, bf16) one call reads
// ~10.5 MB for 0.13 GFLOP of useful products (~3 us at the HBM rate); at
// the level-5 decoder concat (V = 4,096, Ci = 192, Co = 96) ~16 MB for ~1.4
// GFLOP.
//
// Two kernels, chosen by the launcher from the type and the shape:
//
// 1. bf16 with Ci % 8 == 0: tensor cores, dW_flat (K * Ci, Co) = E^T @ g.
//    A block owns 64 rows (band, ci) of dW (4 warps x 16) by up to 128
//    output channels, and one chunk of voxels.  It first reads its chunk's
//    taps and builds, in shared memory, the slot row that feeds each
//    (voxel, band) of its bands (bandsel.cuh).  Then it walks the chunk 64
//    voxels a stage through a 3-deep ring: the stage of E (64 voxels x the
//    block's 64 columns) filled by cp.async 16-byte copies from the
//    selected rows (an empty band zero-filled without a read), and the
//    stage of g by cp.async (plain loads where Co % 8 != 0).  Each warp
//    takes its A fragment of E^T with ldmatrix.trans from the E stage and
//    the g fragments with ldmatrix.trans, and runs mma.sync m16n8k16 with
//    the fp32 sums in registers; rows are padded for conflict-free
//    ldmatrix.  It writes its sums to its chunk's partial (or straight to
//    dW when there is one chunk).  The plan (channels per block, voxels
//    per chunk, chunks) is the wrapper's (ops/kernels/bandmm_dw.py::
//    dw_plan), a pure function of the shapes.  A second source on one band
//    (a duplicate tap, or tap 13 beside the centre: never on the main path)
//    takes a second pass over the chunk with the table of second sources,
//    into the same sums.
// 2. fp32, or Ci % 8 != 0 (the input conv, Ci = 3), or more slots or taps
//    than the band table holds: CUDA cores.  Each block gets a chunk of
//    voxel rows and a tile of (ci, co) pairs, one pair per thread, and keeps
//    its pair's K sums in shared memory at acc[k][thread]; it stages 8 rows
//    at a time (taps, x_src / xm values for its ci tile, g values for its co
//    tile) with coalesced loads and accumulates rows in order, slots in
//    order, the centre last.  fp32 stays off the tensor cores: TF32 would
//    not hold the 1e-4 tolerance against the plain version.
// Either way, pass 2 sums the chunks of each output element in chunk order.
// TMA/wgmma and the slot gather inside the kernel are later work.
#include "common.cuh"
#include "mma.cuh"
#include "bandsel.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- 1. tensor cores (bf16, Ci % 8 == 0) ----------------------------------

constexpr int kTcRows = 64;      // dW rows (band, ci) per block: 4 warps x 16
constexpr int kTcThreads = 128;
// The stage: voxels per stage (k steps of 16) and ring depth.
// tools/slotconv_tiles.py builds other stages with -DK2_STAGE_VOX=...
// -DK2_STAGE_RING=...
#ifndef K2_STAGE_VOX
#define K2_STAGE_VOX 64
#endif
#ifndef K2_STAGE_RING
#define K2_STAGE_RING 3
#endif
constexpr int kTcVox = K2_STAGE_VOX;
constexpr int kTcStages = K2_STAGE_RING;
constexpr int kEStride = kTcRows + 8;  // bf16 per E row in shared memory
constexpr int kSelBytes = 16384;  // the band table: bands x voxels of a chunk

// bands a block's 64 rows of dW can touch (Ci >= 8)
__host__ __device__ inline int max_bands(int Ci, int K) {
  const int n = (kTcRows - 1) / Ci + 2;
  return n < K ? n : K;
}

template <int NT>
constexpr int ring_bytes() {
  return kTcStages * kTcVox * (kEStride + NT * 8 + 8) *
         static_cast<int>(sizeof(bf16));
}

template <int NT>
__global__ void __launch_bounds__(kTcThreads)
dw_mma_kernel(const bf16* __restrict__ xm, const bf16* __restrict__ x_src,
              const int* __restrict__ tap, const bf16* __restrict__ g,
              float* __restrict__ dst, int V, int H, int Ci, int Co, int K,
              int rows_per_chunk) {
  constexpr int BN = NT * 8;
  constexpr int kGStride = BN + 8;  // bf16 per g row in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* es = reinterpret_cast<bf16*>(smem_raw);  // [stage][kTcVox][kEStride]
  bf16* gs = es + kTcStages * kTcVox * kEStride;  // [stage][kTcVox][kGStride]
  // [band - k_lo][rows_per_chunk]: the slot feeding each (band, voxel)
  signed char* sel = reinterpret_cast<signed char*>(gs + kTcStages * kTcVox * kGStride);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = K * Ci;
  const int m0 = blockIdx.x * kTcRows;
  const int n0 = blockIdx.y * BN;
  const int k_lo = m0 / Ci;
  const int k_hi = (min(m0 + kTcRows, M) - 1) / Ci + 1;  // bands [k_lo, k_hi)
  const int vb0 = blockIdx.z * rows_per_chunk;
  const int rows = min(V, vb0 + rows_per_chunk) - vb0;
  const size_t nv = static_cast<size_t>(V);
  const bool centre = xm != nullptr;

  // this thread's E copies: columns m_c .. m_c + 7 (one band) of the stage
  // rows e_r + 16 i
  const int e_c = tid & 7, e_r = tid >> 3;
  const int m_c = m0 + e_c * 8;
  const bool col_ok = m_c < M;
  const int k_c = col_ok ? m_c / Ci : k_lo;
  const int ci_c = m_c - k_c * Ci;
  const signed char* sel_c = sel + (k_c - k_lo) * rows_per_chunk;
  const bool g_vec = (Co & 7) == 0;
  const int n_stages = (rows + kTcVox - 1) / kTcVox;

  auto load_stage = [&](int s, int slot) {
    const int r0 = s * kTcVox;
    bf16* edst = es + slot * kTcVox * kEStride + e_c * 8;
#pragma unroll
    for (int i = 0; i < kTcVox / 16; ++i) {
      const int j = e_r + 16 * i;
      const int r = r0 + j;
      const int h = (col_ok && r < rows) ? sel_c[r] : -1;
      const size_t v = static_cast<size_t>(vb0 + r);
      const bf16* src = h < 0 ? g
          : (h == H ? xm + v * Ci : x_src + (h * nv + v) * Ci) + ci_c;
      cp_async16(edst + j * kEStride, src, h >= 0);
    }
    bf16* gdst = gs + slot * kTcVox * kGStride;
    if (g_vec) {
      for (int e = tid; e < kTcVox * NT; e += kTcThreads) {
        const int j = e / NT, nc = e - j * NT;
        const int r = r0 + j, col = n0 + nc * 8;
        const bool ok = r < rows && col < Co;
        cp_async16(gdst + j * kGStride + nc * 8,
                   ok ? g + static_cast<size_t>(vb0 + r) * Co + col : g, ok);
      }
    } else {
      for (int e = tid; e < kTcVox * BN; e += kTcThreads) {
        const int j = e / BN, c = e - j * BN;
        const int r = r0 + j, col = n0 + c;
        gdst[j * kGStride + c] = (r < rows && col < Co)
            ? g[static_cast<size_t>(vb0 + r) * Co + col] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // A = E^T (rows: dW rows, k: voxels) from the row-major [voxel][column]
  // stage by ldmatrix.trans: matrix q = lane / 8 holds rows (q & 1) * 8 and
  // voxels (q >> 1) * 8 of the 16 x 16 fragment
  const int a_off = (((lane >> 4) << 3) + (lane & 7)) * kEStride + warp * 16 +
                    ((lane >> 3) & 1) * 8;
  const int b_off = (lane & 15) * kGStride + (lane >> 4) * 8;
  // one pass over the chunk per source of a band: one on the main path
  for (int pass = 0;; ++pass) {
    bool more = false;
    for (int r = tid; r < rows; r += kTcThreads) {
      more |= select_bands(tap, vb0 + r, V, H, K, centre, k_lo, k_hi - k_lo,
                           pass, sel + r, rows_per_chunk);
    }
    more = __syncthreads_or(more);  // also: the table is written
#pragma unroll
    for (int s = 0; s < kTcStages - 1; ++s) {
      if (s < n_stages) load_stage(s, s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<kTcStages - 2>();
      // stage s has landed for every thread, and every warp is done with
      // the slot the next load overwrites (stage s - 1's)
      __syncthreads();
      const int nxt = s + kTcStages - 1;
      if (nxt < n_stages) load_stage(nxt, nxt % kTcStages);
      cp_async_commit();
      const int slot = s % kTcStages;
      const bf16* e_t = es + slot * kTcVox * kEStride + a_off;
      const bf16* g_t = gs + slot * kTcVox * kGStride + b_off;
#pragma unroll
      for (int kk = 0; kk < kTcVox; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, e_t + kk * kEStride);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, g_t + kk * kGStride + np * 16);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    if (!more) break;
    cp_async_wait<0>();
    __syncthreads();  // the ring and the table are free for the next pass
  }

  const int gr = lane >> 2, tc = (lane & 3) * 2;
  float* out = dst + static_cast<size_t>(blockIdx.z) * M * Co;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + warp * 16 + gr + h * 8;
    if (m >= M) continue;
    float* o = out + static_cast<size_t>(m) * Co;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + nt * 8 + tc;
      if (col < Co) o[col] = acc[nt][2 * h];
      if (col + 1 < Co) o[col + 1] = acc[nt][2 * h + 1];
    }
  }
}

// ---- 2. CUDA cores (fp32, or Ci % 8 != 0) ---------------------------------

constexpr int kThreads = 256;
constexpr int kRows = 8;  // voxel rows staged per step

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

int launch_reduce(const float* partial, float* out, int n_chunks, size_t n,
                  cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    dw_reduce_kernel<<<blocks, threads, 0, stream>>>(partial, out, n_chunks, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_tc(const bf16* xm, const bf16* x_src, const int* tap, const bf16* g,
              float* partial, float* out, int V, int H, int Ci, int Co, int K,
              int rows_per_chunk, int n_chunks, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ring_bytes<NT>() + kSelBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t n = static_cast<size_t>(K) * Ci * Co;
  if (n_chunks > 0) {
    const size_t bytes = ring_bytes<NT>() +
        static_cast<size_t>(max_bands(Ci, K)) * rows_per_chunk;
    const dim3 grid((K * Ci + kTcRows - 1) / kTcRows, (Co + NT * 8 - 1) / (NT * 8),
                    n_chunks);
    dw_mma_kernel<NT><<<grid, kTcThreads, bytes, stream>>>(
        xm, x_src, tap, g, n_chunks > 1 ? partial : out, V, H, Ci, Co, K,
        rows_per_chunk);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0 || n_chunks == 1) return rc;
  }
  return launch_reduce(partial, out, n_chunks, n, stream);  // 0 chunks: zeros
}

int launch_tc_bn(const bf16* xm, const bf16* xs, const int* tap, const bf16* g,
                 float* part, float* out, int V, int H, int Ci, int Co, int K,
                 int bn, int rows, int n_chunks, cudaStream_t s) {
  switch (bn / 8) {
    case 2: return launch_tc<2>(xm, xs, tap, g, part, out, V, H, Ci, Co, K, rows, n_chunks, s);
    case 4: return launch_tc<4>(xm, xs, tap, g, part, out, V, H, Ci, Co, K, rows, n_chunks, s);
    case 6: return launch_tc<6>(xm, xs, tap, g, part, out, V, H, Ci, Co, K, rows, n_chunks, s);
    case 8: return launch_tc<8>(xm, xs, tap, g, part, out, V, H, Ci, Co, K, rows, n_chunks, s);
    case 10: return launch_tc<10>(xm, xs, tap, g, part, out, V, H, Ci, Co, K, rows, n_chunks, s);
    case 12: return launch_tc<12>(xm, xs, tap, g, part, out, V, H, Ci, Co, K, rows, n_chunks, s);
    case 14: return launch_tc<14>(xm, xs, tap, g, part, out, V, H, Ci, Co, K, rows, n_chunks, s);
    default: return launch_tc<16>(xm, xs, tap, g, part, out, V, H, Ci, Co, K, rows, n_chunks, s);
  }
}

template <typename T>
int launch_simt(const void* xm, const void* x_src, const void* tap,
                const void* g, void* partial, void* out, int V, int H, int Ci,
                int Co, int K, int co_tile, int rows_per_chunk, int n_chunks,
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
  return launch_reduce(static_cast<const float*>(partial), static_cast<float*>(out),
                       n_chunks, static_cast<size_t>(K) * Ci * Co, stream);
}

}  // namespace

// xm (V, Ci) or null; x_src (H, V, Ci) or null (then H = 0); tap (H, V)
// int32; g (V, Co); out (K, Ci, Co) fp32.  dtype: 0 = fp32, 1 = bf16 (xm,
// x_src, g).  (tile, rows_per_chunk, n_chunks) is the wrapper's plan; chunk
// c covers rows [c * rows_per_chunk, min(V, (c + 1) * rows_per_chunk)) and
// n_chunks = ceil(V / rows_per_chunk).  On tensor cores (bf16, Ci % 8 == 0,
// H <= 64, K <= 32; the inputs 16-byte aligned) tile is the output channels
// per block (16 .. 128 in steps of 16), rows_per_chunk * max_bands <= 16 KB
// (the band table), and partial (n_chunks, K, Ci, Co) fp32 scratch when
// n_chunks > 1.  On CUDA cores tile is 16 or 32 (threads along Co per
// block), partial is always given, and shared memory per block is K KB of
// sums plus the staged rows, at most 42 KB for K <= 27 and H <= 26.  A plan
// that does not match the route returns cudaErrorInvalidValue.
extern "C" int slot_conv_dw(const void* xm, const void* x_src, const void* tap,
                            const void* g, void* partial, void* out, int V,
                            int H, int Ci, int Co, int K, int tile,
                            int rows_per_chunk, int n_chunks, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == kBFloat16 && Ci % 8 == 0 && H <= kMaxTcSlots &&
                  K <= kMaxTcBands;
  const bool chunks_ok = rows_per_chunk >= 1 &&
      n_chunks == (V + rows_per_chunk - 1) / rows_per_chunk;
  const bool plan_ok = chunks_ok && (tc
      ? (tile % 16 == 0 && tile >= 16 && tile <= 128 &&
         static_cast<long>(rows_per_chunk) * max_bands(Ci, K) <= kSelBytes &&
         (n_chunks <= 1 || partial != nullptr))
      : ((tile == 16 || tile == 32) && (n_chunks == 0 || partial != nullptr)));
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (tc) {
    return launch_tc_bn(static_cast<const bf16*>(xm), static_cast<const bf16*>(x_src),
                        static_cast<const int*>(tap), static_cast<const bf16*>(g),
                        static_cast<float*>(partial), static_cast<float*>(out),
                        V, H, Ci, Co, K, tile, rows_per_chunk, n_chunks, s);
  }
  if (dtype == kBFloat16) {
    return launch_simt<bf16>(xm, x_src, tap, g, partial, out, V, H, Ci, Co, K,
                             tile, rows_per_chunk, n_chunks, s);
  }
  return launch_simt<float>(xm, x_src, tap, g, partial, out, V, H, Ci, Co, K,
                            tile, rows_per_chunk, n_chunks, s);
}
