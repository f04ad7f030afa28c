// Slot-compacted sparse convolution apply (K1).
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
// What bounds it on the H100: bytes.  At the flagship level 0 (V = 65,536,
// tier 1 with H = 3 plus the centre, Ci = Co = 16, bf16) one call reads
// ~8.4 MB of x_src/xm and writes 4.2 MB of fp32 for 0.13 GFLOP of useful
// products: ~4 us at the HBM rate, far under the tensor cores' ridge.  At
// the level-5 decoder concat (V = 4,096, Ci = 192, Co = 96) it moves ~17 MB
// for ~1.4 GFLOP: still the bytes' side, but ~80 TFLOP/s at the byte bound,
// beyond the fp32 CUDA cores.
//
// Two kernels, chosen by the launcher from the type and the shape:
//
// 1. bf16 with Ci % 8 == 0 (every K1 call of the flagship but the input
//    conv's forward): tensor cores, out = E @ W_flat with the TPU's banded
//    matrix E (V, K * Ci) (band k of row v: the slot row whose tap is k,
//    band 13 the centre; bandsel.cuh) and W_flat = W as (K * Ci, Co).  E
//    lives only in shared memory: a block first reads its tile's taps and
//    builds a table of the row that feeds each (voxel, band), then fills
//    each stage of E with cp.async 16-byte copies from those rows; an empty
//    band is zero-filled without a byte read, so only the H + 1 rows that
//    exist leave device memory.  The zero bands cost the tensor cores work
//    (27 bands for 4 filled at level 0), which they have to spare.  The GEMM
//    is K6's (tapsum.cu): 64 voxels (4 warps) or 128 (8 warps) by up to 128
//    output channels, stages of 64 or 128 reduction elements through a 4-
//    or 3-deep ring, ldmatrix / ldmatrix.trans, mma.sync m16n8k16 with fp32
//    sums in registers, rows padded for conflict-free ldmatrix, W staged
//    with plain loads where Co % 8 != 0 (the input conv's adjoint, Co = 3).
//    Where the row tiles leave the 132 SMs short (the heavy tiers, the deep
//    levels), the bands are split into groups (grid z) whose fp32 partials
//    a second kernel sums in a fixed order: two calls give the same bits.
//    The plan (splits, voxels and channels per block) is the wrapper's
//    (ops/kernels/bandmm.py::apply_plan, K6's tapsum_plan).  A second
//    source on one band (a duplicate tap, or tap 13 beside the centre:
//    never on the main path) takes a second pass over the tile with the
//    table of second sources, into the same sums.
// 2. fp32, or Ci % 8 != 0 (the input conv's forward, Ci = 3), or more slots
//    or taps than the band table holds: CUDA cores.  One block per tile of
//    16 voxels and up to 128 output channels; per slot the block stages the
//    tile's 16 rows of x_src (as fp32) and their taps in shared memory, and
//    each thread owns one voxel and 8 output channels, reading W[tap]
//    through L1/L2.  fp32 stays off the tensor cores: TF32 would not hold
//    the 1e-4 tolerance against the plain version.
// TMA/wgmma and the slot gather inside the kernel are later work.
#include "common.cuh"
#include "mma.cuh"
#include "bandsel.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- 1. tensor cores (bf16, Ci % 8 == 0) ----------------------------------

template <int BM, int BK, int STAGES>
struct Tile {
  static constexpr int kThreads = BM * 2;        // one warp per 16 rows
  static constexpr int kAStride = BK + 8;        // bf16 per A row in smem
  static constexpr int kAChunks = BK / 8;        // 16-byte chunks per A row
  static constexpr int kARows = kThreads / kAChunks;  // A rows per pass
  template <int NT>
  static constexpr int smem_bytes() {
    return STAGES * (BM * kAStride + BK * (NT * 8 + 8)) *
               static_cast<int>(sizeof(bf16)) +
           kMaxTcBands * BM;  // the band table
  }
};

template <int NT, int BM, int BK, int STAGES>
__global__ void __launch_bounds__(BM * 2)
bandmm_mma_kernel(const bf16* __restrict__ xm, const bf16* __restrict__ x_src,
                  const int* __restrict__ tap, const bf16* __restrict__ w,
                  float* __restrict__ out, int V, int H, int Ci, int Co, int K,
                  int splits) {
  using T = Tile<BM, BK, STAGES>;
  constexpr int BN = NT * 8;
  constexpr int kAStride = T::kAStride;
  constexpr int kBStride = BN + 8;  // bf16 per W row in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);   // [stage][BM][kAStride]
  bf16* bs = as + STAGES * BM * kAStride;         // [stage][BK][kBStride]
  // [band - k0][BM]: the slot feeding each (band, voxel), H = centre, -1
  signed char* sel = reinterpret_cast<signed char*>(bs + STAGES * BK * kBStride);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int k0 = split * K / splits, k1 = (split + 1) * K / splits;
  const int r_begin = k0 * Ci, r_end = k1 * Ci;
  const int n_stages = (r_end - r_begin + BK - 1) / BK;
  const bool w_vec = (Co & 7) == 0;
  const size_t nv = static_cast<size_t>(V);
  const bool centre = xm != nullptr;

  // this thread's A copies: chunk a_j (8 channels) of rows a_m + kARows i
  const int a_j = tid % T::kAChunks, a_m = tid / T::kAChunks;

  auto load_stage = [&](int s, int slot) {
    const int r0 = r_begin + s * BK;
    const int r = r0 + a_j * 8;
    const bool rin = r < r_end;
    const int k = rin ? r / Ci : k0;
    const int ci = r - k * Ci;
    const signed char* sel_k = sel + (k - k0) * BM;
    bf16* adst = as + slot * BM * kAStride + a_j * 8;
#pragma unroll
    for (int i = 0; i < BM / T::kARows; ++i) {
      const int m = a_m + T::kARows * i;
      const int h = rin ? sel_k[m] : -1;
      const size_t v = static_cast<size_t>(v0 + m);
      const bf16* src = h < 0 ? w
          : (h == H ? xm + v * Ci : x_src + (h * nv + v) * Ci) + ci;
      cp_async16(adst + m * kAStride, src, h >= 0);
    }
    bf16* bdst = bs + slot * BK * kBStride;
    if (w_vec) {
      for (int e = tid; e < BK * NT; e += T::kThreads) {
        const int kr = e / NT, nc = e - kr * NT;
        const int rw = r0 + kr, col = n0 + nc * 8;
        const bool ok = rw < r_end && col < Co;
        cp_async16(bdst + kr * kBStride + nc * 8,
                   ok ? w + static_cast<size_t>(rw) * Co + col : w, ok);
      }
    } else {
      for (int e = tid; e < BK * BN; e += T::kThreads) {
        const int kr = e / BN, c = e - kr * BN;
        const int rw = r0 + kr, col = n0 + c;
        bdst[kr * kBStride + c] = (rw < r_end && col < Co)
            ? w[static_cast<size_t>(rw) * Co + col] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int a_off = (warp * 16 + (lane & 15)) * kAStride + (lane >> 4) * 8;
  const int b_off = (lane & 15) * kBStride + (lane >> 4) * 8;
  // one pass over the tile per source of a band: one on the main path
  for (int pass = 0;; ++pass) {
    bool more = false;
    if (tid < BM) {
      if (v0 + tid < V) {
        more = select_bands(tap, v0 + tid, V, H, K, centre, k0, k1 - k0, pass,
                            sel + tid, BM);
      } else {
        for (int b = 0; b < k1 - k0; ++b) sel[b * BM + tid] = -1;
      }
    }
    more = __syncthreads_or(more);  // also: the table is written
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_stages) load_stage(s, s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<STAGES - 2>();
      // stage s has landed for every thread, and every warp is done with
      // the slot the next load overwrites (stage s - 1's)
      __syncthreads();
      const int nxt = s + STAGES - 1;
      if (nxt < n_stages) load_stage(nxt, nxt % STAGES);
      cp_async_commit();
      const int slot = s % STAGES;
      const bf16* a_t = as + slot * BM * kAStride + a_off;
      const bf16* b_t = bs + slot * BK * kBStride + b_off;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, a_t + kk);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, b_t + kk * kBStride + np * 16);
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
  float* dst = out + static_cast<size_t>(split) * V * Co;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = v0 + warp * 16 + gr + h * 8;
    if (v >= V) continue;
    float* o = dst + static_cast<size_t>(v) * Co;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + nt * 8 + tc;
      if (col < Co) o[col] = acc[nt][2 * h];
      if (col + 1 < Co) o[col + 1] = acc[nt][2 * h + 1];
    }
  }
}

// out[i] = sum_{s = 0 .. S-1} part[s][i], in that order
__global__ void bandmm_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * n + i];
  out[i] = s;
}

template <int NT, int BM, int BK, int STAGES>
int launch_tc(const bf16* xm, const bf16* x_src, const int* tap, const bf16* w,
              float* out, float* scratch, int V, int H, int Ci, int Co, int K,
              int splits, cudaStream_t stream) {
  constexpr int bytes = Tile<BM, BK, STAGES>::template smem_bytes<NT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      bandmm_mma_kernel<NT, BM, BK, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_col = (Co + NT * 8 - 1) / (NT * 8);
  const dim3 grid((V + BM - 1) / BM, n_col, splits);
  float* dst = splits > 1 ? scratch : out;
  bandmm_mma_kernel<NT, BM, BK, STAGES><<<grid, BM * 2, bytes, stream>>>(
      xm, x_src, tap, w, dst, V, H, Ci, Co, K, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(V) * Co;
  bandmm_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      scratch, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BK, int STAGES>
int launch_tc_bn(const bf16* xm, const bf16* xs, const int* tap, const bf16* w,
                 float* out, float* sc, int V, int H, int Ci, int Co, int K,
                 int splits, int bn, cudaStream_t s) {
  switch (bn / 8) {
    case 2: return launch_tc<2, BM, BK, STAGES>(xm, xs, tap, w, out, sc, V, H, Ci, Co, K, splits, s);
    case 4: return launch_tc<4, BM, BK, STAGES>(xm, xs, tap, w, out, sc, V, H, Ci, Co, K, splits, s);
    case 6: return launch_tc<6, BM, BK, STAGES>(xm, xs, tap, w, out, sc, V, H, Ci, Co, K, splits, s);
    case 8: return launch_tc<8, BM, BK, STAGES>(xm, xs, tap, w, out, sc, V, H, Ci, Co, K, splits, s);
    case 10: return launch_tc<10, BM, BK, STAGES>(xm, xs, tap, w, out, sc, V, H, Ci, Co, K, splits, s);
    case 12: return launch_tc<12, BM, BK, STAGES>(xm, xs, tap, w, out, sc, V, H, Ci, Co, K, splits, s);
    case 14: return launch_tc<14, BM, BK, STAGES>(xm, xs, tap, w, out, sc, V, H, Ci, Co, K, splits, s);
    default: return launch_tc<16, BM, BK, STAGES>(xm, xs, tap, w, out, sc, V, H, Ci, Co, K, splits, s);
  }
}

// ---- 2. CUDA cores (fp32, or Ci % 8 != 0) ---------------------------------

constexpr int kVT = 16;   // voxels per block
constexpr int kCT = 16;   // threads along the output channels
constexpr int kCPT = 8;   // output channels per thread (stride kCT)

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
int launch_simt(const void* xm, const void* x_src, const void* tap,
                const void* w, void* out, int V, int H, int Ci, int Co, int K,
                cudaStream_t stream) {
  const dim3 block(kCT, kVT);
  const dim3 grid((V + kVT - 1) / kVT, (Co + kCT * kCPT - 1) / (kCT * kCPT));
  const size_t smem = static_cast<size_t>(kVT) * Ci * sizeof(float);
  apply_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(xm), static_cast<const T*>(x_src),
      static_cast<const int*>(tap), static_cast<const T*>(w),
      static_cast<float*>(out), V, H, Ci, Co, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xm (V, Ci) or null; x_src (H, V, Ci) or null (then H = 0); tap (H, V) int32;
// w (K, Ci, Co); out (V, Co) fp32.  dtype: 0 = fp32, 1 = bf16 (xm, x_src, w).
// (splits, bm, bn) is the wrapper's plan: on tensor cores (bf16, Ci % 8 ==
// 0, H <= 64, K <= 32; the inputs 16-byte aligned) bm = 64 or 128, bn = 16
// .. 128 in steps of 16, and scratch (splits, V, Co) fp32 when splits > 1;
// on CUDA cores splits = 1, bm = 16, bn = 128, no scratch and Ci <= 512 (the
// staged tile is 16 * Ci fp32 of shared memory).  A plan that does not
// match the route returns cudaErrorInvalidValue.  Returns the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int slot_conv_apply(const void* xm, const void* x_src,
                               const void* tap, const void* w, void* out,
                               void* scratch, int V, int H, int Ci, int Co,
                               int K, int dtype, int splits, int bm, int bn,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == kBFloat16 && Ci % 8 == 0 && H <= kMaxTcSlots &&
                  K <= kMaxTcBands;
  const bool plan_ok = tc
      ? ((bm == 64 || bm == 128) && bn % 16 == 0 && bn >= 16 && bn <= 128
         && splits >= 1 && splits <= K && (splits == 1 || scratch != nullptr))
      : (splits == 1 && bm == kVT && bn == kCT * kCPT);
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (V == 0 || Co == 0) return static_cast<int>(cudaGetLastError());
  if (tc) {
    const bf16* xmb = static_cast<const bf16*>(xm);
    const bf16* xsb = static_cast<const bf16*>(x_src);
    const int* tp = static_cast<const int*>(tap);
    const bf16* wb = static_cast<const bf16*>(w);
    float* o = static_cast<float*>(out);
    float* sc = static_cast<float*>(scratch);
    return bm == 128
        ? launch_tc_bn<128, 128, 3>(xmb, xsb, tp, wb, o, sc, V, H, Ci, Co, K, splits, bn, s)
        : launch_tc_bn<64, 64, 4>(xmb, xsb, tp, wb, o, sc, V, H, Ci, Co, K, splits, bn, s);
  }
  if (dtype == kBFloat16) {
    return launch_simt<bf16>(xm, x_src, tap, w, out, V, H, Ci, Co, K, s);
  }
  return launch_simt<float>(xm, x_src, tap, w, out, V, H, Ci, Co, K, s);
}
