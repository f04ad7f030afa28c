// Banded apply on pre-gathered inputs (K10), a probe of K1's E build.
//
// Replaces the TPU probe kernels of tools/exp_bandmm_variants.py (kern_a to
// kern_d, timed at tile 512 by main(); mk_c's kernel at 512, 1024 and 2048
// and mk_pair's at 1024 by main2()): the banded slot-conv kernel of
// mm2d3d_tpu/ops/pallas/bandmm.py on fixed gathered inputs, so that the
// build of the banded matrix E is timed apart from the gathers.
//
// What it computes, in the TPU's (channels, voxels) layout:
//   out = W @ E,  E (K * Ci, V): band k of column v is
//   E[k][:, v] = round(sum of every source of band k at v, in fp32)
// where the sources of band k are x[h][:, v] for each slot h with
// tap[h, v] == k, and the centre xm[:, v] first on band 13 when xm is
// given; a tap outside [0, K) is a miss.  xm (Ci, V), x (H, Ci, V), W
// (Co, K * Ci) bf16, tap (H, V) int32; out (Co, V) fp32; the rounding is
// to bf16.  On a real slot table (each tap at most once per column, never
// 13) every band has at most one source, E is exact and this is K1's
// function; the TPU variants differ from it and from each other only on
// other tables (tap 13 beside the centre, duplicates, tap < h).
//
// What bounds it on the H100: bytes (13.4 MB at the probe's V = 65,536,
// H = 3, Ci = Co = 16: ~4 us at the HBM rate, for 0.11 GFLOP of useful
// products).  Design: one block per BV = 64 or 128 voxels, one warp per 16
// voxels.  The block stages W, its tile of xm and x (cp.async) and its taps
// in shared memory, builds its tile of E there (never in device memory),
// then runs out = W @ E on the tensor cores: mma.sync m16n8k16 bf16 with
// fp32 sums in registers, W's fragments by ldmatrix, E's by
// ldmatrix.trans (mma.cuh).  Two template parameters are what the TPU
// variants time, on Hopper's scale:
//   - the E build: `full` stages all K bands, zero-filling the empty ones
//     (K1's route, csrc/bandmm.cu); `compact` stages only the bands that a
//     row of the tile hits (the tile's union mask) and the centre, and
//     multiplies only those (ROADMAP Queue 2, skipping empty bands).
//     Either way the block zeroes its bands with 16-byte stores, then each
//     (band, voxel)'s first source writes the band's sum: the work beyond
//     the zeroing follows the H + 1 sources, not the K bands;
//   - voxels per block, 64 or 128 (main2's tile sweep).
// Sums of one output in band order, so two calls give the same bits.
#include "common.cuh"
#include "mma.cuh"
#include "bandsel.cuh"
#include "bulk.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxCo = 64;  // four 16-row tiles of W per warp

template <int BV>
struct Layout {
  static constexpr int kThreads = BV * 2;  // one warp per 16 voxels
  static constexpr int kEStride = BV + 8;  // bf16 per E row: conflict-free ldmatrix
};

// shared memory of one block, in bytes: W, E (K bands), x and xm tiles, taps
inline size_t smem_bytes(int bv, int H, int Ci, int Co, int K) {
  const size_t w = static_cast<size_t>(Co) * (K * Ci + 8);
  const size_t e = static_cast<size_t>(K) * Ci * (bv + 8);
  const size_t xs = static_cast<size_t>(H + 1) * Ci * bv;
  return (w + e + xs) * sizeof(bf16) + static_cast<size_t>(H) * bv * sizeof(int);
}

template <bool kCompact, int BV>
__global__ void __launch_bounds__(BV * 2)
exp_bandmm_kernel(const bf16* __restrict__ xm, const bf16* __restrict__ x,
                  const int* __restrict__ tap, const bf16* __restrict__ w,
                  float* __restrict__ out, int V, int H, int Ci, int Co, int K) {
  using L = Layout<BV>;
  constexpr int kThreads = L::kThreads;
  constexpr int kEStride = L::kEStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned hit_mask;
  __shared__ int n_bands;
  __shared__ int bands[kMaxTcBands];  // compact: E's bands, ascending
  __shared__ int pos[kMaxTcBands];    // compact: band k's place in E, or -1
  const int KC = K * Ci, kWStride = KC + 8;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [Co][kWStride]
  bf16* es = ws + Co * kWStride;                 // [band][Ci][kEStride]
  bf16* xs = es + K * Ci * kEStride;             // [H][Ci][BV], then xm [Ci][BV]
  bf16* xms = xs + H * Ci * BV;
  int* taps = reinterpret_cast<int*>(xms + Ci * BV);  // [H][BV]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * BV;
  const size_t nv = static_cast<size_t>(V);
  const bool centre = xm != nullptr;
  if (tid == 0) hit_mask = 0;

  // 1. stage W, the tile's x and xm rows, and its taps
  const int wc = KC / 8;  // 16-byte chunks per W row
  for (int e = tid; e < Co * wc; e += kThreads) {
    const int r = e / wc, c = e - r * wc;
    cp_async16(ws + r * kWStride + c * 8, w + static_cast<size_t>(r) * KC + c * 8, true);
  }
  const int n_rows = (H + (centre ? 1 : 0)) * Ci;  // x's rows, then xm's
  if ((V & 7) == 0) {  // 16-byte aligned rows: cp.async, zeros past V
    constexpr int kChunks = BV / 8;
    for (int e = tid; e < n_rows * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e - r * kChunks;
      const int v = v0 + c * 8;
      const bf16* row = r < H * Ci ? x + r * nv : xm + (r - H * Ci) * nv;
      cp_async16(xs + r * BV + c * 8, v < V ? row + v : w, v < V);
    }
  } else {
    for (int e = tid; e < n_rows * BV; e += kThreads) {
      const int r = e / BV, c = e - r * BV;
      const int v = v0 + c;
      const bf16* row = r < H * Ci ? x + r * nv : xm + (r - H * Ci) * nv;
      xs[e] = v < V ? row[v] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
  unsigned mine = 0;
  for (int e = tid; e < H * BV; e += kThreads) {
    const int h = e / BV, v = v0 + e - h * BV;
    const int t = v < V ? tap[h * nv + v] : -1;
    taps[e] = t;
    if (valid_tap(t, K)) mine |= 1u << t;
  }
  cp_async_wait<0>();
  __syncthreads();  // hit_mask is 0 for every thread

  // 2. the bands of this tile's E: all K, or (compact) those a row of the
  // tile hits and the centre; pos[k] is band k's place in E
  if (kCompact) {
    mine = __reduce_or_sync(0xffffffffu, mine);
    if (lane == 0 && mine) atomicOr(&hit_mask, mine);
    __syncthreads();
    if (tid == 0) {
      const unsigned m = hit_mask | (centre ? 1u << kCenter : 0u);
      int nb = 0;
      for (int k = 0; k < K; ++k) {
        pos[k] = (m >> k & 1u) ? nb : -1;
        if (m >> k & 1u) bands[nb++] = k;
      }
      n_bands = nb;
    }
    __syncthreads();
  }
  const int nb = kCompact ? n_bands : K;

  // 3. build E: zero its bands (16-byte stores), then the first source of
  // each (band, voxel), the centre first, writes the band's fp32 sum of
  // every source, rounded once
  int4* e4 = reinterpret_cast<int4*>(es);
  for (int i = tid; i < nb * Ci * kEStride / 8; i += kThreads) e4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  for (int e = tid; e < (H + 1) * Ci * BV; e += kThreads) {
    const int row = e / BV, v = e - row * BV;
    const int s = row / Ci, ci = row - s * Ci;  // s: a slot, or H for the centre
    int k, h0;
    if (s < H) {
      k = taps[s * BV + v];
      bool first = valid_tap(k, K) && !(centre && k == kCenter);
      for (int h = 0; h < s; ++h) first &= taps[h * BV + v] != k;
      if (!first) continue;
      h0 = s;
    } else {
      if (!centre) continue;
      k = kCenter;
      h0 = 0;
    }
    float sum = s == H ? __bfloat162float(xms[ci * BV + v]) : 0.f;
    for (int h = h0; h < H; ++h) {
      if (taps[h * BV + v] == k) sum += __bfloat162float(xs[(h * Ci + ci) * BV + v]);
    }
    const int b = kCompact ? pos[k] : k;
    es[(b * Ci + ci) * kEStride + v] = __float2bfloat16(sum);
  }
  __syncthreads();

  // 4. out tile (Co, BV) = W[:, bands] @ E on the tensor cores
  const int n_mt = Co / 16;
  float acc[kMaxCo / 16][2][4];
#pragma unroll
  for (int mt = 0; mt < kMaxCo / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const bf16* a_base = ws + (lane & 15) * kWStride + (lane >> 4) * 8;
  const bf16* b_base = es + (lane & 15) * kEStride + warp * 16 + (lane >> 4) * 8;
  for (int b = 0; b < nb; ++b) {
    const int k = kCompact ? bands[b] : b;
    for (int kk = 0; kk < Ci; kk += 16) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b_base + (b * Ci + kk) * kEStride);
#pragma unroll
      for (int mt = 0; mt < kMaxCo / 16; ++mt) {
        if (mt < n_mt) {
          uint32_t af[4];
          ldmatrix_x4(af, a_base + mt * 16 * kWStride + k * Ci + kk);
          mma_bf16(acc[mt][0], af, bf[0], bf[1]);
          mma_bf16(acc[mt][1], af, bf[2], bf[3]);
        }
      }
    }
  }

  // 5. store: c0, c1 = C[g][2t..2t+1], c2, c3 = C[g + 8][2t..]
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < kMaxCo / 16; ++mt) {
    if (mt >= n_mt) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int v = v0 + warp * 16 + nt * 8 + t2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* o = out + static_cast<size_t>(mt * 16 + g + half * 8) * V;
        if (v < V) o[v] = acc[mt][nt][2 * half];
        if (v + 1 < V) o[v + 1] = acc[mt][nt][2 * half + 1];
      }
    }
  }
}

template <bool kCompact, int BV>
int launch(const bf16* xm, const bf16* x, const int* tap, const bf16* w, float* out,
           int V, int H, int Ci, int Co, int K, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      exp_bandmm_kernel<kCompact, BV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxBulkBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((V + BV - 1) / BV);
  exp_bandmm_kernel<kCompact, BV><<<grid, Layout<BV>::kThreads,
                                    smem_bytes(BV, H, Ci, Co, K), stream>>>(
      xm, x, tap, w, out, V, H, Ci, Co, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xm (Ci, V) or null; x (H, Ci, V), or null with H = 0; tap (H, V) int32;
// w (Co, K * Ci); out (Co, V) fp32; bf16 inputs 16-byte aligned.  Ci and
// Co multiples of 16, Co <= 64, K <= 32 (and K > 13 with xm), compact 0 or
// 1, bv 64 or 128.  Returns cudaErrorInvalidValue for another shape or
// plan, else the launch's cudaGetLastError().
extern "C" int exp_bandmm(const void* xm, const void* x, const void* tap, const void* w,
                          void* out, int V, int H, int Ci, int Co, int K, int compact,
                          int bv, void* stream) {
  const bool ok = Ci > 0 && Ci % 16 == 0 && Co > 0 && Co % 16 == 0 && Co <= kMaxCo &&
                  K > 0 && K <= kMaxTcBands && (xm == nullptr || K > kCenter) &&
                  H >= 0 && (bv == 64 || bv == 128) &&
                  smem_bytes(bv, H, Ci, Co, K) <= kMaxBulkBytes;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (V == 0) return static_cast<int>(cudaGetLastError());
  const bf16* xmb = static_cast<const bf16*>(xm);
  const bf16* xb = static_cast<const bf16*>(x);
  const int* tp = static_cast<const int*>(tap);
  const bf16* wb = static_cast<const bf16*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compact) {
    return bv == 128 ? launch<true, 128>(xmb, xb, tp, wb, o, V, H, Ci, Co, K, s)
                     : launch<true, 64>(xmb, xb, tp, wb, o, V, H, Ci, Co, K, s);
  }
  return bv == 128 ? launch<false, 128>(xmb, xb, tp, wb, o, V, H, Ci, Co, K, s)
                   : launch<false, 64>(xmb, xb, tp, wb, o, V, H, Ci, Co, K, s);
}
