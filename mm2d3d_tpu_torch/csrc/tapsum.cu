// Dense 27-tap contraction of the submanifold convolution (K6).
//
// Replaces the TPU kernel mm2d3d_tpu/ops/pallas/tapsum.py::_kernel
// (called by tapsum -> _tapsum_pallas).
//
// What it computes:
//   out[v, :] = sum_k g[k, v, :] @ w[k]        (K taps, here 27)
// with g (K, V, Ci) the gathered neighbourhood rows, w (K, Ci, Co) and out
// (V, Co) fp32 whatever the input type (fp32 or bf16).  Any V, Ci, Co.
// Seen as one matrix product: out = G @ W with G[v, k * Ci + ci] =
// g[k, v, ci] and W = w reshaped (K * Ci, Co), a reduction over R = K * Ci.
//
// What bounds it on the H100: bytes, in bf16.  At the flagship level 0
// (V = 65,536, Ci = Co = 16) it reads 56.6 MB of g and writes 4.2 MB for
// 0.9 GFLOP: ~15 FLOP per byte, far under the tensor cores' ridge (~295);
// the HBM floor is ~18 us.  At the level-5 decoder concat (V = 4,096,
// Ci = 192, Co = 96) it reads 42 MB for 4.1 GFLOP (~100 FLOP per byte):
// still the bytes' side in bf16, but ~60 TFLOP/s at the byte bound, near
// the whole fp32 CUDA-core rate, so only tensor cores can get close.
//
// Two kernels, chosen by the launcher from the type and the shape:
//
// 1. bf16 with Ci % 8 == 0 (every dense conv of the flagship but the input
//    conv's forward): tensor cores.  A block owns 64 voxels (4 warps x 16)
//    and BN = 8 * NT output channels (NT even, at most 16; wider Co takes
//    several column blocks).  It walks the reduction in stages of 64
//    (16-byte chunks of 8 channels never straddle a tap, since Ci % 8 ==
//    0) through a 4-deep ring in shared memory, filled by cp.async 16-byte
//    copies that zero-fill the ragged V, R and Co edges, three stages in
//    flight while the warps multiply the fourth.  Where 128-voxel tiles
//    alone fill the card (levels 0-2), 128 voxels (8 warps) walk stages of
//    128 through a 3-deep ring instead.  Each warp takes its A
//    fragment with one ldmatrix and the W fragments with ldmatrix.trans (W
//    is row-major (R, Co)), and runs mma.sync m16n8k16 bf16 with the fp32
//    sums in registers.  Rows of A and W are padded by 16 bytes, so every
//    ldmatrix phase reads 8 distinct bank groups.  Co % 8 != 0 (the input
//    conv's adjoint: Co = 3) stages W with plain loads instead.
//    Deterministic split-K: where the 64-voxel row tiles leave the card's
//    132 SMs short (levels 4-6: V = 2,048-8,192), the wrapper's plan splits
//    the taps into S groups (grid z); group s writes its fp32 partial to
//    scratch[s] and a second small kernel sums the partials in the order
//    s = 0 .. S-1, so the result is the same bits from call to call (no
//    atomics).  The plan (S, BM, BN) comes from the wrapper
//    (ops/kernels/tapsum.py::tapsum_plan), which also allocates the scratch.
// 2. fp32, or Ci % 8 != 0 (the input conv's forward, Ci = 3): CUDA cores.
//    One block owns 32 voxels and 16 or 32
//    output channels (one warp per 8 channels) and walks the R reduction
//    rows in stages of 32: each stage stages the tile's G rows (as fp32,
//    transposed to [r][v] with a padded row) and the matching 32 rows of W
//    in shared memory; each thread owns one voxel and 8 output channels.
//    fp32 stays off the tensor cores: TF32 would not hold the 1e-4
//    tolerance against the plain version.
// TMA/wgmma and the gather inside the kernel (reading x and the
// neighbour table instead of the gathered g) are later work.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- 1. tensor cores (bf16, Ci % 8 == 0) ----------------------------------

// Two tiles, chosen by the wrapper's plan (bm): 64 voxels, stages of 64
// reduction elements, a 4-deep ring; or, where 128-voxel tiles alone give
// every SM a block (levels 0-2 of the flagship: shallow Ci, long V), 128
// voxels, stages of 128, a 3-deep ring: fewer, longer blocks with twice
// the bytes in flight each.
template <int BM, int BK, int STAGES>
struct Tile {
  static constexpr int kThreads = BM * 2;        // one warp per 16 rows
  static constexpr int kAStride = BK + 8;        // bf16 per A row in smem
  static constexpr int kAChunks = BK / 8;        // 16-byte chunks per A row
  static constexpr int kARows = kThreads / kAChunks;  // A rows per pass
  template <int NT>
  static constexpr int smem_bytes() {
    return STAGES * (BM * kAStride + BK * (NT * 8 + 8)) *
           static_cast<int>(sizeof(bf16));
  }
};

template <int NT, int BM, int BK, int STAGES>
__global__ void __launch_bounds__(BM * 2)
tapsum_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
                  float* __restrict__ out, int K, int V, int Ci, int Co,
                  int splits) {
  using T = Tile<BM, BK, STAGES>;
  constexpr int BN = NT * 8;
  constexpr int kAStride = T::kAStride;
  constexpr int kBStride = BN + 8;  // bf16 per W row in shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);   // [stage][BM][kAStride]
  bf16* bs = as + STAGES * BM * kAStride;         // [stage][BK][kBStride]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int r_begin = split * K / splits * Ci;
  const int r_end = (split + 1) * K / splits * Ci;
  const int n_stages = (r_end - r_begin + BK - 1) / BK;
  const bool w_vec = (Co & 7) == 0;
  const size_t plane = static_cast<size_t>(V) * Ci;
  // this thread's A copies: chunk a_j (8 channels) of rows a_m + kARows i
  const int a_j = tid % T::kAChunks, a_m = tid / T::kAChunks;

  auto load_stage = [&](int s, int slot) {
    const int r0 = r_begin + s * BK;
    const int r = r0 + a_j * 8;
    const bool rin = r < r_end;
    const int k = rin ? r / Ci : 0;
    const bf16* src = g + k * plane + (r - k * Ci);
    bf16* adst = as + slot * BM * kAStride + a_j * 8;
#pragma unroll
    for (int i = 0; i < BM / T::kARows; ++i) {
      const int m = a_m + T::kARows * i;
      const bool ok = rin && v0 + m < V;
      cp_async16(adst + m * kAStride,
                 ok ? src + static_cast<size_t>(v0 + m) * Ci : g, ok);
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

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s, s);
    cp_async_commit();
  }
  const int a_off = (warp * 16 + (lane & 15)) * kAStride + (lane >> 4) * 8;
  const int b_off = (lane & 15) * kBStride + (lane >> 4) * 8;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    // stage s has landed for every thread, and every warp is done with the
    // slot the next load overwrites (stage s - 1's)
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

  float* dst = out + static_cast<size_t>(split) * V * Co;
  const int gr = lane >> 2, tc = (lane & 3) * 2;
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
__global__ void tapsum_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * n + i];
  out[i] = s;
}

template <int NT, int BM, int BK, int STAGES>
int launch_tc(const bf16* g, const bf16* w, float* out, float* scratch, int K,
              int V, int Ci, int Co, int splits, cudaStream_t stream) {
  constexpr int bytes = Tile<BM, BK, STAGES>::template smem_bytes<NT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      tapsum_mma_kernel<NT, BM, BK, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_col = (Co + NT * 8 - 1) / (NT * 8);
  const dim3 grid((V + BM - 1) / BM, n_col, splits);
  float* dst = splits > 1 ? scratch : out;
  tapsum_mma_kernel<NT, BM, BK, STAGES><<<grid, BM * 2, bytes, stream>>>(
      g, w, dst, K, V, Ci, Co, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(V) * Co;
  tapsum_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      scratch, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BK, int STAGES>
int launch_tc_bn(const bf16* g, const bf16* w, float* out, float* scratch,
                 int K, int V, int Ci, int Co, int splits, int bn,
                 cudaStream_t s) {
  switch (bn / 8) {
    case 2: return launch_tc<2, BM, BK, STAGES>(g, w, out, scratch, K, V, Ci, Co, splits, s);
    case 4: return launch_tc<4, BM, BK, STAGES>(g, w, out, scratch, K, V, Ci, Co, splits, s);
    case 6: return launch_tc<6, BM, BK, STAGES>(g, w, out, scratch, K, V, Ci, Co, splits, s);
    case 8: return launch_tc<8, BM, BK, STAGES>(g, w, out, scratch, K, V, Ci, Co, splits, s);
    case 10: return launch_tc<10, BM, BK, STAGES>(g, w, out, scratch, K, V, Ci, Co, splits, s);
    case 12: return launch_tc<12, BM, BK, STAGES>(g, w, out, scratch, K, V, Ci, Co, splits, s);
    case 14: return launch_tc<14, BM, BK, STAGES>(g, w, out, scratch, K, V, Ci, Co, splits, s);
    default: return launch_tc<16, BM, BK, STAGES>(g, w, out, scratch, K, V, Ci, Co, splits, s);
  }
}

// ---- 2. CUDA cores (fp32, or Ci % 8 != 0) ---------------------------------

constexpr int kBV = 32;   // voxels per block: one per lane
constexpr int kRC = 32;   // reduction rows per stage
constexpr int kCPT = 8;   // output channels per thread (one warp per group)

template <typename T, int kBC>
__global__ void __launch_bounds__(32 * (kBC / kCPT))
tapsum_kernel(const T* __restrict__ g, const T* __restrict__ w,
              float* __restrict__ out, int K, int V, int Ci, int Co) {
  constexpr int kThreads = 32 * (kBC / kCPT);
  constexpr int kVStep = kThreads / kRC;
  __shared__ float gs[kRC][kBV + 1];
  __shared__ __align__(16) float ws[kRC][kBC];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = tid >> 5;
  const int v0 = blockIdx.x * kBV;
  const int co0 = blockIdx.y * kBC;
  const int R = K * Ci;
  const size_t plane = static_cast<size_t>(V) * Ci;
  // staging: this thread's reduction row of each stage, and its voxels
  const int rl_s = tid % kRC;
  const int vl_s = tid / kRC;

  float acc[kCPT];
#pragma unroll
  for (int j = 0; j < kCPT; ++j) acc[j] = 0.f;

  for (int r0 = 0; r0 < R; r0 += kRC) {
    // G[v0 : v0 + kBV, r0 : r0 + kRC] (G[v, k * Ci + ci] = g[k, v, ci]):
    // consecutive lanes read consecutive channels of one voxel's taps
    const int r = r0 + rl_s;
    const int k = r < R ? r / Ci : 0;
    const T* src = g + k * plane + (r - k * Ci);
#pragma unroll
    for (int vl = vl_s; vl < kBV; vl += kVStep) {
      const int v = v0 + vl;
      gs[rl_s][vl] = (r < R && v < V)
                         ? to_float(src[static_cast<size_t>(v) * Ci]) : 0.f;
    }
    for (int e = tid; e < kRC * kBC; e += kThreads) {
      const int rl = e / kBC, cl = e - rl * kBC;
      const int rw = r0 + rl, co = co0 + cl;
      ws[rl][cl] = (rw < R && co < Co)
                       ? to_float(w[static_cast<size_t>(rw) * Co + co]) : 0.f;
    }
    __syncthreads();
    const int nr = min(kRC, R - r0);
    for (int rl = 0; rl < nr; ++rl) {
      const float xv = gs[rl][lane];
      const float4 wa = *reinterpret_cast<const float4*>(&ws[rl][cg * kCPT]);
      const float4 wb = *reinterpret_cast<const float4*>(&ws[rl][cg * kCPT + 4]);
      const float wv[kCPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < kCPT; ++j) acc[j] = fmaf(xv, wv[j], acc[j]);
    }
    __syncthreads();
  }

  const int v = v0 + lane;
  if (v < V) {
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int co = co0 + cg * kCPT + j;
      if (co < Co) out[static_cast<size_t>(v) * Co + co] = acc[j];
    }
  }
}

template <typename T, int kBC>
int launch_simt(const void* g, const void* w, void* out, int K, int V, int Ci,
                int Co, cudaStream_t stream) {
  const dim3 grid((V + kBV - 1) / kBV, (Co + kBC - 1) / kBC);
  tapsum_kernel<T, kBC><<<grid, 32 * (kBC / kCPT), 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<float*>(out), K, V, Ci, Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (K, V, Ci), w (K, Ci, Co) in fp32 (dtype 0) or bf16 (dtype 1); out
// (V, Co) fp32.  (splits, bm, bn) is the wrapper's plan: for bf16 with
// Ci % 8 == 0 (tensor cores) bm = 64 or 128, bn = 16 .. 128 in steps of 16,
// and scratch (splits, V, Co) fp32 when splits > 1; otherwise splits = 1,
// bm = 32, bn = 16 or 32 and no scratch.  A plan that does not match the
// route returns cudaErrorInvalidValue.  Returns the first cudaGetLastError()
// that is not cudaSuccess.
extern "C" int tapsum(const void* g, const void* w, void* out, void* scratch,
                      int K, int V, int Ci, int Co, int dtype, int splits,
                      int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == kBFloat16 && Ci % 8 == 0;
  const bool plan_ok = tc
      ? ((bm == 64 || bm == 128) && bn % 16 == 0 && bn >= 16 && bn <= 128
         && splits >= 1 && splits <= K && (splits == 1 || scratch != nullptr))
      : (bm == kBV && (bn == 16 || bn == 32) && splits == 1);
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (V == 0 || Co == 0) return static_cast<int>(cudaGetLastError());
  if (tc) {
    const bf16* gb = static_cast<const bf16*>(g);
    const bf16* wb = static_cast<const bf16*>(w);
    float* o = static_cast<float*>(out);
    float* sc = static_cast<float*>(scratch);
    return bm == 128
        ? launch_tc_bn<128, 128, 3>(gb, wb, o, sc, K, V, Ci, Co, splits, bn, s)
        : launch_tc_bn<64, 64, 4>(gb, wb, o, sc, K, V, Ci, Co, splits, bn, s);
  }
  if (dtype == kBFloat16) {
    return bn == 16 ? launch_simt<bf16, 16>(g, w, out, K, V, Ci, Co, s)
                    : launch_simt<bf16, 32>(g, w, out, K, V, Ci, Co, s);
  }
  return bn == 16 ? launch_simt<float, 16>(g, w, out, K, V, Ci, Co, s)
                  : launch_simt<float, 32>(g, w, out, K, V, Ci, Co, s);
}
