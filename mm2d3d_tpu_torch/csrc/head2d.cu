// Fused 2D head (K5): composed 3x3 head conv + bias, crop, 5x5 average pool.
//
// Replaces the TPU kernel mm2d3d_tpu/ops/pallas/head2d.py::_kernel
// (called by head_pool -> _head_pool -> _head_pool_pallas).
//
// What it computes, for the decoder tail's pieces x_p (B, Hp, Wp, C_p),
// never concatenated, the composed weights w (3, 3, sum C_p, C2) and b (C2):
//   y[b, i, j, :]   = b + sum_{di, dj, c} x[b, i + di - 1, j + dj - 1, c]
//                         * w[di, dj, c, :]     (zero outside [0, Hp) x [0, Wp))
//                     for 0 <= i < h_real, 0 <= j < w_real;
//   out[b, i, j, :] = (1 / 25) * sum of y over the 5x5 window around (i, j),
//                     zero outside [0, h_real) x [0, w_real)
// -> out (B, h_real, w_real, C2) fp32.  The conv's zero padding is at the
// padded map's edge, not at the crop's: row h_real - 1 reads row h_real,
// which holds real decoder features.
//
// What bounds it on the H100: at the flagship (B = 8, 240 x 400, three
// 64-channel fp32 pieces, C2 = 12) it reads 590 MB (0.18 ms at 3.35 TB/s)
// for 2 * 8 * 225 * 400 * 9 * 192 * 12 = 29.9 GFLOP.  With bf16 products
// (compute type bf16, the flagship's) the bytes bound it: 0.03 ms of
// tensor-core work at the peak rate.  In fp32 the FLOPs do (0.45 ms at
// 67 TFLOP/s without TF32).
//
// Design, two passes in one launch sequence (the wrapper counts one launch):
//  1. conv + bias + crop into a (B, h_real, w_real, C2) fp32 scratch.
//     - bf16 compute: an implicit GEMM on tensor cores.  A block owns a
//       16 x 32 tile of output pixels (M = 512, 8 warps x 4 m16 tiles of 16
//       pixels of one row) and 16 output channels (N, two n8 tiles; C2 = 12
//       pads to 16, wider C2 takes more blocks); K = 9 taps x the input
//       channels in 16-channel chunks.  All the block's composed weights sit
//       in shared memory for the whole block, as the TPU kernel keeps w9 in
//       VMEM: the wrapper packs them to bf16 (NB, 9, Kp, 16), each piece's
//       channels padded to a multiple of 16 (9 x 192 x 16 x 2 B = 55 KB at
//       the flagship), and the block copies them once with cp.async.  Each
//       chunk's 18 x 34 halo is staged as bf16 [pixel][16 channels], 32
//       bytes a pixel with the two 16-byte halves swapped on every other
//       group of 4 pixels (so an ldmatrix phase of 8 consecutive pixels hits
//       8 distinct bank groups).  fp32 pieces are read as float4 and rounded
//       with __float2bfloat16 as they are stored; the next chunk's loads are
//       issued into registers before the current chunk's mma and stored
//       after it, into the other of two halo buffers.  Each tap (di, dj) is
//       then one ldmatrix per m16 tile whose row addresses are the tile's
//       pixels shifted by (di, dj): the im2col costs nothing.  The halo
//       re-read by neighbouring blocks is 1.2x the pieces' bytes, mostly
//       from L2.  mma.sync m16n8k16 bf16, fp32 sums in registers; bias and
//       crop in the epilogue.
//     - fp32 compute: CUDA cores (no TF32: the parity dtype), 8 x 32 tiles
//       of output pixels, one thread each, 16 output channels, the
//       16-channel halo chunk and its 9 x 16 x 16 weights in shared memory.
//  2. the 5x5 box sum in the JAX reference's order (the 5-row sums, then
//     the 5-column sums of those, times 1/25), over 8 x 32-pixel tiles of
//     up to 16 channels staged in shared memory with their 2-pixel
//     borders, each thread walking pixels over the block's channels: each
//     scratch element is read ~1.7 times (from L2: the 35 MB scratch fits
//     in the 50 MB L2), where one thread per output would read it 25 times.
// Keeping the conv's rows in shared memory for the pool is later work.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Pieces {
  const void* x0;
  const void* x1;
  const void* x2;
  int c0, c1, c2;  // channels of each piece; 0 = absent
};

// ---- pass 1, bf16 compute: tensor cores -----------------------------------

constexpr int kMH = 16;   // output rows per block
constexpr int kMW = 32;   // output columns per block
constexpr int kHW = kMW + 2;                  // halo columns
constexpr int kHaloPix = (kMH + 2) * kHW;     // 612
constexpr int kUnits = kHaloPix * 2;          // 16-byte halves of the halo
constexpr int kMmaThreads = 256;              // 8 warps
constexpr int kUPT = (kUnits + kMmaThreads - 1) / kMmaThreads;
constexpr int kHaloBytes = 2 * kHaloPix * 16 * static_cast<int>(sizeof(bf16));

// 8 channels of one pixel as loaded, before they are rounded and stored
template <typename T> struct Raw;
template <> struct Raw<float> { float4 lo, hi; };
template <> struct Raw<bf16> { uint4 v; };

// n_valid (0..8) channels from p, zeros after; vec: 16-byte aligned and 8
// channels present, so whole vectors load
__device__ __forceinline__ Raw<float> load_raw(const float* p, int n_valid, bool vec) {
  Raw<float> r;
  if (vec && n_valid == 8) {
    r.lo = __ldg(reinterpret_cast<const float4*>(p));
    r.hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  } else {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n_valid ? p[j] : 0.f;
    r.lo = make_float4(v[0], v[1], v[2], v[3]);
    r.hi = make_float4(v[4], v[5], v[6], v[7]);
  }
  return r;
}

__device__ __forceinline__ Raw<bf16> load_raw(const bf16* p, int n_valid, bool vec) {
  Raw<bf16> r;
  if (vec && n_valid == 8) {
    r.v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n_valid ? q[j] : 0u;
    r.v = make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                     v[4] | (v[5] << 16), v[6] | (v[7] << 16));
  }
  return r;
}

__device__ __forceinline__ uint4 to_bf16x8(const Raw<float>& r) {
  return make_uint4(pack_bf16x2(r.lo.x, r.lo.y), pack_bf16x2(r.lo.z, r.lo.w),
                    pack_bf16x2(r.hi.x, r.hi.y), pack_bf16x2(r.hi.z, r.hi.w));
}
__device__ __forceinline__ uint4 to_bf16x8(const Raw<bf16>& r) { return r.v; }

// element offset of 16-byte half h of row `row` (16 bf16 a row): the halves
// swap on every other group of 4 rows
__device__ __forceinline__ int swz(int row, int h) {
  return row * 16 + ((h ^ ((row >> 2) & 1)) << 3);
}

template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 2)
head_conv_mma_kernel(Pieces pieces, const bf16* __restrict__ wpk,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int Hp, int Wp, int h_real, int w_real, int C2, int n_oc,
                     int Kp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);   // [9 * Kp][16], swizzled
  bf16* xs = ws + 9 * Kp * 16;                     // [2][kHaloPix][16], swizzled
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z / n_oc;
  const int ob = blockIdx.z - b * n_oc;
  const int i0 = blockIdx.y * kMH, j0 = blockIdx.x * kMW;

  // the block's weights, once: rows t * Kp + k of 16 output channels
  {
    const bf16* src = wpk + static_cast<size_t>(ob) * 9 * Kp * 16;
    for (int u = tid; u < 9 * Kp * 2; u += kMmaThreads) {
      cp_async16(ws + swz(u >> 1, u & 1), src + u * 8, true);
    }
    cp_async_commit();
  }

  // this thread's halo units: pixel offset in the piece (-1 outside the map)
  int off[kUPT];
#pragma unroll
  for (int i = 0; i < kUPT; ++i) {
    const int u = tid + i * kMmaThreads;
    const int pix = u >> 1;
    const int r = pix / kHW, q = pix - r * kHW;
    const int gi = i0 - 1 + r, gj = j0 - 1 + q;
    off[i] = (u < kUnits && gi >= 0 && gi < Hp && gj >= 0 && gj < Wp)
                 ? (b * Hp + gi) * Wp + gj : -1;
  }
  const int n0c = (pieces.c0 + 15) >> 4, n1c = (pieces.c1 + 15) >> 4;
  const int nch = n0c + n1c + ((pieces.c2 + 15) >> 4);
  constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));

  Raw<T> raw[kUPT];
  auto fetch = [&](int ch) {
    // selected, not indexed: an indexed parameter struct goes to the stack
    const int p = ch < n0c ? 0 : (ch < n0c + n1c ? 1 : 2);
    const int cp = p == 0 ? pieces.c0 : (p == 1 ? pieces.c1 : pieces.c2);
    const T* x = static_cast<const T*>(
        p == 0 ? pieces.x0 : (p == 1 ? pieces.x1 : pieces.x2));
    const int cc0 = (ch - (p == 0 ? 0 : (p == 1 ? n0c : n0c + n1c))) * 16;
    const bool vec = cp % kVecElems == 0
        && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
#pragma unroll
    for (int i = 0; i < kUPT; ++i) {
      const int c = cc0 + ((tid + i * kMmaThreads) & 1) * 8;
      const int n_valid = off[i] < 0 ? 0 : max(0, min(8, cp - c));
      raw[i] = load_raw(n_valid ? x + static_cast<size_t>(off[i]) * cp + c : x,
                        n_valid, vec);
    }
  };
  auto stash = [&](int buf) {
    bf16* dst = xs + buf * kHaloPix * 16;
#pragma unroll
    for (int i = 0; i < kUPT; ++i) {
      const int u = tid + i * kMmaThreads;
      if (u < kUnits) {
        *reinterpret_cast<uint4*>(dst + swz(u >> 1, u & 1)) = to_bf16x8(raw[i]);
      }
    }
  };

  float acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  if (nch > 0) fetch(0);
  stash(0);
  cp_async_wait<0>();
  __syncthreads();
  const int half = lane >> 4, l16 = lane & 15;
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) fetch(ch + 1);
    const bf16* xb = xs + (ch & 1) * kHaloPix * 16;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int di = t / 3, dj = t - di * 3;
      uint32_t bw[4];
      ldmatrix_x4_trans(bw, ws + swz(t * Kp + ch * 16 + l16, half));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int pix = (warp * 2 + (m >> 1) + di) * kHW + (m & 1) * 16 + l16 + dj;
        uint32_t a[4];
        ldmatrix_x4(a, xb + swz(pix, half));
        mma_bf16(acc[m][0], a, bw[0], bw[1]);
        mma_bf16(acc[m][1], a, bw[2], bw[3]);
      }
    }
    if (ch + 1 < nch) stash((ch + 1) & 1);
    __syncthreads();
  }

  const int gr = lane >> 2, tc = (lane & 3) * 2;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + warp * 2 + (m >> 1);
    if (i >= h_real) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + (m & 1) * 16 + gr + h * 8;
      if (j >= w_real) continue;
      float* yr = y + ((static_cast<size_t>(b) * h_real + i) * w_real + j) * C2;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int o = ob * 16 + n * 8 + tc;
        if (o < C2) yr[o] = acc[m][n][2 * h] + bias[o];
        if (o + 1 < C2) yr[o + 1] = acc[m][n][2 * h + 1] + bias[o + 1];
      }
    }
  }
}

// ---- pass 1, fp32 compute: CUDA cores --------------------------------------

constexpr int kTH = 8;    // output rows per block
constexpr int kTW = 32;   // output columns per block
constexpr int kCC = 16;   // input channels staged per step
constexpr int kOC = 16;   // output channels per block

template <typename T>
__global__ void __launch_bounds__(kTH * kTW)
head_conv_kernel(Pieces pieces, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int Hp, int Wp, int h_real, int w_real, int Cin, int C2,
                 int n_oc) {
  __shared__ float xs[kCC][kTH + 2][kTW + 2];
  __shared__ __align__(16) float ws[9][kCC][kOC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int b = blockIdx.z / n_oc;
  const int oc0 = (blockIdx.z - b * n_oc) * kOC;
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;

  float acc[kOC];
#pragma unroll
  for (int o = 0; o < kOC; ++o) acc[o] = 0.f;

  int cbase = 0;
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    // selected, not indexed: an indexed parameter struct goes to the stack
    const int cp = p == 0 ? pieces.c0 : (p == 1 ? pieces.c1 : pieces.c2);
    const T* x = static_cast<const T*>(
        p == 0 ? pieces.x0 : (p == 1 ? pieces.x1 : pieces.x2));
    for (int cc0 = 0; cc0 < cp; cc0 += kCC) {
      // the halo tile: rows i0 - 1 .. i0 + kTH, columns j0 - 1 .. j0 + kTW
      for (int e = tid; e < kCC * (kTH + 2) * (kTW + 2); e += kTH * kTW) {
        const int c = e % kCC, pix = e / kCC;
        const int r = pix / (kTW + 2), q = pix - r * (kTW + 2);
        const int gi = i0 - 1 + r, gj = j0 - 1 + q;
        float v = 0.f;
        if (gi >= 0 && gi < Hp && gj >= 0 && gj < Wp && cc0 + c < cp) {
          v = to_float(x[((static_cast<size_t>(b) * Hp + gi) * Wp + gj) * cp
                         + cc0 + c]);
        }
        xs[c][r][q] = v;
      }
      for (int e = tid; e < 9 * kCC * kOC; e += kTH * kTW) {
        const int o = e % kOC, c = (e / kOC) % kCC, t = e / (kOC * kCC);
        ws[t][c][o] = (cc0 + c < cp && oc0 + o < C2)
            ? w[(static_cast<size_t>(t) * Cin + cbase + cc0 + c) * C2 + oc0 + o]
            : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int t = 0; t < 9; ++t) {
        const int di = t / 3, dj = t - di * 3;
#pragma unroll 4
        for (int c = 0; c < kCC; ++c) {
          const float xv = xs[c][ty + di][tx + dj];
          const float4* wr = reinterpret_cast<const float4*>(ws[t][c]);
#pragma unroll
          for (int q = 0; q < kOC / 4; ++q) {
            const float4 wq = wr[q];
            acc[4 * q + 0] = fmaf(xv, wq.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv, wq.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv, wq.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv, wq.w, acc[4 * q + 3]);
          }
        }
      }
      __syncthreads();
    }
    cbase += cp;
  }

  const int i = i0 + ty, j = j0 + tx;
  if (i < h_real && j < w_real) {
    float* yr = y + ((static_cast<size_t>(b) * h_real + i) * w_real + j) * C2;
#pragma unroll
    for (int o = 0; o < kOC; ++o) {
      if (oc0 + o < C2) yr[oc0 + o] = acc[o] + bias[oc0 + o];
    }
  }
}

// ---- pass 2: the 5x5 box ---------------------------------------------------

constexpr int kPH = 8;    // pooled rows per block
constexpr int kPW = 32;   // pooled columns per block
constexpr int kPC = 16;   // channels per block
constexpr int kPCS = kPC + 1;  // padded channel stride: no bank conflicts
constexpr int kPoolThreads = 256;

// A block owns kPH x kPW outputs of up to kPC channels: it stages the
// (kPH + 4) x (kPW + 4) window of y (zeros outside [0, h) x [0, w)), takes
// the 5-row sums, then the 5-column sums of those, in the reference's
// order.  Threads walk pixels (divisions by constants only), each over the
// block's channels.
__global__ void __launch_bounds__(kPoolThreads)
head_box_kernel(const float* __restrict__ y, float* __restrict__ out, int h,
                int w, int C2, int n_pc) {
  __shared__ float ys[(kPH + 4) * (kPW + 4) * kPCS];
  __shared__ float vs[kPH * (kPW + 4) * kPCS];
  const int tid = threadIdx.x;
  const int b = blockIdx.z / n_pc;
  const int o0 = (blockIdx.z - b * n_pc) * kPC;
  const int nc = min(kPC, C2 - o0);
  const int i0 = blockIdx.y * kPH, j0 = blockIdx.x * kPW;
  const float* yb = y + static_cast<size_t>(b) * h * w * C2 + o0;
  for (int p = tid; p < (kPH + 4) * (kPW + 4); p += kPoolThreads) {
    const int gi = i0 - 2 + p / (kPW + 4), gj = j0 - 2 + p % (kPW + 4);
    const bool in = gi >= 0 && gi < h && gj >= 0 && gj < w;
    const float* src = yb + (static_cast<size_t>(in ? gi : 0) * w + (in ? gj : 0)) * C2;
    for (int c = 0; c < nc; ++c) ys[p * kPCS + c] = in ? __ldg(src + c) : 0.f;
  }
  __syncthreads();
  constexpr int kRow = (kPW + 4) * kPCS;  // one staged row
  for (int p = tid; p < kPH * (kPW + 4); p += kPoolThreads) {
    const float* col = ys + p * kPCS;
    for (int c = 0; c < nc; ++c) {
      vs[p * kPCS + c] = col[c] + col[kRow + c] + col[2 * kRow + c]
                         + col[3 * kRow + c] + col[4 * kRow + c];
    }
  }
  __syncthreads();
  float* ob = out + static_cast<size_t>(b) * h * w * C2 + o0;
  for (int p = tid; p < kPH * kPW; p += kPoolThreads) {
    const int r = p / kPW, q = p % kPW;
    const int i = i0 + r, j = j0 + q;
    if (i >= h || j >= w) continue;
    const float* row = vs + (r * (kPW + 4) + q) * kPCS;
    float* dst = ob + (static_cast<size_t>(i) * w + j) * C2;
    for (int c = 0; c < nc; ++c) {
      dst[c] = (row[c] + row[kPCS + c] + row[2 * kPCS + c] + row[3 * kPCS + c]
                + row[4 * kPCS + c]) * (1.f / 25.f);
    }
  }
}

template <typename T>
int launch_conv(const Pieces& pieces, const void* w, const float* bias, float* y,
                int B, int Hp, int Wp, int h_real, int w_real, int C2,
                int tensor_cores, cudaStream_t stream) {
  if (tensor_cores) {
    const int kp = 16 * (((pieces.c0 + 15) >> 4) + ((pieces.c1 + 15) >> 4)
                         + ((pieces.c2 + 15) >> 4));
    const int n_oc = (C2 + 15) / 16;
    const int bytes = 9 * kp * 16 * static_cast<int>(sizeof(bf16)) + kHaloBytes;
    const cudaError_t attr = cudaFuncSetAttribute(
        head_conv_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((w_real + kMW - 1) / kMW, (h_real + kMH - 1) / kMH, B * n_oc);
    head_conv_mma_kernel<T><<<grid, kMmaThreads, bytes, stream>>>(
        pieces, static_cast<const bf16*>(w), bias, y, Hp, Wp, h_real, w_real, C2,
        n_oc, kp);
  } else {
    const int cin = pieces.c0 + pieces.c1 + pieces.c2;
    const int n_oc = (C2 + kOC - 1) / kOC;
    const dim3 grid((w_real + kTW - 1) / kTW, (h_real + kTH - 1) / kTH, B * n_oc);
    head_conv_kernel<T><<<grid, dim3(kTW, kTH), 0, stream>>>(
        pieces, static_cast<const float*>(w), bias, y, Hp, Wp, h_real, w_real,
        cin, C2, n_oc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0, x1, x2 (B, Hp, Wp, c_p) NHWC in fp32 (dtype 0) or bf16 (dtype 1), c_p
// = 0 for an absent piece; bias (C2) fp32; y (B, h_real, w_real, C2) fp32
// scratch; out the same shape, fp32.  With tensor_cores (bf16 compute), w is
// the packed bf16 (ceil(C2 / 16), 9, Kp, 16) of ops/kernels/head2d.py
// (Kp = the pieces' channels, each rounded up to 16); otherwise w is the
// fp32 (3, 3, c0 + c1 + c2, C2).  passes: 1 = the conv into y, 2 = the pool
// of y into out, 3 = both.  Returns the first cudaGetLastError() that is
// not cudaSuccess.
extern "C" int head_pool(const void* x0, const void* x1, const void* x2,
                         int c0, int c1, int c2, const void* w,
                         const void* bias, void* y, void* out, int B, int Hp,
                         int Wp, int h_real, int w_real, int C2, int dtype,
                         int tensor_cores, int passes, void* stream) {
  if (B == 0 || h_real == 0 || w_real == 0 || C2 == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  Pieces pieces{x0, x1, x2, c0, c1, c2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  if (passes & 1) {
    const int err = dtype == kBFloat16
        ? launch_conv<bf16>(pieces, w, bf, yf, B, Hp, Wp, h_real, w_real, C2,
                            tensor_cores, s)
        : launch_conv<float>(pieces, w, bf, yf, B, Hp, Wp, h_real, w_real, C2,
                             tensor_cores, s);
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    const int n_pc = (C2 + kPC - 1) / kPC;
    const dim3 grid((w_real + kPW - 1) / kPW, (h_real + kPH - 1) / kPH, B * n_pc);
    head_box_kernel<<<grid, kPoolThreads, 0, s>>>(
        yf, static_cast<float*>(out), h_real, w_real, C2, n_pc);
  }
  return static_cast<int>(cudaGetLastError());
}
