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
// which holds real decoder features.  With `round_bf16` each input element
// is rounded to bf16 as it is loaded (the weights arrive rounded), so fp32
// pieces give the products of bf16 inputs, accumulated in fp32.
//
// What bounds it on the H100: at the flagship (B = 8, 240 x 400, three
// 64-channel pieces, C2 = 12) it reads 590 MB of fp32 pieces (0.18 ms at
// 3.35 TB/s) for 2 * 8 * 225 * 400 * 9 * 192 * 12 = 29.9 GFLOP: in fp32 the
// FLOPs bound it (0.45 ms at 67 TFLOP/s), with bf16 products on tensor
// cores the bytes would.
//
// Design, two passes in one launch sequence (the wrapper counts one launch):
//  1. conv + bias + crop into a (B, h_real, w_real, C2) fp32 scratch.  A
//     block owns an 8 x 32 tile of output pixels (one thread each) and 16
//     output channels.  For each 16-channel chunk of each piece it stages
//     the tile's 10 x 34 halo ([c][row][col], so a warp reads 32
//     consecutive floats) and the chunk's 9 x 16 x 16 weights in shared
//     memory (~31 KB); each thread then runs 9 x 16 x 16 FMAs with the 16
//     fp32 sums in registers, reading the weights as float4 broadcasts.
//     The halo is re-read by neighbouring blocks (~1.4x the pieces' bytes,
//     mostly from L2).
//  2. the 5x5 box sum, one thread per output element, rows then columns in
//     the JAX reference's order, times 1/25.  The 35 MB scratch stays in
//     the 50 MB L2.
// Tensor cores (mma/wgmma on bf16 tiles) and keeping the conv's rows in
// shared memory for the pool are later work.
#include "common.cuh"

namespace {

constexpr int kTH = 8;    // output rows per block
constexpr int kTW = 32;   // output columns per block
constexpr int kCC = 16;   // input channels staged per step
constexpr int kOC = 16;   // output channels per block

struct Pieces {
  const void* x0;
  const void* x1;
  const void* x2;
  int c0, c1, c2;  // channels of each piece; 0 = absent
};

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__global__ void __launch_bounds__(kTH * kTW)
head_conv_kernel(Pieces pieces, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int Hp, int Wp, int h_real, int w_real, int Cin, int C2,
                 int n_oc, int round_bf16) {
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
          if (round_bf16) v = round_to_bf16(v);
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

__global__ void head_box_kernel(const float* __restrict__ y,
                                float* __restrict__ out, int B, int h, int w,
                                int C2) {
  const size_t n = static_cast<size_t>(B) * h * w * C2;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int o = static_cast<int>(idx % C2);
  size_t rest = idx / C2;
  const int j = static_cast<int>(rest % w);
  rest /= w;
  const int i = static_cast<int>(rest % h);
  const size_t b = rest / h;
  float acc = 0.f;
  for (int dj = -2; dj <= 2; ++dj) {
    const int jj = j + dj;
    if (jj < 0 || jj >= w) continue;
    float col = 0.f;
    for (int di = -2; di <= 2; ++di) {
      const int ii = i + di;
      if (ii >= 0 && ii < h) col += y[((b * h + ii) * w + jj) * C2 + o];
    }
    acc += col;
  }
  out[idx] = acc * (1.f / 25.f);
}

template <typename T>
int launch(const Pieces& pieces, const float* w, const float* bias, float* y,
           float* out, int B, int Hp, int Wp, int h_real, int w_real, int C2,
           int round_bf16, cudaStream_t stream) {
  const int cin = pieces.c0 + pieces.c1 + pieces.c2;
  const int n_oc = (C2 + kOC - 1) / kOC;
  const dim3 block(kTW, kTH);
  const dim3 grid((w_real + kTW - 1) / kTW, (h_real + kTH - 1) / kTH, B * n_oc);
  head_conv_kernel<T><<<grid, block, 0, stream>>>(
      pieces, w, bias, y, Hp, Wp, h_real, w_real, cin, C2, n_oc, round_bf16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * h_real * w_real * C2;
  const int threads = 256;
  head_box_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads,
                    0, stream>>>(y, out, B, h_real, w_real, C2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0, x1, x2 (B, Hp, Wp, c_p) NHWC in fp32 (dtype 0) or bf16 (dtype 1), c_p
// = 0 for an absent piece; w (3, 3, c0 + c1 + c2, C2) and bias (C2) fp32;
// y (B, h_real, w_real, C2) fp32 scratch; out the same shape, fp32.
// Returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int head_pool(const void* x0, const void* x1, const void* x2,
                         int c0, int c1, int c2, const void* w,
                         const void* bias, void* y, void* out, int B, int Hp,
                         int Wp, int h_real, int w_real, int C2, int dtype,
                         int round_bf16, void* stream) {
  if (B == 0 || h_real == 0 || w_real == 0 || C2 == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  Pieces pieces{x0, x1, x2, c0, c1, c2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  float* of = static_cast<float*>(out);
  if (dtype == kBFloat16) {
    return launch<__nv_bfloat16>(pieces, wf, bf, yf, of, B, Hp, Wp, h_real,
                                 w_real, C2, round_bf16, s);
  }
  return launch<float>(pieces, wf, bf, yf, of, B, Hp, Wp, h_real, w_real, C2,
                       round_bf16, s);
}
