// Train-form BatchNorm over (M, C) rows with its epilogue: the 2D branch's
// over NHWC pixels and, with a row mask, the 3D branch's over voxel rows.
//
// Replaces no pallas_call: it stands for flax's nn.BatchNorm in train mode
// (mm2d3d_tpu/models/resnet2d.py:61, net2d.py:124 and :143) and for the
// masked BatchNorm of the sparse U-Net (mm2d3d_tpu/models/sparse_unet.py),
// which XLA fuses on the TPU, followed by the caller's ReLU or residual add
// and ReLU.  Per channel c over the M rows of x (bf16 or fp32, channels
// minor, rows `ldx` elements apart so a channel slice of a wider tensor is
// read in place), and over the n = max(sum(valid), 1) rows that a row mask
// `valid` keeps where one is given (every row without one, n = M):
//
//   mean = sum(x) / n,  var = max(sum(x^2) / n - mean^2, 0)    (kept rows)
//   rstd = 1 / sqrt(var + eps),  scale = rstd * weight
//   y = (x - mean) * scale + bias  [+ identity]  [ReLU]        (every row)
//   running_mean = 0.9 running_mean + 0.1 mean (running_var alike, in place)
//
// and the gradient, with g = dy where the ReLU passed (its bit, kept by the
// forward) and 0 elsewhere, every sum over all M rows (y depends on the
// statistics at every row, the statistics on the kept rows only):
//
//   dbias = sum(g),  dweight = rstd * sum(g (x - mean)),  d(identity) = g
//   dx = weight rstd (g - [kept] (sum(g) / n + keep (x - mean) rstd^2 sum(g (x - mean)) / n))
//
// where keep is 0 in a channel whose raw variance came out negative (the
// clamp's gradient is 0 there, as torch.clamp's backward gives); with a row
// mask keep is 1 (the masked form's variance is a sum of squares, which the
// clamp meets only at round-off) and [kept] is 0 at a row the mask drops.
//
// What bounds it on the H100: bytes.  Per element the forward reads x twice
// (2 B each in bf16) and writes y once (4 B, or 2 B where a convolution is
// the only reader) and one mask bit; the backward reads dy (4 B), x and the
// bit twice and writes dx (2 B), and d(identity) (4 B) after a residual:
// ~22 B.  At the flagship's stride-1 64-channel shape with a ReLU (16 x 240
// x 400 rows, 98 M elements) that is 2.2 GB: ~0.65 ms at 3.35 TB/s.  The
// row mask adds a byte a row to the statistics' and dx's passes.
//
// What the design does about it: one thread owns 8 channels of a row, read
// and written as 16-byte vectors.  The two sums run over a grid of
// P row blocks x 64-channel tiles sized from (M, C) by the wrapper (one wave
// of blocks, each walking its rows with 4 loads in flight); each block
// reduces its 32 row lanes in a fixed order and writes one partial row (and
// with a row mask its count of kept rows), and the last block of a tile to
// finish (an integer counter, reset by that block) sums the P partials in a
// fixed order in fp64 and derives the per-channel numbers.  There are no
// float atomics, so two calls give the same bits, and the count of kept
// rows never leaves the device.  The applies are one pass each over the
// rows with the per-channel numbers held in registers.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kVec = 8;            // channels per thread: one 16-byte bf16 vector
constexpr int kTileVecs = 8;       // vectors per channel tile: 64 channels
constexpr int kSumThreads = 256;   // threads of a sum block
constexpr int kRowLanes = kSumThreads / kTileVecs;  // 32 rows at a time
constexpr int kUnroll = 4;         // rows in flight per thread
constexpr int kApplyThreads = 256;

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// the 8 per-channel values of a (rows, C) fp32 table's row `row` at c0
__device__ __forceinline__ void param8(const float* t, int row, int C, int c0,
                                       float (&v)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = t[static_cast<size_t>(row) * C + c0 + j];
}

// Per element of the forward: (x, x^2), and (0, 0) at a row the row mask
// drops (with kRows; `load` then returns whether the row counts).
template <typename TX, bool kRows>
struct XSums {
  static constexpr bool kCounts = kRows;
  const TX* x;
  long long ldx;
  const uint8_t* valid;  // (M,) row mask, with kRows
  __device__ __forceinline__ void init(int) {}
  __device__ __forceinline__ unsigned load(long long r, int c0, float (&s)[kVec],
                                           float (&q)[kVec]) const {
    if (kRows && !valid[r]) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) s[j] = q[j] = 0.f;
      return 0u;
    }
    load8(x + r * ldx + c0, s);
#pragma unroll
    for (int j = 0; j < kVec; ++j) q[j] = s[j] * s[j];
    return 1u;
  }
};

// Per element of the backward: (g, g (x - mean)).
template <typename TX, typename TG, bool kMask>
struct GradSums {
  static constexpr bool kCounts = false;
  const TG* dy;
  long long ldy;
  const TX* x;
  long long ldx;
  const uint8_t* mask;  // (M, C / 8) ReLU bits
  int vpr;
  const float* stats;   // (4 or 5, C): mean, rstd, scale, keep[, n]
  int C;
  float mu[kVec];
  __device__ __forceinline__ void init(int c0) { param8(stats, 0, C, c0, mu); }
  __device__ __forceinline__ unsigned load(long long r, int c0, float (&s)[kVec],
                                           float (&q)[kVec]) const {
    float xv[kVec];
    load8(dy + r * ldy + c0, s);
    load8(x + r * ldx + c0, xv);
    const unsigned bits = kMask ? mask[r * vpr + c0 / kVec] : 0xffu;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s[j] = (bits >> j) & 1u ? s[j] : 0.f;
      q[j] = s[j] * (xv[j] - mu[j]);
    }
    return 1u;
  }
};

// Forward finish per channel over the n rows summed: the statistics, the
// running update, the scale.  stats (4, C) = mean, rstd, scale, keep; with
// a row mask (5, C), keep 1 and row 4 n.
template <bool kRows>
struct StatsOut {
  const float* weight;
  float* run_mean;
  float* run_var;
  float* stats;
  int C;
  float eps, m_old, m_new;
  __device__ __forceinline__ void operator()(int c, double s, double q, long long n) const {
    const double mean = s / static_cast<double>(n);
    const double raw = q / static_cast<double>(n) - mean * mean;
    const float mean_f = static_cast<float>(mean);
    // clamp at 0 as torch.clamp does: a NaN stays NaN
    const float var_f = raw < 0.0 ? 0.f : static_cast<float>(raw);
    const float rstd = static_cast<float>(1.0 / sqrt(static_cast<double>(var_f) + eps));
    stats[c] = mean_f;
    stats[C + c] = rstd;
    stats[2 * C + c] = rstd * weight[c];
    // the clamp passes its gradient; the masked form's variance has none
    stats[3 * C + c] = kRows || raw >= 0.0 ? 1.f : 0.f;
    if (kRows) stats[4 * C + c] = static_cast<float>(n);
    // running = 0.9 old + 0.1 batch, rounded as the eager mul_ / add_ round
    run_mean[c] = __fadd_rn(__fmul_rn(run_mean[c], m_old), __fmul_rn(m_new, mean_f));
    run_var[c] = __fadd_rn(__fmul_rn(run_var[c], m_old), __fmul_rn(m_new, var_f));
  }
};

// Backward finish per channel: coef (5, C) = dweight, dbias, and dx's
// a, b, c in dx = a g + [kept] (b (x - mean) + c); the statistics' count
// is the M rows summed, or with a row mask the forward's n (stats row 4).
template <bool kRows>
struct GradOut {
  const float* weight;
  const float* stats;
  float* coef;
  int C;
  __device__ __forceinline__ void operator()(int c, double s, double q, long long rows) const {
    const double r = stats[C + c];
    const double keep = stats[3 * C + c];
    const double wr = static_cast<double>(weight[c]) * r;
    const double m = kRows ? static_cast<double>(stats[4 * C + c]) : static_cast<double>(rows);
    coef[c] = static_cast<float>(q * r);
    coef[C + c] = static_cast<float>(s);
    coef[2 * C + c] = static_cast<float>(wr);
    coef[3 * C + c] = static_cast<float>(-wr * r * r * keep * q / m);
    coef[4 * C + c] = static_cast<float>(-wr * s / m);
  }
};

// Sums of the two per-element values over rows [p R, min(M, (p+1) R)) of one
// 64-channel tile (blockIdx.y); the last block of the tile to finish sums
// the P partials and hands each channel's totals to `out`, with the count
// of rows summed: M, or where `In` counts rows (a row mask) the rows it
// kept, max(kept, 1), from each block's count in `kept` (P per tile).
template <class In, class Out>
__global__ void __launch_bounds__(kSumThreads)
bn_sums_kernel(In in, Out out, long long M, int C, int rows_per_block,
            double2* __restrict__ part, unsigned* __restrict__ counter,
            unsigned* __restrict__ kept) {
  __shared__ double2 red[kSumThreads / 32][kTileVecs * kVec];
  __shared__ double2 fin[kSumThreads / (kTileVecs * kVec)][kTileVecs * kVec];
  __shared__ unsigned warp_kept[kSumThreads / 32];
  __shared__ long long rows;
  __shared__ bool last;

  const int P = gridDim.x;
  const int p = blockIdx.x;
  const int tile = blockIdx.y;
  const int lane_v = threadIdx.x % kTileVecs;
  const int lane_r = threadIdx.x / kTileVecs;
  const int c0 = (tile * kTileVecs + lane_v) * kVec;
  const bool active = c0 < C;

  double ds[kVec], dq[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) ds[j] = dq[j] = 0.0;
  unsigned n_kept = 0;  // rows this thread's row lane kept
  if (active) {
    in.init(c0);
    const long long r_begin = static_cast<long long>(p) * rows_per_block;
    const long long r_end = min(M, r_begin + rows_per_block);
    for (long long r0 = r_begin + lane_r; r0 < r_end; r0 += kRowLanes * kUnroll) {
      float s[kUnroll][kVec], q[kUnroll][kVec];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long r = r0 + static_cast<long long>(k) * kRowLanes;
        if (r < r_end) {
          n_kept += in.load(r, c0, s[k], q[k]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) s[k][j] = q[k][j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ds[j] += static_cast<double>((s[0][j] + s[1][j]) + (s[2][j] + s[3][j]));
        dq[j] += static_cast<double>((q[0][j] + q[1][j]) + (q[2][j] + q[3][j]));
      }
    }
  }
  // the 4 row lanes of a warp, then the block's 8 warps, in a fixed order
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
#pragma unroll
    for (int off = kTileVecs; off < 32; off *= 2) {
      ds[j] += __shfl_xor_sync(0xffffffffu, ds[j], off);
      dq[j] += __shfl_xor_sync(0xffffffffu, dq[j], off);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < kTileVecs) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[warp][lane * kVec + j] = make_double2(ds[j], dq[j]);
  }
  if (In::kCounts) {
    // each row was counted by the 8 vector lanes of its row lane: take the
    // first's, over the warp's 4 row lanes
    unsigned k = lane_v == 0 ? n_kept : 0u;
#pragma unroll
    for (int off = kTileVecs; off < 32; off *= 2) k += __shfl_xor_sync(0xffffffffu, k, off);
    if (lane == 0) warp_kept[warp] = k;
  }
  __syncthreads();
  if (In::kCounts && threadIdx.x == 0) {
    unsigned k = 0;
#pragma unroll
    for (int w = 0; w < kSumThreads / 32; ++w) k += warp_kept[w];
    kept[tile * P + p] = k;
  }
  const int ch = threadIdx.x;  // channel of the tile, for the first 64 threads
  if (ch < kTileVecs * kVec && tile * kTileVecs * kVec + ch < C) {
    double2 t = red[0][ch];
#pragma unroll
    for (int w = 1; w < kSumThreads / 32; ++w) {
      t.x += red[w][ch].x;
      t.y += red[w][ch].y;
    }
    part[static_cast<size_t>(p) * C + tile * kTileVecs * kVec + ch] = t;
  }
  // publish, then find out whether this block finished the tile
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counter[tile], 1u) == static_cast<unsigned>(P - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  if (threadIdx.x == 0) {
    long long n = M;
    if (In::kCounts) {
      n = 0;
      for (int i = 0; i < P; ++i) n += __ldcg(&kept[tile * P + i]);
      n = max(n, 1LL);
    }
    rows = n;
  }

  // the tile's totals: 4 groups of 64 threads sum every 4th partial row,
  // then the groups are summed in order
  constexpr int kGroups = kSumThreads / (kTileVecs * kVec);
  const int grp = threadIdx.x / (kTileVecs * kVec);
  const int c = tile * kTileVecs * kVec + threadIdx.x % (kTileVecs * kVec);
  double2 t = make_double2(0.0, 0.0);
  if (c < C) {
    for (int i = grp; i < P; i += kGroups) {
      const double2 v = __ldcg(&part[static_cast<size_t>(i) * C + c]);
      t.x += v.x;
      t.y += v.y;
    }
  }
  fin[grp][threadIdx.x % (kTileVecs * kVec)] = t;
  __syncthreads();
  if (threadIdx.x < kTileVecs * kVec && c < C) {
    double2 tot = fin[0][threadIdx.x];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) {
      tot.x += fin[g][threadIdx.x].x;
      tot.y += fin[g][threadIdx.x].y;
    }
    out(c, tot.x, tot.y, rows);
  }
  if (threadIdx.x == 0) counter[tile] = 0u;  // ready for the next call on this stream
}

// The ReLU of the epilogues: v where v > 0 or NaN, else 0; the bit says
// where the gradient passes (torch's threshold_backward: result <= 0 -> 0).
__device__ __forceinline__ unsigned relu8(float (&v)[kVec]) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const bool pass = !(v[j] <= 0.f);
    bits |= static_cast<unsigned>(pass) << j;
    v[j] = pass ? v[j] : 0.f;
  }
  return bits;
}

// mode: 0 = y, 1 = ReLU(y), 2 = ReLU(y + identity).  blockDim.x = vpr *
// rows_per_iter, so each thread keeps one 8-channel group over its rows.
template <typename TX, typename TY, int kMode>
__global__ void __launch_bounds__(kApplyThreads)
bn_apply_kernel(const TX* __restrict__ x, long long ldx, const float* __restrict__ id,
             long long ldid, TY* __restrict__ y, uint8_t* __restrict__ mask,
             const float* __restrict__ stats, const float* __restrict__ bias,
             long long M, int C, int rows_per_iter) {
  const int vpr = C / kVec;
  const int v = threadIdx.x % vpr;
  const int c0 = v * kVec;
  float mu[kVec], sc[kVec], b[kVec];
  param8(stats, 0, C, c0, mu);
  param8(stats, 2, C, c0, sc);
  param8(bias, 0, C, c0, b);
  const long long step = static_cast<long long>(gridDim.x) * rows_per_iter;
  for (long long r0 = static_cast<long long>(blockIdx.x) * rows_per_iter +
                      threadIdx.x / vpr;
       r0 < M; r0 += 2 * step) {
    float o[2][kVec], iv[2][kVec];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long r = r0 + k * step;
      if (r < M) {
        load8(x + r * ldx + c0, o[k]);
        if (kMode == 2) load8(id + r * ldid + c0, iv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long r = r0 + k * step;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        o[k][j] = fmaf(o[k][j] - mu[j], sc[j], b[j]);
        if (kMode == 2) o[k][j] += iv[k][j];
      }
      if (kMode != 0) mask[r * vpr + v] = static_cast<uint8_t>(relu8(o[k]));
      store8(y + r * C + c0, o[k]);
    }
  }
}

// dx = a g + b (x - mean) + c in x's type, with kRows a g alone at a row
// the row mask dropped (the statistics never saw it); with kRes also
// d(identity) = g.
template <typename TX, typename TG, bool kMask, bool kRes, bool kRows>
__global__ void __launch_bounds__(kApplyThreads)
bn_grad_apply_kernel(const TG* __restrict__ dy, long long ldy, const TX* __restrict__ x,
                  long long ldx, const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ stats, const float* __restrict__ coef,
                  TX* __restrict__ dx, float* __restrict__ did, long long M, int C,
                  int rows_per_iter) {
  const int vpr = C / kVec;
  const int v = threadIdx.x % vpr;
  const int c0 = v * kVec;
  float mu[kVec], a[kVec], b[kVec], cc[kVec];
  param8(stats, 0, C, c0, mu);
  param8(coef, 2, C, c0, a);
  param8(coef, 3, C, c0, b);
  param8(coef, 4, C, c0, cc);
  const long long step = static_cast<long long>(gridDim.x) * rows_per_iter;
  for (long long r0 = static_cast<long long>(blockIdx.x) * rows_per_iter +
                      threadIdx.x / vpr;
       r0 < M; r0 += 2 * step) {
    float g[2][kVec], xv[2][kVec];
    unsigned bits[2] = {0xffu, 0xffu};
    bool kept[2] = {true, true};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long r = r0 + k * step;
      if (r < M) {
        if (kRows) kept[k] = valid[r] != 0;
        load8(dy + r * ldy + c0, g[k]);
        if (kept[k]) load8(x + r * ldx + c0, xv[k]);
        if (kMask) bits[k] = mask[r * vpr + v];
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long r = r0 + k * step;
      if (r >= M) continue;
      float d[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        g[k][j] = (bits[k] >> j) & 1u ? g[k][j] : 0.f;
        d[j] = kept[k] ? fmaf(a[j], g[k][j], fmaf(b[j], xv[k][j] - mu[j], cc[j]))
                       : a[j] * g[k][j];
      }
      store8(dx + r * C + c0, d);
      if (kRes) store8(did + r * C + c0, g[k]);
    }
  }
}

template <typename TX, bool kRows>
int launch_stats(const void* x, long long ldx, const uint8_t* valid, long long M, int C,
                 int P, int rows, void* part, void* counter, void* kept,
                 const float* weight, float* run_mean, float* run_var, float* stats,
                 float eps, float m_old, float m_new, cudaStream_t s) {
  XSums<TX, kRows> in{static_cast<const TX*>(x), ldx, valid};
  StatsOut<kRows> out{weight, run_mean, run_var, stats, C, eps, m_old, m_new};
  const dim3 grid(P, (C + kTileVecs * kVec - 1) / (kTileVecs * kVec));
  bn_sums_kernel<<<grid, kSumThreads, 0, s>>>(in, out, M, C, rows,
                                           static_cast<double2*>(part),
                                           static_cast<unsigned*>(counter),
                                           static_cast<unsigned*>(kept));
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TG, bool kMask, bool kRows>
int launch_grad_sums(const void* dy, long long ldy, const void* x, long long ldx,
                     const uint8_t* mask, long long M, int C, int P, int rows,
                     void* part, void* counter, const float* weight,
                     const float* stats, float* coef, cudaStream_t s) {
  GradSums<TX, TG, kMask> in{static_cast<const TG*>(dy), ldy, static_cast<const TX*>(x),
                             ldx, mask, C / kVec, stats, C, {}};
  GradOut<kRows> out{weight, stats, coef, C};
  const dim3 grid(P, (C + kTileVecs * kVec - 1) / (kTileVecs * kVec));
  bn_sums_kernel<<<grid, kSumThreads, 0, s>>>(in, out, M, C, rows,
                                           static_cast<double2*>(part),
                                           static_cast<unsigned*>(counter), nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY>
int launch_apply(int mode, const void* x, long long ldx, const float* id, long long ldid,
                 void* y, uint8_t* mask, const float* stats, const float* bias,
                 long long M, int C, int blocks, int rows_per_iter, cudaStream_t s) {
  const int threads = (C / kVec) * rows_per_iter;
  const TX* xx = static_cast<const TX*>(x);
  TY* yy = static_cast<TY*>(y);
  if (mode == 0) {
    bn_apply_kernel<TX, TY, 0><<<blocks, threads, 0, s>>>(xx, ldx, id, ldid, yy, mask, stats,
                                                       bias, M, C, rows_per_iter);
  } else if (mode == 1) {
    bn_apply_kernel<TX, TY, 1><<<blocks, threads, 0, s>>>(xx, ldx, id, ldid, yy, mask, stats,
                                                       bias, M, C, rows_per_iter);
  } else {
    bn_apply_kernel<TX, TY, 2><<<blocks, threads, 0, s>>>(xx, ldx, id, ldid, yy, mask, stats,
                                                       bias, M, C, rows_per_iter);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TG, bool kRows>
int launch_grad_apply(int mode, const void* dy, long long ldy, const void* x, long long ldx,
                      const uint8_t* mask, const uint8_t* valid, const float* stats,
                      const float* coef, void* dx, float* did, long long M, int C,
                      int blocks, int rows_per_iter, cudaStream_t s) {
  const int threads = (C / kVec) * rows_per_iter;
  const TG* gg = static_cast<const TG*>(dy);
  const TX* xx = static_cast<const TX*>(x);
  TX* dd = static_cast<TX*>(dx);
  if (mode == 0) {
    bn_grad_apply_kernel<TX, TG, false, false, kRows><<<blocks, threads, 0, s>>>(
        gg, ldy, xx, ldx, mask, valid, stats, coef, dd, did, M, C, rows_per_iter);
  } else if (mode == 1) {
    bn_grad_apply_kernel<TX, TG, true, false, kRows><<<blocks, threads, 0, s>>>(
        gg, ldy, xx, ldx, mask, valid, stats, coef, dd, did, M, C, rows_per_iter);
  } else {
    bn_grad_apply_kernel<TX, TG, true, true, kRows><<<blocks, threads, 0, s>>>(
        gg, ldy, xx, ldx, mask, valid, stats, coef, dd, did, M, C, rows_per_iter);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every pointer 16-byte aligned, C % 8 == 0, every row stride (ld*) a
// multiple of 16 bytes; dtype codes 0 = fp32, 1 = bf16; part (P, C) double2
// scratch; counter (ceil(C / 64),) unsigned, zero before the first call on
// a stream and left zero by each call; valid, where given, an (M,) byte
// mask of the rows the statistics take, kept (ceil(C / 64) * P,) unsigned
// scratch beside it.  The wrapper checks all of it.

// x (M rows, ldx apart) -> stats (4, C), or with a row mask (5, C);
// running statistics updated in place.
extern "C" int bn_stats(const void* x, long long ldx, int xdt, long long M, int C,
                        int P, int rows_per_block, void* part, void* counter,
                        const float* weight, float* run_mean, float* run_var,
                        float* stats, float eps, float m_old, float m_new,
                        const uint8_t* valid, void* kept, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MM2D3D_BN_STATS(TX, ROWS)                                                      \
  return launch_stats<TX, ROWS>(x, ldx, valid, M, C, P, rows_per_block, part, counter, \
                                kept, weight, run_mean, run_var, stats, eps, m_old,    \
                                m_new, s)
  if (xdt == kBFloat16) {
    if (valid) { MM2D3D_BN_STATS(__nv_bfloat16, true); }
    MM2D3D_BN_STATS(__nv_bfloat16, false);
  }
  if (valid) { MM2D3D_BN_STATS(float, true); }
  MM2D3D_BN_STATS(float, false);
#undef MM2D3D_BN_STATS
}

// y (M, C) contiguous in ydt (fp32 or bf16); mask (M, C / 8) for modes 1
// and 2; identity (fp32, rows ldid apart) for mode 2.
extern "C" int bn_apply(int mode, const void* x, long long ldx, int xdt, const float* id,
                        long long ldid, void* y, int ydt, uint8_t* mask,
                        const float* stats, const float* bias, long long M, int C,
                        int blocks, int rows_per_iter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xdt == kBFloat16 && ydt == kBFloat16) {
    return launch_apply<__nv_bfloat16, __nv_bfloat16>(mode, x, ldx, id, ldid, y, mask,
                                                      stats, bias, M, C, blocks,
                                                      rows_per_iter, s);
  }
  if (xdt == kBFloat16) {
    return launch_apply<__nv_bfloat16, float>(mode, x, ldx, id, ldid, y, mask, stats,
                                              bias, M, C, blocks, rows_per_iter, s);
  }
  if (ydt == kBFloat16) {
    return launch_apply<float, __nv_bfloat16>(mode, x, ldx, id, ldid, y, mask, stats,
                                              bias, M, C, blocks, rows_per_iter, s);
  }
  return launch_apply<float, float>(mode, x, ldx, id, ldid, y, mask, stats, bias, M, C,
                                    blocks, rows_per_iter, s);
}

// dy (rows ldy apart, gdt) and x -> coef (5, C) = dweight, dbias, a, b, c;
// rows != 0: the statistics were a row mask's, their count in stats row 4.
extern "C" int bn_grad_sums(const void* dy, long long ldy, int gdt, const void* x,
                            long long ldx, int xdt, const uint8_t* mask, long long M,
                            int C, int P, int rows_per_block, void* part, void* counter,
                            const float* weight, const float* stats, float* coef,
                            int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool m = mask != nullptr;
#define MM2D3D_BN_GRAD_SUMS_R(TX, TG, ROWS)                                            \
  return m ? launch_grad_sums<TX, TG, true, ROWS>(dy, ldy, x, ldx, mask, M, C, P,      \
                                                  rows_per_block, part, counter,       \
                                                  weight, stats, coef, s)              \
           : launch_grad_sums<TX, TG, false, ROWS>(dy, ldy, x, ldx, mask, M, C, P,     \
                                                   rows_per_block, part, counter,      \
                                                   weight, stats, coef, s)
#define MM2D3D_BN_GRAD_SUMS(TX, TG)                                                    \
  if (rows) { MM2D3D_BN_GRAD_SUMS_R(TX, TG, true); }                                   \
  MM2D3D_BN_GRAD_SUMS_R(TX, TG, false)
  if (xdt == kBFloat16 && gdt == kBFloat16) { MM2D3D_BN_GRAD_SUMS(__nv_bfloat16, __nv_bfloat16); }
  if (xdt == kBFloat16) { MM2D3D_BN_GRAD_SUMS(__nv_bfloat16, float); }
  if (gdt == kBFloat16) { MM2D3D_BN_GRAD_SUMS(float, __nv_bfloat16); }
  MM2D3D_BN_GRAD_SUMS(float, float);
#undef MM2D3D_BN_GRAD_SUMS
#undef MM2D3D_BN_GRAD_SUMS_R
}

// dx (M, C) contiguous in x's type; did (M, C) fp32 for mode 2; valid, the
// forward's row mask or null.
extern "C" int bn_grad_apply(int mode, const void* dy, long long ldy, int gdt,
                             const void* x, long long ldx, int xdt, const uint8_t* mask,
                             const float* stats, const float* coef, void* dx, float* did,
                             long long M, int C, int blocks, int rows_per_iter,
                             const uint8_t* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MM2D3D_BN_GRAD_APPLY(TX, TG)                                                   \
  if (valid) {                                                                         \
    return launch_grad_apply<TX, TG, true>(mode, dy, ldy, x, ldx, mask, valid, stats,  \
                                           coef, dx, did, M, C, blocks,                \
                                           rows_per_iter, s);                          \
  }                                                                                    \
  return launch_grad_apply<TX, TG, false>(mode, dy, ldy, x, ldx, mask, valid, stats,   \
                                          coef, dx, did, M, C, blocks, rows_per_iter, s)
  if (xdt == kBFloat16 && gdt == kBFloat16) { MM2D3D_BN_GRAD_APPLY(__nv_bfloat16, __nv_bfloat16); }
  if (xdt == kBFloat16) { MM2D3D_BN_GRAD_APPLY(__nv_bfloat16, float); }
  if (gdt == kBFloat16) { MM2D3D_BN_GRAD_APPLY(float, __nv_bfloat16); }
  MM2D3D_BN_GRAD_APPLY(float, float);
#undef MM2D3D_BN_GRAD_APPLY
}
