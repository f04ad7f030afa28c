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
// products and 0.9 GFLOP with every band).  The design, step by step:
//   - A persistent grid: up to three blocks per SM (two at 128 voxels; the
//     wrapper's plan), each walking tiles of BV = 64 or 128 voxels, tile
//     blockIdx.x + i * grid.  A block stages W once, one bulk copy per row
//     into rows padded by 16 bytes (conflict-free ldmatrix), and keeps it
//     for all its tiles: W is read from L2 once per block, not per tile.
//   - A ring of kStages tile stages, filled by one producer warp with the
//     Tensor Memory Accelerator (tma.cuh) on the stage's full mbarrier: per
//     tile and per 64 voxels one 2D box of (64 voxels, Ci rows) for each
//     slot of x and for xm, in the 128-byte swizzle, and one box of the H
//     tap rows: 5 copies a tile at H = 3, where a bulk copy per 128-byte row
//     took 67 and ran slower.  The tensor map zero-fills past V.  The
//     consumers release a stage on its empty mbarrier as soon as they have
//     read it into registers, so the next tiles load while this one is
//     computed.  Where V % 8 != 0 (rows not 16-byte aligned) the producer
//     copies elements into the same layout and arrives on the same barrier.
//   - E is never materialised.  out^T (V, Co) = E^T (V, K * Ci) @ W^T: the
//     built operand is A.  One consumer warp per 16 voxels of the tile turns
//     each source's 16 x 16 block once per tile from the staged (channel,
//     voxel) rows into (voxel, channel) rows of its own: one ldmatrix.trans
//     (the swizzle makes its row reads conflict-free) and one stmatrix.
//     Band k's A fragment is then one ldmatrix whose 16 row addresses each
//     lane picks for its row's voxel: the row of the source whose tap is k,
//     or a row of zeros (a select per source on a 32-bit address; a select
//     per register and source instead takes about twice the instructions
//     per band).  Where no voxel of the warp hits band k the fragment is
//     zeros with no load.  Where a voxel of the warp
//     has two sources on one band (duplicates, or tap 13 beside the centre)
//     the warp takes the fp32 path instead: every source's rows (zeros where
//     its tap is not k) summed in fp32, the centre first, then the slots in
//     order, rounded once to bf16, as band_matrix states.
//   - The product is mma.sync m16n8k16 (bf16, fp32 sums in registers), A
//     from the built registers, B = W^T's fragments by ldmatrix from the
//     staged W, consecutive bands on two sets of sums (two independent
//     chains).  Not wgmma: the product is a small part of the time (the
//     build is most of the compute: tools/exp_bandmm_variants.py --stages),
//     and one warp per 16 voxels keeps the build, the taps and the band
//     masks warp-local with no warpgroup synchronisation between bands.
//   - The probe's shape (K = 27, Ci = Co = 16, H <= 3) has its own
//     instantiation: the band loop unrolled, taps compared with immediates,
//     every offset a constant.  Other shapes loop over the set bands, which
//     at the probe's shape runs 18% slower with the full build and 5% with
//     the compact one on an H100 (the "general path" variant of
//     tools/exp_bandmm_variants.py --stages).
//   - Shared memory: the ring (kStages tiles: depth past three bought
//     nothing, each block walks two or three tiles at the probe's size), W,
//     two out tiles, per consumer warp kSlots + 2 source blocks.
//   - `full` multiplies all K bands; `compact` skips every band that no
//     voxel of the warp's 16 hits (bands from the warp's tap masks by
//     __reduce_or_sync, the centre's band always), so the skip is
//     warp-uniform.
//   - Stores: the warps stage the (Co, BV) fp32 tile in shared memory (rows
//     padded by 16 bytes: conflict-free), then write each row as BV * 4
//     contiguous bytes in 16-byte vector stores (scalar stores where V % 8
//     != 0).  Two out buffers, one named barrier per tile among consumers.
// Every output is summed in a fixed order (bands ascending, alternating
// between the two sets of sums, which are added last), so two calls give
// the same bits.
#include "common.cuh"
#include "mma.cuh"
#include "bandsel.cuh"
#include "bulk.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStages = 3;     // tiles in the ring
constexpr int kMaxCo = 64;     // Co in chunks of 16, one after another
constexpr int kMaxSlots = 8;   // H: a thread keeps its sources in registers

// bytes of one ring stage: H + 1 blocks of Ci x BV bf16 (x's slots, then
// xm), each BV / 64 boxes of Ci rows of 128 bytes in the 128-byte swizzle,
// then the H tap rows of BV int32; a whole number of KB (the swizzle's
// 1024-byte alignment)
__host__ __device__ inline size_t stage_bytes(int bv, int H, int Ci) {
  const size_t b = static_cast<size_t>(H + 1) * Ci * bv * sizeof(bf16) +
                   static_cast<size_t>(H) * bv * sizeof(int);
  return (b + 1023) / 1024 * 1024;
}

constexpr int kSourceBytes = 512;  // one source's 16 x 16 (voxel, channel) bf16 block

// shared memory of one block, in bytes: 1 KB to align the ring, the ring,
// W (rows padded by 8 bf16: conflict-free ldmatrix), two (Co, BV + 4) fp32
// out tiles, each consumer warp's sources (the kernel's kSlots + 2 blocks)
inline size_t smem_bytes(int bv, int H, int Ci, int Co, int K) {
  const int slots = H <= 3 ? 3 : kMaxSlots;
  return 1024 + kStages * stage_bytes(bv, H, Ci) +
         static_cast<size_t>(Co) * (K * Ci + 8) * sizeof(bf16) +
         2 * static_cast<size_t>(Co) * (bv + 4) * sizeof(float) +
         static_cast<size_t>(bv / 16) * (slots + 2) * kSourceBytes;
}

// byte offset of element (row r, column c) in a staged Ci x BV block: box
// c / 64, row r of 128 bytes, 16-byte chunk (c % 64) / 8 swizzled by r % 8
__host__ __device__ __forceinline__ int swizzled(int r, int c, int Ci) {
  return (c >> 6) * Ci * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ float lo_bf16(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// ldmatrix / stmatrix on a shared::cta address
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// A warp's sources, (voxel, channel) rows for one 16-channel step: a block
// of 512 bytes per source (16 voxels x 32 bytes; the two 16-byte chunks of
// voxel v swapped where v / 4 is odd, so that eight rows at one chunk
// fall in eight bank groups): kSlots slot blocks, the centre's, one of
// zeros.  Lane l of an ldmatrix / stmatrix .x4 addresses row (voxel)
// (l % 8) + 8 * ((l / 8) % 2), chunk l / 16: matrices 0-3 are then A's
// fragments a0-a3 of a 16 x 16 (voxel, channel) block.
__device__ __forceinline__ uint32_t source_row(int lane) {
  const int v = (lane & 7) + (((lane >> 3) & 1) << 3), c = lane >> 4;
  return v * 32 + ((c ^ ((v >> 2) & 1)) << 4);
}

// Band k's A fragment where each voxel of the warp has at most one source
// on band k: one ldmatrix whose rows are, voxel by voxel, that source's
// row or a row of zeros.  `tv`: the taps of this lane's row's voxel;
// `slot`: this lane's row address in each slot's block.
template <int kSlots>
__device__ __forceinline__ void pick_band(uint32_t (&a)[4], const int (&tv)[kSlots],
                                          const uint32_t (&slot)[kSlots], uint32_t cen,
                                          uint32_t zero, int k, bool is_centre) {
  uint32_t row = is_centre ? cen : zero;
#pragma unroll
  for (int h = 0; h < kSlots; ++h) row = tv[h] == k ? slot[h] : row;
  ldsm_x4(a, row);
}

// Band k's A fragment as band_matrix states it for any table: the fp32 sum
// of every source (each source's rows, zeros where its tap is not k), the
// centre first, then the slots in order, rounded once.
template <int kSlots>
__device__ __forceinline__ void sum_band(uint32_t (&a)[4], const int (&tv)[kSlots],
                                         const uint32_t (&slot)[kSlots], uint32_t cen,
                                         uint32_t zero, int k, bool is_centre) {
  float f[8] = {};
  uint32_t r[4];
  if (is_centre) {
    ldsm_x4(r, cen);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] += lo_bf16(r[i]);
      f[2 * i + 1] += hi_bf16(r[i]);
    }
  }
#pragma unroll
  for (int h = 0; h < kSlots; ++h) {
    ldsm_x4(r, tv[h] == k ? slot[h] : zero);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] += lo_bf16(r[i]);
      f[2 * i + 1] += hi_bf16(r[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16x2(f[2 * i], f[2 * i + 1]);
}

// the same registers folded into the sums without the tensor cores, so a
// build timed without its product (tools/exp_bandmm_variants.py --stages)
// is not optimised away
__device__ __forceinline__ void fold(float (&acc)[2][4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  acc[0][0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1] ^ b[2] ^ b[3]) &
                               0x007fffffu);
}

// out^T tile (16 voxels, 16 channels) += A (16 x 16) @ W^T's fragments
__device__ __forceinline__ void product(float (&acc)[2][4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[4]) {
  mma_bf16(acc[0], a, b[0], b[1]);
  mma_bf16(acc[1], a, b[2], b[3]);
}

// Band k's A fragment; zeros where no voxel of the warp hits band k (the
// compact build multiplies hit bands only)
template <int kSlots, bool kCompact>
__device__ __forceinline__ void build(uint32_t (&a)[4], int k, unsigned warp_hits, bool slow,
                                      bool centre, const int (&tv)[kSlots],
                                      const uint32_t (&slot)[kSlots], uint32_t cen,
                                      uint32_t zero) {
  const bool is_c = centre && k == kCenter;
  if (!kCompact && !(warp_hits >> k & 1u)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = 0u;
    return;
  }
  if (slow) sum_band<kSlots>(a, tv, slot, cen, zero, k, is_c); else pick_band<kSlots>(a, tv, slot, cen, zero, k, is_c);
}

// a slot clashes where two sources share a band at one voxel
template <int kSlots>
__device__ __forceinline__ bool clashes(const int (&t)[kSlots], int H, int K, bool centre) {
  bool c = false;
#pragma unroll
  for (int h = 0; h < kSlots; ++h) {
    if (h >= H || !valid_tap(t[h], K)) continue;
    c |= centre && t[h] == kCenter;
#pragma unroll
    for (int j = 0; j < h; ++j) c |= t[j] == t[h];
  }
  return c;
}

// kTaps = 27: the probe's shape, K = 27 and Ci = Co = 16 fixed at compile
// time, the band loop unrolled (immediate taps, offsets and centre);
// kTaps = 0: any shape the launch takes, the loop over the set bands.
template <bool kCompact, int BV, int kSlots, int kTaps>
__global__ void __launch_bounds__((BV / 16 + 1) * 32, BV == 64 ? 3 : 2)
exp_bandmm_kernel(const bf16* __restrict__ xm, const bf16* __restrict__ x,
                  const int* __restrict__ tap, const bf16* __restrict__ w,
                  float* __restrict__ out, int V, int H, int ci_, int co_, int k_,
                  int aligned, const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_xm,
                  const __grid_constant__ CUtensorMap tm_tap) {
  constexpr int kConsumers = BV / 16;  // one warp per 16 voxels of a tile
  constexpr int kOutRow = BV + 4;      // fp32 per staged out row
  const int Ci = kTaps ? 16 : ci_, Co = kTaps ? 16 : co_, K = kTaps ? kTaps : k_;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t w_bar;
  const int KC = K * Ci, kWRow = KC + 8;
  const size_t stage = stage_bytes(BV, H, Ci);
  const int block = Ci * BV * sizeof(bf16);  // one staged Ci x BV block
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  bf16* ws = reinterpret_cast<bf16*>(ring + kStages * stage);  // [Co][kWRow]
  float* outs = reinterpret_cast<float*>(ws + Co * kWRow);     // [2][Co][kOutRow]
  // each consumer warp's sources: kSlots + 2 blocks of kSourceBytes
  unsigned char* sources = reinterpret_cast<unsigned char*>(outs + 2 * Co * kOutRow);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (V + BV - 1) / BV;
  const bool centre = xm != nullptr;
  const int n_src = H + (centre ? 1 : 0);  // x's slots, then xm
  const size_t nv = static_cast<size_t>(V);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumers);
    }
    mbar_init(&w_bar, 1);
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- the producer warp: W once, then the ring ----
    if (lane == 0) mbar_expect_tx(&w_bar, static_cast<unsigned>(Co) * KC * sizeof(bf16));
    __syncwarp();
    for (int r = lane; r < Co; r += 32) {
      bulk_copy_g2s(ws + r * kWRow, w + static_cast<size_t>(r) * KC, KC * sizeof(bf16),
                    &w_bar);
    }
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(&empty_bar[s], ((it / kStages) - 1) & 1);
      unsigned char* xs = ring + s * stage;
      int* ts = reinterpret_cast<int*>(xs + (H + 1) * block);
      const int v0 = tile * BV, n = min(BV, V - v0);
      if (aligned) {  // H + 1 boxes of (64 voxels, Ci rows) per 64 voxels, then the taps
        if (lane == 0) {
          mbar_expect_tx(&full_bar[s], n_src * block + H * BV * sizeof(int));
          for (int h = 0; h < n_src; ++h) {
            for (int half = 0; half < BV / 64; ++half) {
              tma_load_2d(xs + h * block + half * Ci * 128, h < H ? &tm_x : &tm_xm,
                          v0 + half * 64, h < H ? h * Ci : 0, &full_bar[s]);
            }
          }
          if (H > 0) tma_load_2d(ts, &tm_tap, v0, 0, &full_bar[s]);
        }
      } else {
        for (int e = lane; e < n_src * Ci * n; e += 32) {
          const int r = e / n, c = e - r * n;  // r = h * Ci + ci
          const int h = r / Ci, ci = r - h * Ci;
          const bf16* row = h < H ? x + r * nv : xm + ci * nv;
          *reinterpret_cast<bf16*>(xs + h * block + swizzled(ci, c, Ci)) = row[v0 + c];
        }
        for (int e = lane; e < H * n; e += 32) {
          const int h = e / n, c = e - h * n;
          ts[h * BV + c] = tap[h * nv + v0 + c];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full_bar[s]);
      }
    }
    return;
  }

  // ---- a consumer warp: 16 voxels of every tile of this block ----
  mbar_wait(&w_bar, 0);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int vb = warp * 16;
  // this lane's row in each of the warp's source blocks: the slots', the
  // centre's, the zeros' (written once)
  const uint32_t mine = smem_addr(sources) + warp * (kSlots + 2) * kSourceBytes +
                        source_row(lane);
  uint32_t slot_row[kSlots];
#pragma unroll
  for (int h = 0; h < kSlots; ++h) slot_row[h] = mine + h * kSourceBytes;
  const uint32_t cen_row = mine + kSlots * kSourceBytes;
  const uint32_t zero_row = cen_row + kSourceBytes;
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(zero_row), "r"(0u) : "memory");
  // a lane's row voxel, as ldmatrix / stmatrix address it
  const int rv = (lane & 7) + (((lane >> 3) & 1) << 3);
  // ldmatrix addressing, the same for x (.trans) and W: lane l points at
  // row (l % 8) + 8 * (l / 16), column 8 * ((l / 8) % 2) of a 16 x 16 block
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = ((lane >> 3) & 1) << 3;
  const unsigned all_bands = K >= 32 ? ~0u : (1u << K) - 1u;  // a constant for kTaps
  const int n_cc = Co / 16, n_cs = Ci / 16;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int s = it % kStages;
    mbar_wait(&full_bar[s], (it / kStages) & 1);
    const unsigned char* xs = ring + s * stage;
    const int* ts = reinterpret_cast<const int*>(xs + (H + 1) * block);
    const int v0 = tile * BV;

    // the taps of this lane's row voxel; a voxel past V misses
    int tv[kSlots];
    const bool in_v = v0 + vb + rv < V;
    unsigned hit = centre ? 1u << kCenter : 0u;
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      tv[h] = h < H && in_v ? ts[h * BV + vb + rv] : -1;
      if (valid_tap(tv[h], K)) hit |= 1u << tv[h];
    }
    const bool slow = __any_sync(~0u, clashes<kSlots>(tv, H, K, centre));
    const unsigned warp_hits = __reduce_or_sync(~0u, hit);
    const unsigned bands = kCompact ? warp_hits : all_bands;

    float* o = outs + (it & 1) * Co * kOutRow;
    for (int cc = 0; cc < n_cc; ++cc) {
      float acc[2][2][4] = {};
      for (int cs = 0; cs < n_cs; ++cs) {
        // every source's 16 x 16 (voxel, channel) block for this 16-channel
        // step, from the staged (channel, voxel) rows into the warp's
        // (voxel, channel) rows: ldmatrix.trans, then stmatrix
        __syncwarp();  // the previous step's reads of the blocks are done
        const unsigned char* xrow = xs + swizzled(cs * 16 + lrow, vb + lcol, Ci);
        for (int h = 0; h < n_src; ++h) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, xrow + h * block);
          stsm_x4(h < H ? slot_row[0] + h * kSourceBytes : cen_row, r);
        }
        __syncwarp();
        if (cc == n_cc - 1 && cs == n_cs - 1 && lane == 0) {
          mbar_arrive(&empty_bar[s]);  // the stage is read: release it
        }
        const bf16* wrow = ws + (cc * 16 + lrow) * kWRow + cs * 16 + lcol;
        if (kTaps) {  // alternate sets of sums: two independent chains
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            if (!(bands >> k & 1u)) continue;
            uint32_t a[4], b[4];
            ldmatrix_x4(b, wrow + k * Ci);
            build<kSlots, kCompact>(a, k, warp_hits, slow, centre, tv, slot_row, cen_row, zero_row);
            product(acc[k & 1], a, b);
          }
          continue;
        }
        // two bands at a time on two sets of sums: two independent chains,
        // both W fragments asked for before either build
        unsigned m = bands;
        for (; __popc(m) >= 2; m &= m - 1) {
          const int k0 = __ffs(m) - 1;
          m &= m - 1;
          const int k1 = __ffs(m) - 1;
          uint32_t a0[4], a1[4], b0[4], b1[4];
          ldmatrix_x4(b0, wrow + k0 * Ci);
          ldmatrix_x4(b1, wrow + k1 * Ci);
          build<kSlots, kCompact>(a0, k0, warp_hits, slow, centre, tv, slot_row, cen_row, zero_row);
          build<kSlots, kCompact>(a1, k1, warp_hits, slow, centre, tv, slot_row, cen_row, zero_row);
          product(acc[0], a0, b0);
          product(acc[1], a1, b1);
        }
        if (m) {
          const int k0 = __ffs(m) - 1;
          uint32_t a0[4], b0[4];
          ldmatrix_x4(b0, wrow + k0 * Ci);
          build<kSlots, kCompact>(a0, k0, warp_hits, slow, centre, tv, slot_row, cen_row, zero_row);
          product(acc[0], a0, b0);
        }
      }
      // c0, c1 = out^T[voxel g][co 2t, 2t + 1], c2, c3 = voxel g + 8
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* oc = o + (cc * 16 + nt * 8 + t2) * kOutRow + vb + g;
        oc[0] = acc[0][nt][0] + acc[1][nt][0];
        oc[kOutRow] = acc[0][nt][1] + acc[1][nt][1];
        oc[8] = acc[0][nt][2] + acc[1][nt][2];
        oc[kOutRow + 8] = acc[0][nt][3] + acc[1][nt][3];
      }
    }
    consumers_sync(kConsumers * 32);
    // the tile's Co rows of out, BV * 4 contiguous bytes each
    const int n = min(BV, V - v0);
    const int tid = threadIdx.x;
    if (aligned) {
      constexpr int kQuads = BV / 4;
      for (int e = tid; e < Co * kQuads; e += kConsumers * 32) {
        const int co = e / kQuads, q = (e - co * kQuads) * 4;
        if (q < n) *reinterpret_cast<float4*>(out + co * nv + v0 + q) = *reinterpret_cast<const float4*>(o + co * kOutRow + q);
      }
    } else {
      for (int e = tid; e < Co * BV; e += kConsumers * 32) {
        const int co = e / BV, q = e - co * BV;
        if (q < n) out[co * nv + v0 + q] = o[co * kOutRow + q];
      }
    }
  }
}

template <bool kCompact, int BV, int kSlots, int kTaps>
int launch(const bf16* xm, const bf16* x, const int* tap, const bf16* w, float* out, int V,
           int H, int Ci, int Co, int K, int aligned, const CUtensorMap* maps, int blocks,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      exp_bandmm_kernel<kCompact, BV, kSlots, kTaps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBulkBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  exp_bandmm_kernel<kCompact, BV, kSlots, kTaps><<<blocks, (BV / 16 + 1) * 32,
                                                   smem_bytes(BV, H, Ci, Co, K), stream>>>(
      xm, x, tap, w, out, V, H, Ci, Co, K, aligned, maps[0], maps[1], maps[2]);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCompact, int BV>
int launch_slots(const bf16* xm, const bf16* x, const int* tap, const bf16* w, float* out,
                 int V, int H, int Ci, int Co, int K, int aligned, const CUtensorMap* maps,
                 int blocks, cudaStream_t s) {
  if (H <= 3 && K == 27 && Ci == 16 && Co == 16) {
    return launch<kCompact, BV, 3, 27>(xm, x, tap, w, out, V, H, Ci, Co, K, aligned, maps,
                                       blocks, s);
  }
  return H <= 3 ? launch<kCompact, BV, 3, 0>(xm, x, tap, w, out, V, H, Ci, Co, K, aligned,
                                             maps, blocks, s)
                : launch<kCompact, BV, kMaxSlots, 0>(xm, x, tap, w, out, V, H, Ci, Co, K,
                                                     aligned, maps, blocks, s);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// xm (Ci, V) or null; x (H, Ci, V), or null with H = 0; tap (H, V) int32;
// w (Co, K * Ci); out (Co, V) fp32; w 16-byte aligned.  Ci and Co
// multiples of 16, Ci <= 256, Co <= 64, K <= 32 (and K > 13 with xm), H <= 8, compact
// 0 or 1, bv 64 or 128, blocks > 0 (the wrapper's plan: a persistent grid).
// Returns cudaErrorInvalidValue for another shape or plan,
// cudaErrorNotSupported where a tensor map cannot be made, else the
// launch's cudaGetLastError().
extern "C" int exp_bandmm(const void* xm, const void* x, const void* tap, const void* w,
                          void* out, int V, int H, int Ci, int Co, int K, int compact,
                          int bv, int blocks, void* stream) {
  const bool ok = Ci > 0 && Ci % 16 == 0 && Ci <= 256 && Co > 0 && Co % 16 == 0 &&
                  Co <= kMaxCo && K > 0 && K <= kMaxTcBands && (xm == nullptr || K > kCenter) &&
                  H >= 0 && H <= kMaxSlots && (bv == 64 || bv == 128) && blocks > 0 &&
                  aligned16(w) && smem_bytes(bv, H, Ci, Co, K) <= kMaxBulkBytes;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (V == 0) return static_cast<int>(cudaGetLastError());
  // tensor maps need 16-byte aligned rows; else the producer copies elements
  const int aligned = V % 8 == 0 && aligned16(xm) && aligned16(x) && aligned16(tap) &&
                      aligned16(out);
  CUtensorMap maps[3] = {};  // x (H * Ci rows), xm (Ci rows), the taps (H rows)
  if (aligned) {
    const uint64_t v = static_cast<uint64_t>(V);
    bool made = true;
    if (H > 0) {
      made &= tensor_map_2d(&maps[0], x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v,
                            static_cast<uint64_t>(H) * Ci, v * sizeof(bf16), 64, Ci,
                            CU_TENSOR_MAP_SWIZZLE_128B);
      made &= tensor_map_2d(&maps[2], tap, CU_TENSOR_MAP_DATA_TYPE_INT32, v, H,
                            v * sizeof(int), bv, H, CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    if (xm != nullptr) {
      made &= tensor_map_2d(&maps[1], xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, Ci,
                            v * sizeof(bf16), 64, Ci, CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (!made) return static_cast<int>(cudaErrorNotSupported);
  }
  const bf16* xmb = static_cast<const bf16*>(xm);
  const bf16* xb = static_cast<const bf16*>(x);
  const int* tp = static_cast<const int*>(tap);
  const bf16* wb = static_cast<const bf16*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compact) {
    return bv == 128 ? launch_slots<true, 128>(xmb, xb, tp, wb, o, V, H, Ci, Co, K, aligned, maps, blocks, s)
                     : launch_slots<true, 64>(xmb, xb, tp, wb, o, V, H, Ci, Co, K, aligned, maps, blocks, s);
  }
  return bv == 128 ? launch_slots<false, 128>(xmb, xb, tp, wb, o, V, H, Ci, Co, K, aligned, maps, blocks, s)
                   : launch_slots<false, 64>(xmb, xb, tp, wb, o, V, H, Ci, Co, K, aligned, maps, blocks, s);
}
