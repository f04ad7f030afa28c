// Band selection shared by the tensor-core paths of K1 (bandmm.cu) and K2
// (bandmm_dw.cu): which gathered row feeds band k of a voxel's row of the
// TPU's banded matrix E (mm2d3d_tpu/ops/pallas/bandmm.py::_build_e_t).
//
// Band k of row v is x_src[h, v] for the slot h whose tap is k, and band 13
// is the masked centre xm[v] when it is given.  A real table holds each tap
// at most once per row and never 13 (ops/kernels/propagate.py::rank_slots),
// so each band has at most one source and one pass over the tile computes
// the product.  Any table is accepted all the same: pass p takes, for each
// band, its (p + 1)-th source in slot order, the centre first on band 13,
// and the kernels run passes until no band has a source left, adding each
// pass's product to the same sums.  The plain version in
// ops/kernels/bandmm.py::band_sources states the same rule.
#pragma once

constexpr int kCenter = 13;
constexpr int kMaxTcBands = 32;  // K <= 32: a row's taken bands fit one mask
constexpr int kMaxTcSlots = 64;  // H <= 64: a slot id fits a signed char

__device__ __forceinline__ bool valid_tap(int t, int K) {
  return static_cast<unsigned>(t) < static_cast<unsigned>(K);
}

// The sources of voxel v in pass `pass` for the bands [k0, k0 + nb):
// sel[b * stride] is the slot h that feeds band k0 + b, H for the centre,
// or -1 for none.  Returns whether one of these bands has a source left for
// a later pass.
__device__ __forceinline__ bool select_bands(const int* __restrict__ tap,
                                             int v, int V, int H, int K,
                                             bool centre, int k0, int nb,
                                             int pass, signed char* sel,
                                             int stride) {
  for (int b = 0; b < nb; ++b) sel[b * stride] = -1;
  const size_t nv = static_cast<size_t>(V);
  bool more = false;
  if (pass == 0) {  // the main path: one bit per taken band
    unsigned taken = 0;
    if (centre) {
      taken = 1u << kCenter;
      if (kCenter >= k0 && kCenter < k0 + nb) {
        sel[(kCenter - k0) * stride] = static_cast<signed char>(H);
      }
    }
    for (int h = 0; h < H; ++h) {
      const int t = tap[h * nv + v];
      if (!valid_tap(t, K)) continue;
      const bool mine = t >= k0 && t < k0 + nb;
      if (taken >> t & 1u) {
        more |= mine;
        continue;
      }
      taken |= 1u << t;
      if (mine) sel[(t - k0) * stride] = static_cast<signed char>(h);
    }
    return more;
  }
  unsigned char seen[kMaxTcBands] = {};  // sources of each band so far
  if (centre) seen[kCenter] = 1;
  for (int h = 0; h < H; ++h) {
    const int t = tap[h * nv + v];
    if (!valid_tap(t, K)) continue;
    const int n = seen[t]++;
    if (t < k0 || t >= k0 + nb || n < pass) continue;
    if (n == pass) {
      sel[(t - k0) * stride] = static_cast<signed char>(h);
    } else {
      more = true;
    }
  }
  return more;
}
