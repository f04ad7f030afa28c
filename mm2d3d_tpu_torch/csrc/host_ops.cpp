// Host (CPU) work of mm2d3d_tpu_torch's data path.
//
// The loader's image ops: a bilinear resize and the sparse depth and dense
// 2D label maps, bit-equal to the numpy versions in data/augment.py (which
// select them).  They compute in double, in numpy's order of operations;
// the file is built with -ffp-contract=off, since a fused multiply-add
// would round once where numpy rounds twice.
//
// The sparse U-Net's integer topology: voxel dedup, 27-neighbour tables,
// tiered slot tables and parent/child maps, built with hash maps so that
// the data loader can build a batch's tables while the card runs the
// previous step.  Every table equals the one the device path builds
// (ops/voxelize.py, ops/hierarchy.py); data/host_topology.py assembles
// them.  A copy of the topology functions of the JAX package's
// csrc/host_ops.cpp.
//
// C interface, bound with ctypes by mm2d3d_tpu_torch/native.py, which
// builds this file with g++ into mm2d3d_tpu_torch/_build/ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// image ops
// ---------------------------------------------------------------------------

// Bilinear resize (half-pixel centres, edge-clamped, as PIL's BILINEAR
// without antialiasing) of an HWC uint8 image given by its element strides
// (any numpy view) -> (out_h, out_w, c) double, stored x-major as numpy
// stores its result (`img[y0][:, x0]` puts the indexed axis outermost):
// element (y, x, ch) at dst[(x * out_h + y) * c + ch].  The layout matters
// downstream, where color jitter's means sum in memory order.  Per output
// row:
//   ys = (y + 0.5) * in_h / out_h - 0.5, y0 = clip(floor(ys)),
//   wy = clip(ys - y0, 0, 1), top = a * (1 - wx) + b * wx,
//   out = top * (1 - wy) + bot * wy,
// each operation rounded as numpy rounds it.  Single-threaded: a 1600x900
// frame takes milliseconds, and the loader runs samples in parallel
// processes, where OpenMP threads would oversubscribe the cores.
void bilinear_resize_u8(const uint8_t* src, int64_t s_row, int64_t s_col,
                        int64_t s_ch, int32_t in_h, int32_t in_w, int32_t c,
                        double* dst, int32_t out_h, int32_t out_w) {
  std::vector<int64_t> x0(out_w), x1(out_w);
  std::vector<double> wx(out_w);
  for (int32_t x = 0; x < out_w; ++x) {
    double xs = (x + 0.5) * in_w / out_w - 0.5;
    int64_t f = static_cast<int64_t>(std::floor(xs));
    x0[x] = std::min<int64_t>(std::max<int64_t>(f, 0), in_w - 1);
    x1[x] = std::min<int64_t>(x0[x] + 1, in_w - 1);
    wx[x] = std::min(std::max(xs - static_cast<double>(x0[x]), 0.0), 1.0);
  }
  for (int32_t y = 0; y < out_h; ++y) {
    double ys = (y + 0.5) * in_h / out_h - 0.5;
    int64_t f = static_cast<int64_t>(std::floor(ys));
    int64_t y0 = std::min<int64_t>(std::max<int64_t>(f, 0), in_h - 1);
    int64_t y1 = std::min<int64_t>(y0 + 1, in_h - 1);
    double wy = std::min(std::max(ys - static_cast<double>(y0), 0.0), 1.0);
    const uint8_t* r0 = src + y0 * s_row;
    const uint8_t* r1 = src + y1 * s_row;
    double* out = dst + static_cast<int64_t>(y) * c;
    for (int32_t x = 0; x < out_w; ++x) {
      const int64_t a = x0[x] * s_col, b = x1[x] * s_col;
      const double w1 = wx[x], w0 = 1.0 - w1;
      for (int32_t ch = 0; ch < c; ++ch) {
        const int64_t o = ch * s_ch;
        double top = static_cast<double>(r0[a + o]) * w0 +
                     static_cast<double>(r0[b + o]) * w1;
        double bot = static_cast<double>(r1[a + o]) * w0 +
                     static_cast<double>(r1[b + o]) * w1;
        out[static_cast<int64_t>(x) * out_h * c + ch] =
            top * (1.0 - wy) + bot * wy;
      }
    }
  }
}

// Sparse depth map (0 elsewhere) and dense 2D label map (-100 elsewhere)
// from n projected points (row, col), as numpy's fancy assignment: a
// negative index counts from the end, and of two points on one pixel the
// later wins.  The caller checks -h <= row < h and -w <= col < w.
void depth_label_maps(const int64_t* img_indices, const float* depths,
                      const int64_t* labels, int64_t n, int32_t h, int32_t w,
                      float* depth_map, int64_t* label_map) {
  const size_t cells = static_cast<size_t>(h) * w;
  std::fill(depth_map, depth_map + cells, 0.0f);
  std::fill(label_map, label_map + cells, static_cast<int64_t>(-100));
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = img_indices[2 * i], col = img_indices[2 * i + 1];
    if (r < 0) r += h;
    if (col < 0) col += w;
    depth_map[r * w + col] = depths[i];
    label_map[r * w + col] = labels[i];
  }
}

// ---------------------------------------------------------------------------
// voxel topology (host-side SparseGrid construction)
// ---------------------------------------------------------------------------

struct Key {
  int32_t hi, lo;
  bool operator==(const Key& o) const { return hi == o.hi && lo == o.lo; }
  bool operator<(const Key& o) const {
    return hi != o.hi ? hi < o.hi : lo < o.lo;
  }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t v = (static_cast<uint64_t>(static_cast<uint32_t>(k.hi)) << 32) |
                 static_cast<uint32_t>(k.lo);
    v *= 0x9E3779B97F4A7C15ull;
    return static_cast<size_t>(v ^ (v >> 32));
  }
};

// 64-bit Morton spread: low 21 bits of v to bit positions 0, 3, 6, ...
static inline uint64_t part1by2_64(uint64_t v) {
  v &= 0x1FFFFFull;
  v = (v | (v << 32)) & 0x001F00000000FFFFull;
  v = (v | (v << 16)) & 0x001F0000FF0000FFull;
  v = (v | (v << 8)) & 0x100F00F00F00F00Full;
  v = (v | (v << 4)) & 0x10C30C30C30C30C3ull;
  v = (v | (v << 2)) & 0x1249249249249249ull;
  return v;
}

// (batch, morton(x, y, z)) sort key — mirrors ops/keys.pack's order.
static inline uint64_t morton_key(int32_t b, const int32_t* c) {
  uint64_t m = part1by2_64(static_cast<uint64_t>(c[2])) |
               (part1by2_64(static_cast<uint64_t>(c[1])) << 1) |
               (part1by2_64(static_cast<uint64_t>(c[0])) << 2);
  return (static_cast<uint64_t>(static_cast<uint32_t>(b)) << 36) | m;
}

// Deduplicate integer voxel coords (N, 3) + batch (N,) into a sorted voxel
// table with capacity `cap` rows.  Matches ops/voxelize.voxelize semantics:
// - invalid/out-of-range points map to the dump row (index cap),
// - rows sorted by (batch, morton(x, y, z)) ascending (see ops/keys.py),
// - overflow voxels beyond cap dropped.
// Outputs: vox_coords (cap,3) i32, vox_batch (cap,) i32 (-1 pad),
//          p2v (N,) i32, counts (cap,) i32; returns num_voxels.
int32_t voxelize_dedup(const int32_t* coords, const int32_t* batch,
                       const uint8_t* valid, int32_t n, int32_t full_scale,
                       int32_t cap, int32_t* vox_coords, int32_t* vox_batch,
                       int32_t* p2v, int32_t* counts) {
  std::vector<std::pair<uint64_t, int32_t>> keyed;  // (morton key, point idx)
  keyed.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    bool ok = valid[i];
    const int32_t* c = coords + 3 * i;
    ok &= c[0] >= 0 && c[0] < full_scale && c[1] >= 0 && c[1] < full_scale &&
          c[2] >= 0 && c[2] < full_scale;
    if (ok) {
      keyed.push_back({morton_key(batch[i], c), i});
    } else {
      p2v[i] = cap;
    }
  }
  std::sort(keyed.begin(), keyed.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });

  std::fill(counts, counts + cap, 0);
  std::fill(vox_batch, vox_batch + cap, -1);
  std::fill(vox_coords, vox_coords + 3 * static_cast<size_t>(cap), 0);

  int32_t nvox = -1;
  uint64_t prev = ~0ull;
  for (const auto& [key, idx] : keyed) {
    if (nvox < 0 || !(key == prev)) {
      ++nvox;
      prev = key;
      if (nvox < cap) {
        const int32_t* c = coords + 3 * idx;
        vox_coords[3 * nvox] = c[0];
        vox_coords[3 * nvox + 1] = c[1];
        vox_coords[3 * nvox + 2] = c[2];
        vox_batch[nvox] = batch[idx];
      }
    }
    if (nvox < cap) {
      p2v[idx] = nvox;
      counts[nvox]++;
    } else {
      p2v[idx] = cap;  // overflow
    }
  }
  return std::min(nvox + 1, cap);
}

// 27-neighbor table for a sorted voxel table (submanifold rulebook).
// nbr (cap, 27) i32; missing -> cap.  Tap order: lexicographic
// (dx, dy, dz) in {-1,0,1}^3 (hierarchy.OFFSETS_27).
void build_nbr27(const int32_t* vox_coords, const int32_t* vox_batch,
                 int32_t nvox, int32_t cap, int32_t full_scale, int32_t* nbr) {
  std::unordered_map<Key, int32_t, KeyHash> table;
  table.reserve(nvox * 2);
  for (int32_t v = 0; v < nvox; ++v) {
    const int32_t* c = vox_coords + 3 * v;
    table[{vox_batch[v] * full_scale + c[0], c[1] * full_scale + c[2]}] = v;
  }
  std::fill(nbr, nbr + static_cast<size_t>(cap) * 27, cap);
#pragma omp parallel for schedule(static)
  for (int32_t v = 0; v < nvox; ++v) {
    const int32_t* c = vox_coords + 3 * v;
    int32_t b = vox_batch[v];
    int k = 0;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz, ++k) {
          int32_t x = c[0] + dx, y = c[1] + dy, z = c[2] + dz;
          if (x < 0 || x >= full_scale || y < 0 || y >= full_scale || z < 0 ||
              z >= full_scale)
            continue;
          auto it = table.find({b * full_scale + x, y * full_scale + z});
          if (it != table.end()) nbr[static_cast<size_t>(v) * 27 + k] = it->second;
        }
  }
}

// Slot compaction of a 27-neighbor table (mirrors
// ops/hierarchy.build_slots_tiered, the 3-tier form; the 2-tier
// build_slots_split is the special case h2 == h_max, vh_cap == 0).
//
// nbr: (cap, 27) row-major, `cap` marks a missing neighbor (the transposed
// orientation of the device's (27, V) tables — the host code works
// per-voxel rows).  Emits DEVICE layout, tap-major (H, V):
//   src1/tap1 (h1, cap)             first h1 off-center hits, all voxels
//   idxm (vm_cap,) / invm (cap,)    mid tier: voxels with cnt > h1,
//   srcm/tapm (h2 - h1, vm_cap)     hits h1..h2-1
//   idxh (vh_cap,)                  far tier: voxels with cnt > h2,
//   srch/taph (h_max - h2, vh_cap)  hits h2..h_max-1
// Empty slots: src = cap, tap = 27.  Returns the dropped-hit count
// (hits past h_max or past a tier's compaction capacity).
int64_t build_slots_tiered(const int32_t* nbr, int32_t cap, int32_t h1,
                           int32_t h2, int32_t h_max, int32_t vm_cap,
                           int32_t vh_cap, int32_t* src1, int32_t* tap1,
                           int32_t* idxm, int32_t* invm, int32_t* srcm,
                           int32_t* tapm, int32_t* idxh, int32_t* srch,
                           int32_t* taph) {
  std::vector<int32_t> cnt(cap, 0);
  std::fill(src1, src1 + static_cast<size_t>(h1) * cap, cap);
  std::fill(tap1, tap1 + static_cast<size_t>(h1) * cap, 27);

  // pass 1: tier-1 slots + per-voxel hit counts
#pragma omp parallel for schedule(static)
  for (int32_t v = 0; v < cap; ++v) {
    const int32_t* row = nbr + static_cast<size_t>(v) * 27;
    int32_t h = 0;
    for (int32_t k = 0; k < 27; ++k) {
      if (k == 13 || row[k] >= cap) continue;
      if (h < h1) {
        src1[static_cast<size_t>(h) * cap + v] = row[k];
        tap1[static_cast<size_t>(h) * cap + v] = k;
      }
      ++h;
    }
    cnt[v] = h;
  }

  // pass 2: compaction index maps (voxel order), overflow accounting
  int64_t dropped = 0;
  int32_t nm = 0, nh = 0;
  std::fill(idxm, idxm + vm_cap, cap);
  std::fill(invm, invm + cap, vm_cap);
  std::fill(idxh, idxh + vh_cap, cap);
  for (int32_t v = 0; v < cap; ++v) {
    if (cnt[v] > h_max) dropped += cnt[v] - h_max;
    if (cnt[v] > h1) {
      if (nm < vm_cap) {
        idxm[nm] = v;
        invm[v] = nm;
        ++nm;
      } else {
        dropped += std::min(cnt[v], h2) - h1;
      }
    }
    if (cnt[v] > h2) {
      if (nh < vh_cap) {
        idxh[nh++] = v;
      } else {
        dropped += std::min(cnt[v], h_max) - h2;
      }
    }
  }

  // pass 3: fill the compacted tier tables
  const int32_t hm = h2 - h1, hh = h_max - h2;
  std::fill(srcm, srcm + static_cast<size_t>(hm) * vm_cap, cap);
  std::fill(tapm, tapm + static_cast<size_t>(hm) * vm_cap, 27);
  std::fill(srch, srch + static_cast<size_t>(hh) * vh_cap, cap);
  std::fill(taph, taph + static_cast<size_t>(hh) * vh_cap, 27);
  auto fill_tier = [&](const int32_t* idx, int32_t nrows, int32_t tier_cap,
                       int32_t h_from, int32_t h_to, int32_t* src,
                       int32_t* tap) {
#pragma omp parallel for schedule(static)
    for (int32_t r = 0; r < nrows; ++r) {
      const int32_t* row = nbr + static_cast<size_t>(idx[r]) * 27;
      int32_t h = 0;
      for (int32_t k = 0; k < 27; ++k) {
        if (k == 13 || row[k] >= cap) continue;
        if (h >= h_from && h < h_to) {
          src[static_cast<size_t>(h - h_from) * tier_cap + r] = row[k];
          tap[static_cast<size_t>(h - h_from) * tier_cap + r] = k;
        }
        ++h;
        if (h >= h_to) break;
      }
    }
  };
  fill_tier(idxm, nm, vm_cap, h1, h2, srcm, tapm);
  if (hh > 0) fill_tier(idxh, nh, vh_cap, h2, h_max, srch, taph);
  return dropped;
}

// Parent/child maps between a fine level and the coarse level built from
// coords >> 1.  parent (cap_f,) i32 (missing -> cap_c);
// off_id (cap_f,) i32; child (cap_c, 8) i32 (missing -> cap_f).
void build_transition(const int32_t* fine_coords, const int32_t* fine_batch,
                      int32_t nvox_f, int32_t cap_f,
                      const int32_t* coarse_coords, const int32_t* coarse_batch,
                      int32_t nvox_c, int32_t cap_c, int32_t full_scale_c,
                      int32_t* parent, int32_t* off_id, int32_t* child) {
  std::unordered_map<Key, int32_t, KeyHash> table;
  table.reserve(nvox_c * 2);
  for (int32_t v = 0; v < nvox_c; ++v) {
    const int32_t* c = coarse_coords + 3 * v;
    table[{coarse_batch[v] * full_scale_c + c[0], c[1] * full_scale_c + c[2]}] = v;
  }
  std::fill(parent, parent + cap_f, cap_c);
  std::fill(off_id, off_id + cap_f, 0);
  std::fill(child, child + static_cast<size_t>(cap_c) * 8, cap_f);
  for (int32_t v = 0; v < nvox_f; ++v) {
    const int32_t* c = fine_coords + 3 * v;
    Key key{fine_batch[v] * full_scale_c + (c[0] >> 1),
            (c[1] >> 1) * full_scale_c + (c[2] >> 1)};
    auto it = table.find(key);
    int32_t ofs = ((c[0] & 1) << 2) | ((c[1] & 1) << 1) | (c[2] & 1);
    off_id[v] = ofs;
    if (it != table.end()) {
      parent[v] = it->second;
      child[static_cast<size_t>(it->second) * 8 + ofs] = v;
    }
  }
}

}  // extern "C"
