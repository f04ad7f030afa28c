"""Static-shape voxelization (port of `mm2d3d_tpu/ops/voxelize.py`).

Deduplicates integer point coordinates into a sorted voxel table (SCN
InputLayer mode 4: mean pooling) and maps voxel features back to points
(OutputLayer).  Invalid and overflow points go to a dump row.  Every index
is bounded where the JAX code bounds it, and writes that JAX drops go to a
dump row that is cut off afterwards, so shapes stay static and no index
leaves its tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import keys as K


@dataclass
class VoxelGrid:
    """A deduplicated, sorted voxel table with the point->voxel map.

    Rows [0, num_voxels) are valid and sorted by key; the rest are padding
    (key INVALID).  `p2v` maps each point to its row or to `capacity` (the
    dump row)."""

    key_hi: torch.Tensor  # (V,) int32
    key_lo: torch.Tensor  # (V,) int32
    coords: torch.Tensor  # (V, 3) int32 (0 on padding rows)
    batch: torch.Tensor  # (V,) int32 (-1 on padding rows)
    valid: torch.Tensor  # (V,) bool
    num_voxels: torch.Tensor  # () int32
    p2v: torch.Tensor  # (P,) int32 in [0, V]
    counts: torch.Tensor  # (V,) int32 points per voxel
    full_scale: int
    sort_perm: Optional[torch.Tensor] = None  # (P,) int32 (sorted path)
    seg_sorted: Optional[torch.Tensor] = None  # (P,) int32, nondecreasing
    valid_sorted: Optional[torch.Tensor] = None  # (P,) bool

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]


def voxelize(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
             full_scale: int, capacity: Optional[int] = None,
             presorted: bool = False) -> VoxelGrid:
    """Deduplicate (P, 3) int32 coords (+ (P,) batch, (P,) bool valid) into a
    sorted voxel table of `capacity` rows (default P).

    `presorted`: points are already (batch, morton)-sorted with each sample's
    invalid points at its tail (`data.synthetic.morton_sort_perm`), so the
    sort and the p2v inversion are skipped."""
    in_range = (coords >= 0).all(-1) & (coords < full_scale).all(-1)
    valid = valid & in_range
    hi, lo = K.pack(coords, batch)
    hi, lo = K.mask_invalid(hi, lo, valid)
    if presorted:
        return _dedup(hi, lo, full_scale, capacity, perm=None, with_counts=True)
    perm = K.sort_perm(hi, lo)
    p = perm.long()
    return _dedup(hi[p], lo[p], full_scale, capacity, perm=perm)


def dedup_sorted(hi: torch.Tensor, lo: torch.Tensor, full_scale: int,
                 capacity: Optional[int] = None) -> VoxelGrid:
    """`voxelize` for keys already sorted ascending (INVALID rows last); used
    by stride-2 coarsening.  `counts` are zeros (unused above level 0)."""
    return _dedup(hi, lo, full_scale, capacity, perm=None, with_counts=False)


def _dedup(hs, ls, full_scale, capacity, perm, with_counts=True) -> VoxelGrid:
    p = hs.shape[0]
    dev = hs.device
    v_cap = capacity if capacity is not None else p
    valid_s = hs != K.INVALID

    prev_hi = torch.cat([hs[:1] - 1, hs[:-1]])
    prev_lo = torch.cat([ls[:1] - 1, ls[:-1]])
    is_new = ((hs != prev_hi) | (ls != prev_lo)) & valid_s

    seg_raw = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    num_voxels = is_new.sum(dtype=torch.int32)
    seg = torch.where(valid_s & (seg_raw < v_cap) & (seg_raw >= 0), seg_raw,
                      v_cap).to(torch.int32)
    # monotone segment ids: invalid rows inherit the previous segment (their
    # values are masked instead, cf. the JAX _dedup)
    seg_m = seg_raw.clamp(0, v_cap)

    row_valid = torch.arange(v_cap, device=dev) < torch.clamp(num_voxels, max=v_cap)
    # one write of the key pairs at segment starts; every other row goes to
    # the dump row v_cap, which is cut off
    dst = torch.where(is_new & (seg_raw < v_cap), seg_raw, v_cap).long()
    table = torch.full((v_cap + 1, 2), K.INVALID, dtype=torch.int32, device=dev)
    table[dst] = torch.stack([hs, ls], 1)
    key_hi, key_lo = table[:v_cap, 0].contiguous(), table[:v_cap, 1].contiguous()
    vox_coords, vox_batch = K.unpack(key_hi, key_lo)
    vox_coords = torch.where(row_valid[:, None], vox_coords, 0).to(torch.int32)
    vox_batch = torch.where(row_valid, vox_batch, -1).to(torch.int32)

    if with_counts:
        counts = torch.zeros(v_cap + 1, dtype=torch.int32, device=dev)
        counts.index_add_(0, seg_m.long(), valid_s.to(torch.int32))
        counts = counts[:v_cap]
    else:
        counts = torch.zeros(v_cap, dtype=torch.int32, device=dev)

    if perm is None:
        p2v = seg
    else:
        p2v = torch.empty(p, dtype=torch.int32, device=dev)
        p2v[perm.long()] = seg

    keep_sorted = perm is not None or with_counts
    return VoxelGrid(
        key_hi=key_hi, key_lo=key_lo, coords=vox_coords, batch=vox_batch,
        valid=row_valid, num_voxels=torch.clamp(num_voxels, max=v_cap),
        p2v=p2v, counts=counts, full_scale=full_scale, sort_perm=perm,
        seg_sorted=seg_m if keep_sorted else None,
        valid_sorted=valid_s if keep_sorted else None,
    )


def pool_features(grid: VoxelGrid, feats: torch.Tensor) -> torch.Tensor:
    """Mean-pool per-point features into the rows of a `voxelize` grid
    (InputLayer mode 4), as a segment sum in key order."""
    v = grid.capacity
    fs = feats if grid.sort_perm is None else feats[grid.sort_perm.long()]
    # seg_sorted is monotone (invalid rows inherit the previous segment), so
    # invalid rows' values are masked instead of routed to the dump row
    fs = torch.where(grid.valid_sorted[:, None], fs, 0)
    total = feats.new_zeros((v + 1, feats.shape[-1]))
    total.index_add_(0, grid.seg_sorted.long(), fs)
    denom = grid.counts.clamp(min=1).to(feats.dtype)[:, None]
    return total[:v] / denom


def unpool_features(grid: VoxelGrid, voxel_feats: torch.Tensor) -> torch.Tensor:
    """Gather voxel features back to points (OutputLayer); invalid -> zeros."""
    padded = torch.cat([voxel_feats, voxel_feats.new_zeros((1, voxel_feats.shape[-1]))])
    return padded[grid.p2v.long()]
