"""Static-shape batch structure and per-step topology build
(port of `mm2d3d_tpu/train/batch.py`).

Every sample is padded to `n_points` points; `point_mask` marks real ones
and padding labels are -100, so losses and metrics ignore them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.hierarchy import Hierarchy, build_hierarchy
from ..ops.image import apply_color_jitter
from ..ops.voxelize import VoxelGrid, voxelize


@dataclass
class PointBatch:
    """One batch of RGB+LiDAR pairs with static shapes (tensors).

    `img` may be uint8 (wire format), with `feats` None when
    `feats_from_img`; `prepare_device_batch` materializes both."""

    img: torch.Tensor  # (B, H, W, 3) float32 in [0, 1], or uint8
    depth: torch.Tensor  # (B, H, W, 1) float32 sparse depth
    img_indices: torch.Tensor  # (B, N, 2) int32 (row, col)
    coords: torch.Tensor  # (B, N, 3) int32 voxel coords
    feats: Optional[torch.Tensor]  # (B, N, C) float32 per-point features
    seg_label: torch.Tensor  # (B, N) int32, -100 = ignore
    point_mask: torch.Tensor  # (B, N) bool
    seg_labels_2d: Optional[torch.Tensor] = None  # (B, H, W) int32
    n_dropped: Optional[torch.Tensor] = None  # (B,) int32
    point_perm: Optional[torch.Tensor] = None  # (B, N) int32
    jitter_params: Optional[torch.Tensor] = None  # (B, 4) float32
    coords_sorted: bool = False  # points pre-sorted by Morton key per sample
    feats_from_img: bool = False  # feats gathered from the prepared image

    @property
    def batch_size(self) -> int:
        return self.img.shape[0]

    @property
    def n_points(self) -> int:
        return self.coords.shape[1]

    def to(self, device) -> "PointBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def flatten_points(batch: PointBatch):
    """(B, N, ...) -> (B*N, ...) plus per-point batch indices."""
    b, n = batch.coords.shape[:2]
    coords = batch.coords.reshape(b * n, 3)
    feats = None if batch.feats is None else batch.feats.reshape(b * n, -1)
    labels = batch.seg_label.reshape(b * n)
    mask = batch.point_mask.reshape(b * n)
    bidx = torch.arange(b, dtype=torch.int32,
                        device=coords.device).repeat_interleave(n)
    return coords, feats, labels, mask, bidx


def prepare_device_batch(batch: PointBatch) -> PointBatch:
    """uint8 image -> float32 [0, 1] (times float32(1/255), as in JAX), the
    colour jitter of `jitter_params` (`ops.image.apply_color_jitter`), and
    the per-point RGB gather for `feats_from_img`.  As in JAX, the jitter
    applies on the uint8 path only: float batches with feats pass through
    untouched, `jitter_params` included."""
    img = batch.img
    if img.dtype == torch.uint8:
        # a Python scalar: no host-to-device copy; float32(1/255) survives
        # the round trip through a double exactly
        img = img.to(torch.float32) * float(np.float32(1.0 / 255.0))
        if batch.jitter_params is not None:
            img = apply_color_jitter(img, batch.jitter_params)
        batch = dataclasses.replace(batch, img=img, jitter_params=None)
    if batch.feats_from_img:
        bidx = torch.arange(img.shape[0], device=img.device)[:, None]
        feats = img[bidx, batch.img_indices[..., 0].long(),
                    batch.img_indices[..., 1].long()]
        batch = dataclasses.replace(batch, feats=feats, feats_from_img=False)
    return batch


def default_capacities(num_points: int, num_levels: int,
                       batch_size: Optional[int] = None) -> Tuple[int, ...]:
    """Per-level voxel-row capacities: [P, 5P/8, 3P/8, P/4, ...] with a
    per-scan floor at the coarse levels (the JAX package's default
    profile; see its docstring for the measured occupancies)."""
    caps = []
    for l in range(num_levels):
        if l == 1:
            cap = (num_points * 10) >> 4
        elif l == 2:
            cap = (num_points * 6) >> 4
        else:
            cap = num_points >> max(0, l - 1)
        if batch_size is not None and l >= 3:
            cap = max(cap, batch_size * (2048 >> min(l - 3, 3)))
        caps.append(max(256, min(cap, num_points)))
    return tuple(caps)


# 3-tier plan per level: (h1, h2, h_max, vm_cap / V in 64ths, vh_cap / V in
# 64ths), calibrated by the JAX package on flagship-size scans.
_PLAN3 = {
    0: (3, 6, 26, 28, 2),
    1: (4, 8, 26, 20, 4),
    2: (4, 8, 26, 22, 6),
    3: (4, 8, 26, 24, 6),
    4: (4, 8, 26, 24, 8),
}


def default_slot_caps(num_levels: int, capacities: Tuple[int, ...]):
    """Per-level slot specs: 3-tier (h1, h2, h_max, vm_cap, vh_cap) at levels
    0-4, 2-tier (h_lo, h_max, vh_cap) below.  h_max = 26 is the structural
    maximum, so only a tier's compaction cap can drop hits (monitored as
    `slot_overflow`)."""
    specs = []
    for l in range(num_levels):
        v = capacities[l]
        if l in _PLAN3:
            h1, h2, h_max, nm, nh = _PLAN3[l]
            specs.append((h1, h2, h_max, max(256, v * nm // 64),
                          max(256, v * nh // 64)))
        else:
            specs.append((8, 26, max(256, v * 16 // 64)))
    return tuple(specs)


def build_topology(batch: PointBatch, full_scale: int, num_levels: int,
                   capacities: Optional[Tuple[int, ...]] = None,
                   slot_caps="default") -> Tuple[VoxelGrid, Hierarchy]:
    """Voxelize the batch and build the sparse U-Net hierarchy, as the JAX
    `build_topology`: `capacities` default to `default_capacities`;
    `slot_caps="default"` takes `default_slot_caps`, None builds no slot
    tables (every submanifold conv on the dense 27-tap path, K6), and a
    per-level sequence takes any form `ops.hierarchy.build_hierarchy`
    takes."""
    coords, _, _, mask, bidx = flatten_points(batch)
    if capacities is None:
        capacities = default_capacities(coords.shape[0], num_levels,
                                        batch_size=batch.batch_size)
    if isinstance(slot_caps, str):
        if slot_caps != "default":
            raise ValueError(f"unknown slot caps {slot_caps!r}")
        slot_caps = default_slot_caps(num_levels, capacities)
    grid = voxelize(coords, bidx, mask, full_scale, capacity=capacities[0],
                    presorted=batch.coords_sorted)
    hier = build_hierarchy(grid, num_levels, capacities, slot_caps,
                           num_batches=batch.batch_size)
    return grid, hier
