"""Seeded RGB + LiDAR scans: a frozen copy of `make_batch` and
`morton_sort_perm` from `mm2d3d_tpu_torch/data/synthetic.py`.

The copy is the benchmark's own, so that a later change to the program's
generator cannot change the traffic it is measured on.  It returns plain
numpy arrays: the harness hands the same arrays to the program (as its
batch type) and to the reference.  Scenes are a ground plane and random
walls seen by a 32-beam (nuScenes) or 64-beam (KITTI-family) scanner,
projected into a pinhole camera; labels are random.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _part1by2_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0xFFF)
    v = (v ^ (v << np.uint64(16))) & np.uint64(0x0000FF0000FF)
    v = (v ^ (v << np.uint64(8))) & np.uint64(0x00F00F00F00F)
    v = (v ^ (v << np.uint64(4))) & np.uint64(0x0C30C30C30C3)
    v = (v ^ (v << np.uint64(2))) & np.uint64(0x249249249249)
    return v


def morton_sort_perm(coords: np.ndarray, valid: np.ndarray,
                     full_scale: int) -> np.ndarray:
    """Stable permutation ordering points by their 36-bit Morton key,
    invalid / out-of-range points last."""
    ok = (
        np.asarray(valid, bool)
        & (coords >= 0).all(-1)
        & (coords < full_scale).all(-1)
    )
    key = (
        _part1by2_np(coords[:, 2])
        | (_part1by2_np(coords[:, 1]) << np.uint64(1))
        | (_part1by2_np(coords[:, 0]) << np.uint64(2))
    )
    key = np.where(ok, key, np.uint64(0xFFFFFFFFFFFF))
    return np.argsort(key, kind="stable").astype(np.int32)


def make_batch(rng: np.random.RandomState, batch_size: int, height: int,
               width: int, n_points: int, num_classes: int, full_scale: int,
               valid_fraction: float = 0.95,
               variant: str = "nuscenes") -> Dict[str, np.ndarray]:
    """One wire-format batch: {"img" (B, H, W, 3) uint8, "depth" (B, H, W, 1)
    float32, "img_indices" (B, N, 2) int32 (row, col), "coords" (B, N, 3)
    int32 voxel coords, "seg_label" (B, N) int32 (-100 = ignore),
    "point_mask" (B, N) bool}; each sample's points in Morton order, its
    invalid points last."""
    b, n = batch_size, n_points
    dtype = np.float32

    img = rng.rand(b, height, width, 3).astype(dtype)

    if variant == "kitti":
        n_rings = 64
        elev = np.linspace(-0.43, 0.035, n_rings)  # HDL-64E-like span
    elif variant == "nuscenes":
        n_rings = 32
        elev = np.linspace(-0.42, 0.08, n_rings)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    per_ring = n // n_rings
    az = np.linspace(-0.45, 0.45, per_ring)
    elev_g, az_g = np.meshgrid(elev, az, indexing="ij")
    elev_f = np.broadcast_to(elev_g.reshape(1, -1), (b, n_rings * per_ring))
    az_f = np.broadcast_to(az_g.reshape(1, -1), (b, n_rings * per_ring))

    sensor_h = 1.6
    with np.errstate(divide="ignore"):
        ground_r = np.where(elev_f < -1e-3, sensor_h / np.tan(-elev_f), 120.0)
    rng_range = np.clip(ground_r, 2.0, 120.0)
    for _ in range(6):  # random walls at fixed depths/azimuth bands
        wall_z = rng.rand(b, 1) * 50 + 5
        az0 = (rng.rand(b, 1) - 0.5) * 0.8
        wid = rng.rand(b, 1) * 0.1 + 0.02
        hit = np.abs(az_f - az0) < wid
        rng_range = np.where(hit, np.minimum(rng_range, wall_z), rng_range)
    rng_range = rng_range + rng.randn(b, n_rings * per_ring) * 0.02

    zc = (rng_range * np.cos(elev_f) * np.cos(az_f))[:, :n]
    xc = (rng_range * np.cos(elev_f) * np.sin(az_f))[:, :n]
    yc = (sensor_h + rng_range * np.sin(elev_f) * -1.0)[:, :n]
    if zc.shape[1] < n:  # pad remainder with repeats
        extra = n - zc.shape[1]
        zc = np.concatenate([zc, zc[:, :extra]], 1)
        xc = np.concatenate([xc, xc[:, :extra]], 1)
        yc = np.concatenate([yc, yc[:, :extra]], 1)
    zc = np.clip(zc, 2.0, 120.0)
    pts = np.stack([xc, yc, zc], -1).astype(np.float32)

    # voxelize at scale 20 (5 cm), shift to the positive octant per sample
    coords = pts * 20.0
    coords = coords - coords.min(axis=1, keepdims=True)
    coords = np.floor(coords).astype(np.int32)
    coords = np.clip(coords, 0, full_scale - 1)

    # pinhole projection to image indices
    f = 0.9 * width
    u = np.clip((xc / zc) * f + width / 2, 0, width - 1)
    v = np.clip(((yc - 1.0) / zc) * f + height / 2, 0, height - 1)
    img_indices = np.stack([v, u], -1).astype(np.int32)

    depth = np.zeros((b, height, width, 1), dtype)
    for i in range(b):
        depth[i, img_indices[i, :, 0], img_indices[i, :, 1], 0] = zc[i]

    n_valid = max(1, int(n * valid_fraction))
    point_mask = np.zeros((b, n), bool)
    point_mask[:, :n_valid] = True

    seg_label = rng.randint(0, num_classes, (b, n)).astype(np.int32)
    seg_label[rng.rand(b, n) < 0.05] = -100  # ignore sprinkles
    seg_label[~point_mask] = -100

    img_u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)

    # host-side Morton sort per sample, so the program's voxelize takes its
    # sort-free path
    for i in range(b):
        perm = morton_sort_perm(coords[i], point_mask[i], full_scale)
        for arr in (coords, img_indices, seg_label, point_mask):
            arr[i] = arr[i][perm]

    return {"img": img_u8, "depth": depth, "img_indices": img_indices,
            "coords": coords, "seg_label": seg_label, "point_mask": point_mask}
