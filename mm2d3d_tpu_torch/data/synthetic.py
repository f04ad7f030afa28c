"""Synthetic RGB+LiDAR batches (numpy copy of `mm2d3d_tpu/data/synthetic.py`).

The same `np.random.RandomState` gives bit-identical arrays to the JAX
package's `make_batch`; the result is a `train.batch.PointBatch` of CPU
tensors (move it with `PointBatch.to`).  Shapes and value ranges mirror the
nuScenes USA->Singapore configuration: 400x225 images, 5 cm voxels,
full_scale 4096, 6 classes, RGB point features.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.batch import PointBatch


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
    invalid / out-of-range points last (the order of `ops.keys.pack`)."""
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


def make_batch(
    rng: np.random.RandomState,
    batch_size: int = 2,
    height: int = 225,
    width: int = 400,
    n_points: int = 4096,
    num_classes: int = 6,
    full_scale: int = 4096,
    valid_fraction: float = 0.95,
    variant: str = "nuscenes",
    wire: bool = False,
) -> PointBatch:
    """LiDAR-like scene (ground plane + walls) projected to a virtual front
    camera, random labels; `wire=True` gives the uint8 image with the
    per-point features left to `prepare_device_batch`.

    `variant` selects the beam pattern: "nuscenes" (32 rings, the flagship
    geometry) or "kitti" (64 rings over a narrower elevation span, the
    HDL-64E-style pattern of the SemanticKITTI / A2D2 / VirtualKITTI
    scenarios), whose denser rings the `dense` slot profile is sized for
    (`train.batch.default_slot_caps`).

    The JAX function's `separable=True` option serves its learning test;
    it is not part of this port."""
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

    if wire:
        # quantize to the uint8 grid first, so the float twin of this batch is
        # bit-identical to what prepare_device_batch reconstructs
        img_u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
        img = img_u8.astype(np.float32) / 255.0

    feats = np.take_along_axis(
        img.reshape(b, -1, 3),
        (img_indices[..., 0] * width + img_indices[..., 1])[..., None],
        axis=1,
    ).astype(dtype)

    seg_labels_2d = np.full((b, height, width), -100, np.int32)
    for i in range(b):
        seg_labels_2d[i, img_indices[i, :, 0], img_indices[i, :, 1]] = seg_label[i]

    # host-side Morton sort per sample, so voxelize takes its sort-free path
    point_perm = np.zeros((b, n), np.int32)
    for i in range(b):
        perm = morton_sort_perm(coords[i], point_mask[i], full_scale)
        point_perm[i] = perm
        for arr in (coords, img_indices, feats, seg_label, point_mask):
            arr[i] = arr[i][perm]

    t = torch.from_numpy
    return PointBatch(
        img=t(img_u8 if wire else img),
        depth=t(depth),
        img_indices=t(img_indices),
        coords=t(coords),
        feats=None if wire else t(feats),
        seg_label=t(seg_label),
        point_mask=t(point_mask),
        seg_labels_2d=t(seg_labels_2d),
        point_perm=t(point_perm),
        coords_sorted=True,
        feats_from_img=wire,
    )
