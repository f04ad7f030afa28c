"""Host-side data augmentation: 3D point-cloud and 2D image transforms
(port of `mm2d3d_tpu/data/augment.py`).

- `augment_and_scale_3d`: random rotation-matrix noise, axis flips by sign,
  rot-z or rot-y, scale to voxel units, shift to the positive octant,
  optional random translation inside the receptive field; returns (coords,
  min_value, offset, rot_matrix) so the transform stays invertible.
- the image-side ops of the datasets: bilinear resize with projected-point
  rescaling, sparse depth map and dense 2D label map, horizontal flip of
  image / depth / indices / intrinsics, the KITTI-family bottom or random
  crop, color jitter (on the host, or its parameters for the device),
  normalization.

The resize of a uint8 HWC image and the depth and label maps run in C++
(`native.bilinear_resize_u8`, `native.depth_label_maps`), bit-equal to the
numpy code here, unless ``MM2D3D_HOST_NATIVE=0`` (read at each call) selects
numpy.  Where the host library cannot be built, the native path raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def use_native() -> bool:
    """The C++ image ops unless ``MM2D3D_HOST_NATIVE=0``, as in the JAX
    package."""
    return os.environ.get("MM2D3D_HOST_NATIVE", "1") != "0"


# --------------------------------------------------------------------------
# 3D
# --------------------------------------------------------------------------

def augment_and_scale_3d(
    points: np.ndarray,
    scale: float,
    full_scale: int,
    rng: np.random.RandomState,
    noisy_rot: float = 0.0,
    flip_x: float = 0.0,
    flip_y: float = 0.0,
    rot_z: float = 0.0,
    rot_y: float = 0.0,
    transl: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Points (N,3) in meters -> float voxel coords in [0, full_scale)."""
    rot_matrix = np.eye(3, dtype=np.float32)
    if noisy_rot > 0 or flip_x > 0 or flip_y > 0 or rot_z > 0 or rot_y > 0:
        if noisy_rot > 0:
            rot_matrix += rng.randn(3, 3).astype(np.float32) * noisy_rot
        if flip_x > 0:
            rot_matrix[0, 0] *= rng.randint(0, 2) * 2 - 1
        if flip_y > 0:
            rot_matrix[1, 1] *= rng.randint(0, 2) * 2 - 1
        if rot_z > 0:
            theta = rng.rand() * rot_z
            c, s = np.cos(theta), np.sin(theta)
            rot_matrix = rot_matrix @ np.array(
                [[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32
            )
        if rot_y > 0:
            theta = rng.rand() * rot_y
            c, s = np.cos(theta), np.sin(theta)
            rot_matrix = rot_matrix @ np.array(
                [[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32
            )
        points = points @ rot_matrix

    coords = points * scale
    min_value = coords.min(0)
    coords = coords - min_value

    offset = np.zeros(3, np.float32)
    if transl:
        offset = (
            np.clip(full_scale - coords.max(0) - 0.001, a_min=0, a_max=None)
            * rng.rand(3)
        ).astype(np.float32)
        coords = coords + offset

    return coords, min_value.astype(np.float32), offset, rot_matrix


# --------------------------------------------------------------------------
# 2D
# --------------------------------------------------------------------------

def bilinear_resize(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear image resize (PIL.Image.BILINEAR equivalent), HWC uint8/float."""
    in_h, in_w = image.shape[:2]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return image.astype(np.float32)
    if use_native() and image.dtype == np.uint8 and image.ndim == 3:
        from .. import native

        return native.bilinear_resize_u8(image, (out_h, out_w))
    # align_corners=False convention (matches PIL); float64 weights, so a
    # uint8 or float32 image gives float64
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    img = image.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def rescale_points_img(
    points_img: np.ndarray, in_size: Tuple[int, int], out_size: Tuple[int, int]
) -> np.ndarray:
    """Rescale projected (row, col) float coords from in_size (W,H PIL order)
    to out_size, with the reference's floor-then-scale convention
    (nuscenes_dataloader.py:263-268)."""
    in_w, in_h = in_size
    out_w, out_h = out_size
    out = points_img.copy().astype(np.float64)
    out[:, 0] = float(out_h) / in_h * np.floor(points_img[:, 0])
    out[:, 1] = float(out_w) / in_w * np.floor(points_img[:, 1])
    return out


def build_depth_and_label_maps(
    img_indices: np.ndarray,  # (N, 2) int (row, col)
    depths: np.ndarray,  # (N,) z in camera frame
    seg_label: np.ndarray,  # (N,) int
    hw: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse depth map (z at projected pixels) + dense -100-filled 2D label
    map (nuscenes_dataloader.py:274-278)."""
    h, w = hw
    if use_native():
        from .. import native

        return native.depth_label_maps(img_indices, depths, seg_label, (h, w))
    depth = np.zeros((h, w), np.float32)
    depth[img_indices[:, 0], img_indices[:, 1]] = depths
    labels_2d = np.full((h, w), -100, np.int64)
    labels_2d[img_indices[:, 0], img_indices[:, 1]] = seg_label
    return depth, labels_2d


def fliplr_sample(
    image: np.ndarray,
    depth: np.ndarray,
    img_indices: np.ndarray,
    seg_labels_2d: np.ndarray,
    intrinsics: Optional[np.ndarray] = None,
):
    """Horizontal flip of image/depth/2D labels, mirroring point columns.

    Intrinsics update fixes the reference's cy typo
    (nuscenes_dataloader.py:296 uses intrinsics[0,1]; SURVEY.md §5 pitfall 5):
    cx' = W - cx, cy unchanged.
    """
    w = image.shape[1]
    image = np.ascontiguousarray(np.fliplr(image))
    depth = np.ascontiguousarray(np.fliplr(depth))
    seg_labels_2d = np.ascontiguousarray(np.fliplr(seg_labels_2d))
    img_indices = img_indices.copy()
    img_indices[:, 1] = w - 1 - img_indices[:, 1]
    if intrinsics is not None:
        intrinsics = intrinsics.copy()
        intrinsics[0, 2] = w - intrinsics[0, 2]
    return image, depth, img_indices, seg_labels_2d, intrinsics


def crop_with_retry(
    image: np.ndarray,
    points_img: np.ndarray,
    rng: np.random.RandomState,
    crop_size: Tuple[int, int],  # (W, H)
    bottom_crop: bool,
    rand_crop: np.ndarray,
    min_points: int = 100,
):
    """Bottom or random crop, retried up to 10x until more than `min_points`
    projected points survive (semantic_kitti.py:319-391); after 10 failed
    tries the whole image.  Returns (image, points_img, keep_idx, (top,
    left))."""
    w, h = image.shape[1], image.shape[0]
    for _ in range(10):
        if bottom_crop:
            left = int(rng.rand() * (w + 1 - crop_size[0]))
            right = left + crop_size[0]
            top, bottom = h - crop_size[1], h
        else:
            ch, cw = rand_crop[0::2] + rng.rand(2) * (rand_crop[1::2] - rand_crop[0::2])
            top = int(rng.rand() * (1 - ch) * h)
            left = int(rng.rand() * (1 - cw) * w)
            bottom, right = int(top + ch * h), int(left + cw * w)
        keep_idx = (
            (points_img[:, 0] >= top)
            & (points_img[:, 0] < bottom)
            & (points_img[:, 1] >= left)
            & (points_img[:, 1] < right)
        )
        if keep_idx.sum() > min_points:
            cropped = image[top:bottom, left:right]
            pts = points_img[keep_idx].copy()
            pts[:, 0] -= top
            pts[:, 1] -= left
            if len(rand_crop) > 0 and crop_size:
                # a random crop resizes back to crop_size; A2D2 passes no
                # crop_size and resizes separately afterwards
                in_size = (cropped.shape[1], cropped.shape[0])
                pts = rescale_points_img(pts, in_size, tuple(crop_size))
                cropped = bilinear_resize(cropped, (crop_size[1], crop_size[0]))
            return cropped, pts, keep_idx, (top, left)
    return image, points_img, np.ones(len(points_img), bool), (0, 0)


def color_jitter(
    image: np.ndarray,  # HWC float in [0, 1]
    rng: np.random.RandomState,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
) -> np.ndarray:
    """torchvision-style ColorJitter(brightness, contrast, saturation):
    factors drawn uniformly from [max(0, 1-v), 1+v], applied in random order."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        # NB f=f default: the factor must bind NOW — a late-binding
        # closure would silently reuse the saturation draw for brightness
        ops.append(lambda im, f=f: im * f)
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)

        def _contrast(im, f=f):
            mean = im.mean(axis=(0, 1), keepdims=True).mean()
            gray = 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]
            mean = gray.mean()
            return im * f + mean * (1 - f)

        ops.append(_contrast)
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)

        def _sat(im, f=f):
            gray = (0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2])[
                ..., None
            ]
            return im * f + gray * (1 - f)

        ops.append(_sat)
    for i in rng.permutation(len(ops)):
        image = ops[i](image)
    return np.clip(image, 0.0, 1.0)


def draw_jitter_params(
    rng: np.random.RandomState,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
) -> np.ndarray:
    """Draw ColorJitter factors + op order for DEVICE-side application
    (`ops.image.apply_color_jitter`), consuming the SAME RNG stream as
    `color_jitter` (factor draws in brightness/contrast/saturation order,
    then one permutation over the enabled ops) — host- and device-jittered
    pipelines stay bit-reproducible from the same per-sample seed.

    Returns (4,) float32: [f_b, f_c, f_s, order_index].  Disabled ops get
    factor 1.0 (identity) and are placed last in the order, which is
    equivalent to omitting them.
    """
    import itertools

    factors = np.ones(3, np.float32)
    enabled = []
    for k, v in enumerate((brightness, contrast, saturation)):
        if v > 0:
            factors[k] = rng.uniform(max(0.0, 1 - v), 1 + v)
            enabled.append(k)
    perm = rng.permutation(len(enabled))
    order = [enabled[i] for i in perm] + [k for k in range(3) if k not in enabled]
    idx = list(itertools.permutations(range(3))).index(tuple(order))
    return np.array([factors[0], factors[1], factors[2], idx], np.float32)


def normalize_image(image: np.ndarray, mean, std) -> np.ndarray:
    return (image - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def image_jitter_stage(
    image: np.ndarray,
    rng: np.random.RandomState,
    jitter_cfg,
    device_image_ops: bool,
):
    """Shared dataset stage: host path converts to float [0,1] and jitters
    in numpy; device path keeps the raw uint8 and only draws the params
    (`draw_jitter_params`) for `ops.image.apply_color_jitter`.  Both paths
    consume the same RNG draws, keeping downstream augmentations aligned.
    Returns (image, jitter_params-or-None)."""
    if device_image_ops:
        if image.dtype != np.uint8:
            # resize outputs float (0..255); round back to the uint8 wire
            # format — the same quantization the decoded-image cache
            # applies (data.image_cache stores resized uint8)
            image = np.clip(np.rint(image), 0, 255).astype(np.uint8)
        params = (
            draw_jitter_params(rng, *jitter_cfg) if jitter_cfg is not None else None
        )
        return image, params
    image = np.asarray(image, np.float32) / 255.0
    if jitter_cfg is not None:
        image = color_jitter(image, rng, *jitter_cfg)
    return image, None


def rgb_feats_stage(
    image: np.ndarray,
    img_indices: np.ndarray,
    use_rgb: bool,
    device_image_ops: bool,
    n_points: int,
):
    """Per-point features: RGB at the projected pixel (use_rgb) or ones.
    Device path returns None — the gather happens on device from the
    prepared image (train.batch.prepare_device_batch)."""
    if not use_rgb:
        return np.ones([n_points, 1], np.float32)
    if device_image_ops:
        return None
    return image[img_indices[:, 0], img_indices[:, 1]].astype(np.float32)
