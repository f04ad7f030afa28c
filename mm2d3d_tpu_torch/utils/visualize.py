"""Qualitative figures and point-cloud export (port of
`mm2d3d_tpu/utils/visualize.py`), drawn with Pillow.

The palettes, `turbo_colormap`, `colorize_labels` and `save_point_cloud_ply`
are numpy copies of the JAX package's and give the same values.  The draw
functions keep its panels, their order and titles, but render with Pillow
instead of matplotlib: each panel is the camera image at its own
resolution (or the dense 2D prediction), every point a `point_size`-pixel
square in its colour, with a title band above; panels stack top to bottom.
Each returns the figure as an (H, W, 3) uint8 array and writes a PNG to
`out_path` when given one.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np

# per-dataset palettes (RGB 0-255), the reference's visualize.py:305-402
NUSCENES_PALETTE = np.array(
    [
        [255, 158, 0],  # vehicle
        [0, 207, 191],  # driveable_surface
        [75, 0, 75],  # sidewalk
        [112, 180, 60],  # terrain
        [222, 184, 135],  # manmade
        [0, 175, 0],  # vegetation
    ],
    np.uint8,
)

A2D2_PALETTE = np.array(
    [
        [255, 0, 0],  # car
        [255, 128, 0],  # truck
        [182, 89, 6],  # bike
        [204, 153, 255],  # person
        [255, 0, 255],  # road
        [150, 50, 4],  # parking
        [180, 150, 200],  # sidewalk
        [241, 230, 255],  # building
        [147, 253, 194],  # nature
        [0, 0, 0],  # other-objects
    ],
    np.uint8,
)

VKITTI_PALETTE = np.array(
    [
        [0, 175, 0],  # vegetation_terrain
        [222, 184, 135],  # building
        [0, 207, 191],  # road
        [128, 128, 128],  # object
        [255, 128, 0],  # truck
        [255, 158, 0],  # car
    ],
    np.uint8,
)

PALETTES = {
    "nuscenes": NUSCENES_PALETTE,
    "a2d2": A2D2_PALETTE,
    "virtual_kitti": VKITTI_PALETTE,
}

# matplotlib's "turbo" colormap (256 entries) as the uint8 RGB that
# `(cmap(t)[..., :3] * 255).astype(np.uint8)` gives for each entry
_TURBO = np.frombuffer(bytes.fromhex(
    "30123b31154232184a341b51351e5836215f37236538266c3929723a2c793b2f7f3c3285"
    "3c358b3d37913e3a963f3d9c4040a14043a64145ab4148b0424bb5434eba4350be4353c2"
    "4456c74458cb455bce455ed24560d64563d94666dd4668e0466be3466de64670e84673eb"
    "4675ed4678f0467af2467df4467ff64682f84584f94587fb4589fc448cfd438efd4291fe"
    "4193fe4096fe3f98fe3e9bfe3c9dfd3ba0fc39a2fc38a5fb36a8f934aaf833acf631aff5"
    "2fb1f32db4f12bb6ef2ab9ed28bbeb26bde925c0e623c2e421c4e120c6df1ec9dc1dcbda"
    "1ccdd71bcfd41ad1d219d3cf18d5cc18d7ca17d9c717dac417dcc217debf18e0bd18e1ba"
    "19e3b81ae4b61be5b41de7b11ee8af20e9ac22eba924eca627eda329eea02cef9d2ff09a"
    "32f19735f39438f4913bf48d3ff58a42f68746f7834af8804df97c51f97955fa7659fb72"
    "5dfb6f61fc6c65fc6869fd656dfd6271fd5f74fe5c78fe597cfe5680fe5384fe5087fe4d"
    "8bfe4b8efe4892fe4695fe4498fe429bfd409efd3ea1fc3da4fc3ba6fb3aa9fb39acfa37"
    "aef937b1f836b3f835b6f735b9f534bbf434bef334c0f233c3f133c5ef33c8ee33caed33"
    "cdeb34cfea34d1e834d4e735d6e535d8e335dae236dde036dfde36e1dc37e3da37e5d838"
    "e7d738e8d538ead339ecd139edcf39efcd39f0cb3af2c83af3c63af4c43af6c23af7c039"
    "f8be39f9bc39f9ba38fab737fbb537fbb336fcb035fcae34fdab33fda932fda631fda330"
    "fea12ffe9e2efe9b2dfe982cfd952bfd9229fd8f28fd8c27fc8926fc8624fb8323fb8022"
    "fa7d20fa7a1ff9771ef8741cf7711bf76e1af66b18f56817f46516f36315f26014f15d13"
    "ef5a11ee5810ed550fec520eea500de94d0de84b0ce6490be5460ae3440ae24209e04008"
    "de3e08dd3c07db3a07d93806d73606d63405d43205d23005d02f04ce2d04cb2b03c92903"
    "c72803c52602c32402c02302be2102bb1f01b91e01b61c01b41b01b11901ae1801ac1601"
    "a91501a61401a31201a011019d10019a0e01970d01940c01910b018e0a018b0901870801"
    "8407018106027d05027a0402"
), np.uint8).reshape(256, 3)

TITLE_HEIGHT = 16  # pixels of the title band above each panel
_BLACK, _WHITE = (0, 0, 0), (255, 255, 255)


def turbo_colormap(values: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Map scalars to turbo RGB (uint8); NaN maps to black, as matplotlib's
    "bad" colour does."""
    v = np.asarray(values, np.float64)
    vmin = np.nanmin(v) if vmin is None else vmin
    vmax = np.nanmax(v) if vmax is None else vmax
    t = np.clip((v - vmin) / max(vmax - vmin, 1e-9), 0, 1)
    bad = np.isnan(t)
    # matplotlib's lookup: t * N, the top end folded into the last entry
    idx = np.minimum(np.where(bad, 0, t) * 256, 255).astype(np.int64)
    out = _TURBO[idx]
    out[bad] = 0
    return out


def colorize_labels(labels: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Labels (-100 = black) -> RGB."""
    out = np.zeros(labels.shape + (3,), np.uint8)
    valid = labels >= 0
    out[valid] = palette[np.clip(labels[valid], 0, len(palette) - 1)]
    return out


def _as_uint8(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    return image if image.dtype == np.uint8 else (
        np.clip(image, 0, 1) * 255).astype(np.uint8)


def scatter_points(canvas: np.ndarray, img_indices: np.ndarray,
                   colors: np.ndarray, point_size: int = 2) -> np.ndarray:
    """A copy of `canvas` (H, W, 3) with each point (row, col) a square of
    `point_size` pixels in its colour, covering rows and columns
    [i - (point_size - 1) // 2, i + point_size // 2]; later points
    overwrite earlier ones."""
    out = np.array(canvas, np.uint8, copy=True)
    h, w = out.shape[:2]
    idx = np.asarray(img_indices, np.int64).reshape(-1, 2)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    lo = -((point_size - 1) // 2)
    for dr in range(lo, lo + point_size):
        for dc in range(lo, lo + point_size):
            r, c = idx[:, 0] + dr, idx[:, 1] + dc
            keep = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            out[r[keep], c[keep]] = colors[keep]
    return out


def _titled(panel: np.ndarray, title: str) -> np.ndarray:
    """`panel` under a white band of TITLE_HEIGHT pixels holding `title`."""
    from PIL import Image, ImageDraw

    band = Image.new("RGB", (panel.shape[1], TITLE_HEIGHT), _WHITE)
    ImageDraw.Draw(band).text((2, 2), title, fill=_BLACK)
    return np.concatenate([np.asarray(band), panel], axis=0)


def _save(figure: np.ndarray, out_path: Optional[str]) -> np.ndarray:
    if out_path:
        from PIL import Image

        os.makedirs(osp.dirname(out_path) or ".", exist_ok=True)
        Image.fromarray(figure).save(out_path)
    return figure


def panel_origins(height: int, n_panels: int) -> Sequence[Tuple[int, int]]:
    """(row, col) of each panel's image in a figure of `n_panels` panels of
    `height` rows each, as the draw functions stack them."""
    return [(i * (height + TITLE_HEIGHT) + TITLE_HEIGHT, 0) for i in range(n_panels)]


def draw_points_image_labels(
    image: np.ndarray,  # (H, W, 3) float [0,1] or uint8
    img_indices: np.ndarray,  # (N, 2)
    seg_labels: np.ndarray,  # (N,)
    color_palette: np.ndarray,
    point_size: int = 2,
    out_path: Optional[str] = None,
):
    """Per-point class colours over the camera image (visualize.py:405+)."""
    colors = colorize_labels(np.asarray(seg_labels), np.asarray(color_palette, np.uint8))
    return _save(scatter_points(_as_uint8(image), img_indices, colors, point_size),
                 out_path)


def draw_points_image_labels_with_confidence(
    image: np.ndarray,
    pred_2d_dense: np.ndarray,  # (H, W) argmax of the dense 2D logits
    pred_2d_points: np.ndarray,  # (N,)
    pred_3d_points: np.ndarray,  # (N,)
    confidence: np.ndarray,  # (N,) sigmoid gate
    gt_labels: np.ndarray,  # (N,)
    img_indices: np.ndarray,  # (N, 2)
    color_palette: np.ndarray,
    out_path: Optional[str] = None,
):
    """5-panel qualitative figure (visualize.py:474-553): dense 2D pred, GT
    points, 2D pred points, 3D pred points, per-point confidence."""
    palette = np.asarray(color_palette, np.uint8)
    img = _as_uint8(image)
    panels = [
        ("2D dense pred", colorize_labels(np.asarray(pred_2d_dense), palette), None),
        ("GT points", img, colorize_labels(np.asarray(gt_labels), palette)),
        ("2D pred points", img, colorize_labels(np.asarray(pred_2d_points), palette)),
        ("3D pred points", img, colorize_labels(np.asarray(pred_3d_points), palette)),
        ("3D confidence", img, turbo_colormap(np.asarray(confidence).reshape(-1), 0, 1)),
    ]
    figure = np.concatenate([
        _titled(base if colors is None else scatter_points(base, img_indices, colors),
                title)
        for title, base, colors in panels], axis=0)
    return _save(figure, out_path)


def draw_points_image_depth(
    image: np.ndarray,
    img_indices: np.ndarray,
    depth: np.ndarray,  # (N,) per-point depth
    point_size: int = 2,
    out_path: Optional[str] = None,
):
    """Depth-coloured point overlay (visualize.py:556-675)."""
    return _save(scatter_points(_as_uint8(image), img_indices, turbo_colormap(depth),
                                point_size), out_path)


def draw_bird_eye_view(coords: np.ndarray, full_scale: int = 4096,
                       out_path: Optional[str] = None):
    """Top-down voxel scatter (visualize.py BEV helper): x to the right, y
    up, [0, full_scale) over 600 pixels (the JAX figure's 6 inches at 100
    dpi)."""
    size = 600
    xy = np.asarray(coords)[:, :2].astype(np.float64) * size / full_scale
    keep = ((xy >= 0) & (xy < size)).all(1)
    rows = size - 1 - xy[keep, 1].astype(np.int64)
    cols = xy[keep, 0].astype(np.int64)
    canvas = np.full((size, size, 3), 255, np.uint8)
    canvas[rows, cols] = (31, 119, 180)
    return _save(canvas, out_path)


def save_point_cloud_ply(
    path: str,
    points: np.ndarray,  # (N, 3)
    colors: Optional[np.ndarray] = None,  # (N, 3) uint8
):
    """ASCII PLY export (visualize.py:692-733)."""
    n = len(points)
    has_color = colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.4f} {points[i, 1]:.4f} {points[i, 2]:.4f}"
            if has_color:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")
