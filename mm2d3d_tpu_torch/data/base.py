"""Shared dataset machinery (port of `mm2d3d_tpu/data/base.py`):
pickle-backed scan lists, label merging, pseudo-label handling,
static-shape padding, and collation to the port's `PointBatch`.

Samples are plain numpy, padded to a fixed per-sample capacity; `collate`
stacks them with the JAX package's numpy code and wraps the arrays as CPU
tensors (`torch.from_numpy`), so both packages see the same bits.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..train.batch import PointBatch
from .pseudo_labels import load_and_refine_pseudo_labels
from .synthetic import morton_sort_perm

IGNORE = -100


class ScanListDataset:
    """Base: loads per-split pickle lists of scan dicts + optional pseudo labels.

    Mirrors NuScenesLidarSegBase-style behavior (nuscenes_dataloader.py:62-177):
    - ``split`` is a tuple of split names; ``<split>.pkl`` files are
      concatenated;
    - ``pselab_paths`` loads + refines 2D/3D/ensemble pseudo labels;
    - ``label_mapping`` maps raw class ids to merged training ids (-100 drop).
    """

    class_names: List[str] = []
    categories: Dict[str, List[str]] = {}

    def __init__(
        self,
        split: Sequence[str],
        preprocess_dir: str,
        merge_classes: bool = True,
        pselab_paths: Optional[str] = None,
    ):
        self.split = tuple(split)
        self.preprocess_dir = preprocess_dir
        self.data: List[Dict[str, Any]] = []
        for s in self.split:
            with open(osp.join(preprocess_dir, s + ".pkl"), "rb") as f:
                self.data.extend(pickle.load(f))

        self.pselab_data = None
        if pselab_paths:
            self.pselab_data = load_and_refine_pseudo_labels(
                pselab_paths, expected_lengths=[len(d["seg_labels"]) for d in self.data]
            )

        if merge_classes:
            self.label_mapping = np.full(len(self.class_names), IGNORE, np.int64)
            for cat_idx, cat_list in enumerate(self.categories.values()):
                for name in cat_list:
                    self.label_mapping[self.class_names.index(name)] = cat_idx
            self.merged_class_names = list(self.categories.keys())
        else:
            self.label_mapping = None
            self.merged_class_names = list(self.class_names)

    @property
    def num_classes(self) -> int:
        return len(self.merged_class_names)

    def __len__(self) -> int:
        return len(self.data)

    def map_labels(self, labels: np.ndarray) -> np.ndarray:
        labels = labels.astype(np.int64)
        if self.label_mapping is None:
            return labels
        return self.label_mapping[labels]

    def attach_pseudo_labels(self, out: Dict[str, Any], index: int, idxs: np.ndarray):
        if self.pselab_data is None:
            return
        ps = self.pselab_data[index]
        out["pseudo_label_2d"] = ps["pseudo_label_2d"][idxs]
        out["pseudo_label_3d"] = (
            None if ps["pseudo_label_3d"] is None else ps["pseudo_label_3d"][idxs]
        )
        out["pseudo_label_ensemble"] = ps["pseudo_label_ensemble"][idxs]


def _class_counts(dataset: ScanListDataset) -> np.ndarray:
    """Points per merged class over every scan of `dataset`."""
    counts = np.zeros(dataset.num_classes, np.int64)
    for rec in dataset.data:
        labels = dataset.map_labels(rec["seg_labels"])
        counts += np.bincount(labels[labels != IGNORE],
                              minlength=dataset.num_classes)
    return counts


def compute_class_weights(dataset: ScanListDataset) -> np.ndarray:
    """Log-smoothed class weights (nuscenes_dataloader.py:421-441):
    log(5 * total / per_class), normalized by the minimum."""
    counts = _class_counts(dataset)
    w = np.log(5 * counts.sum() / np.maximum(counts, 1))
    return w / w.min()


def compute_stats(dataset: ScanListDataset, out_dir: Optional[str] = None):
    """Per-class point-count histogram (reference nuscenes_dataloader.py
    compute_stats); with `out_dir`, also a bar plot of the split there
    (matplotlib, imported only then)."""
    counts = _class_counts(dataset)
    if out_dir is not None:
        import os

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(out_dir, exist_ok=True)
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.barh(dataset.merged_class_names, counts)
        ax.grid(axis="x")
        fig.tight_layout()
        fig.savefig(osp.join(out_dir, f"{'_'.join(dataset.split)}_stats.png"))
        plt.close(fig)
    return counts


# --------------------------------------------------------------------------
# Static-shape padding + collation
# --------------------------------------------------------------------------

_POINT_KEYS = (
    "coords", "img_indices", "feats", "seg_label", "points", "point_mask",
    "pseudo_label_2d", "pseudo_label_3d", "pseudo_label_ensemble",
)


def pad_sample(
    sample: Dict[str, Any], n_points: int, full_scale: Optional[int] = None
) -> Dict[str, Any]:
    """Pad/truncate point-indexed arrays to exactly ``n_points`` rows.

    Adds ``point_mask``; padded labels are -100.  Truncation keeps the first
    n_points points and records the overflow in ``n_dropped``.

    When ``full_scale`` is given, points are additionally sorted by their
    Morton voxel key (`morton_sort_perm`) so the device voxelizer can take
    its sort-free path; ``point_perm`` records the original index of each
    sorted row (consumers that must restore scan order — e.g. the
    pseudo-label generator — invert with it).

    A sample carrying ``_pad_tail_: True`` (set by the loader to fill a
    partial tail batch, `data.loader.Loader`) is fully invalidated: every
    point masked out, every label -100, so it contributes nothing to losses
    or confusion matrices — evaluation stays exact over the dataset (the
    reference evaluates every scan, train.py:297-339).
    """
    n = len(sample["coords"])
    keep = min(n, n_points)
    out = dict(sample)
    pad_tail = bool(out.pop("_pad_tail_", False))
    out["n_dropped"] = 0 if pad_tail else max(0, n - n_points)

    def pad(arr, fill=0):
        arr = np.asarray(arr)[:keep]
        if keep == n_points:
            return arr
        pad_width = [(0, n_points - keep)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad_width, constant_values=fill)

    out["coords"] = pad(sample["coords"])
    out["img_indices"] = pad(sample["img_indices"])
    # feats None = wire format: per-point RGB gathered on device
    # (train.batch.prepare_device_batch)
    if sample.get("feats") is not None:
        out["feats"] = pad(sample["feats"])
    out["seg_label"] = pad(sample["seg_label"], fill=IGNORE)
    if "points" in sample:
        out["points"] = pad(sample["points"])
    for key in ("pseudo_label_2d", "pseudo_label_3d", "pseudo_label_ensemble"):
        if sample.get(key) is not None:
            out[key] = pad(sample[key], fill=IGNORE)
    mask = np.zeros(n_points, bool)
    mask[:keep] = True
    if pad_tail:
        mask[:] = False
        out["seg_label"] = np.full(n_points, IGNORE, out["seg_label"].dtype)
        if out.get("seg_labels_2d") is not None:
            out["seg_labels_2d"] = np.full_like(
                np.asarray(out["seg_labels_2d"]), IGNORE
            )
        for key in ("pseudo_label_2d", "pseudo_label_3d", "pseudo_label_ensemble"):
            if out.get(key) is not None:
                out[key] = np.full(n_points, IGNORE, np.asarray(out[key]).dtype)
    out["point_mask"] = mask

    if full_scale is not None:
        perm = morton_sort_perm(out["coords"], mask, full_scale)
        for key in _POINT_KEYS:
            if out.get(key) is not None:
                out[key] = np.asarray(out[key])[perm]
        out["point_perm"] = perm
    return out


def collate(
    samples: List[Dict[str, Any]],
    n_points: int,
    full_scale: Optional[int] = None,
) -> PointBatch:
    """Stack padded samples into a PointBatch (static shapes).

    With ``full_scale`` set, each sample's points are Morton-sorted
    host-side and the batch is marked ``coords_sorted`` (see
    `morton_sort_perm`); batch-major flattening then yields globally
    sorted pair keys (per-sample invalid tails are tolerated by the
    voxelizer's segment logic).
    """
    padded = [pad_sample(s, n_points, full_scale=full_scale) for s in samples]

    def stack(key, dtype=None, required=True):
        if not required and padded[0].get(key) is None:
            return None
        arr = np.stack([p[key] for p in padded])
        return arr if dtype is None else arr.astype(dtype)

    # wire format: uint8 images ship as-is (4x fewer bytes; device runs
    # /255 + jitter — train.batch.prepare_device_batch); float stays float32
    img = np.stack([p["img"] for p in padded])
    if img.dtype != np.uint8:
        img = img.astype(np.float32)
    depth = stack("depth", np.float32)
    if depth.ndim == 3:
        depth = depth[..., None]
    def t(arr):
        return None if arr is None else torch.from_numpy(np.ascontiguousarray(arr))

    return PointBatch(
        img=t(img),
        depth=t(depth),
        img_indices=t(stack("img_indices", np.int32)),
        coords=t(stack("coords", np.int32)),
        feats=t(stack("feats", np.float32, required=False)),
        seg_label=t(stack("seg_label", np.int32)),
        point_mask=t(stack("point_mask")),
        seg_labels_2d=t(stack("seg_labels_2d", np.int32, required=False)),
        n_dropped=t(np.array([p["n_dropped"] for p in padded], np.int32)),
        pseudo_label_2d=t(stack("pseudo_label_2d", np.int32, required=False)),
        pseudo_label_3d=t(stack("pseudo_label_3d", np.int32, required=False)),
        pseudo_label_ensemble=t(stack("pseudo_label_ensemble", np.int32,
                                      required=False)),
        point_perm=t(stack("point_perm", np.int32, required=False)),
        jitter_params=t(stack("jitter_params", np.float32, required=False)),
        coords_sorted=full_scale is not None,
        feats_from_img=padded[0].get("feats") is None,
    )
