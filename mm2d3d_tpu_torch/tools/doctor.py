"""Data-directory doctor: validate preprocessed data BEFORE a run (port of
`mm2d3d_tpu/tools/doctor.py`: the same checks, problems and warnings; its
`--perf` option runs the port's host self-validation, `tools/autotune.py`).

The first real-data run in a new environment should fail with an
actionable message, not deep inside a training step.  This checks a
preprocessed pkl directory (and its images / caches / pseudo-labels)
against the schema the datasets actually consume
(`data/nuscenes.py:117-136`, `data/semantic_kitti.py:149-157`,
`data/a2d2.py:153-159`, `data/virtual_kitti.py:111-138`; reference
consumption: the reference's ``lib/dataset/nuscenes_dataloader.py:96-162``).

Usage (any form):
    python -m mm2d3d_tpu_torch.tools.doctor --config configs/config.yaml
    python -m mm2d3d_tpu_torch.tools.doctor --preprocess-dir /data/nuscenes \\
        --scenario nuscenes --splits train_usa train_singapore \\
        [--data-dir /data/nuscenes] [--resize 400 225] \\
        [--image-cache-dir ...] [--pselab ...]
    python -m mm2d3d_tpu_torch.tools.doctor --perf [autotune options]

Exit code 0 = all checks passed; 1 = problems found (each printed with the
file / record index and a suggested fix).
"""

from __future__ import annotations

import argparse
import os.path as osp
import pickle
import sys
from typing import Dict, List, Optional

import numpy as np

# keys every scan record must carry, per scenario dataset class
REQUIRED_KEYS = {
    "nuscenes": ("points", "pts_cam_coord", "seg_labels", "points_img",
                 "camera_path", "calib"),
    "semantic_kitti": ("points", "pts_cam_coord", "seg_labels", "points_img",
                       "camera_path", "intrinsics"),
    "a2d2": ("points", "pts_cam_coord", "seg_labels", "points_img",
             "camera_path"),
    "virtual_kitti": ("points", "seg_labels", "scene_id", "frame_id"),
}

PSELAB_KEYS = ("probs_2d", "pseudo_label_2d", "probs_3d", "pseudo_label_3d",
               "probs_ensemble", "pseudo_label_ensemble")


class Doctor:
    def __init__(self):
        self.problems: List[str] = []
        self.checked = 0

    def problem(self, msg: str, fix: str = ""):
        self.problems.append(msg + (f"\n    fix: {fix}" if fix else ""))

    def ok(self):
        self.checked += 1

    def report(self) -> int:
        print(f"\n{self.checked} checks passed, {len(self.problems)} problem(s)")
        for p in self.problems:
            print(f"  PROBLEM: {p}")
        return 1 if self.problems else 0


def _check_array(doc, where, rec, key, ndim, n_points=None, dtype_kind=None):
    v = rec.get(key)
    if v is None:
        return None
    v = np.asarray(v)
    if v.ndim != ndim:
        doc.problem(f"{where}: '{key}' has shape {v.shape}, expected "
                    f"{ndim}-D")
        return None
    if n_points is not None and len(v) != n_points:
        doc.problem(
            f"{where}: '{key}' has {len(v)} rows but 'points' has "
            f"{n_points} — per-point arrays must align",
            "re-run the offline preprocessing for this split")
        return None
    if dtype_kind and v.dtype.kind not in dtype_kind:
        doc.problem(f"{where}: '{key}' dtype {v.dtype} (kind "
                    f"'{v.dtype.kind}'), expected kind in {dtype_kind!r}")
        return None
    if v.dtype.kind == "f" and not np.isfinite(v).all():
        doc.problem(f"{where}: '{key}' contains non-finite values")
        return None
    doc.ok()
    return v


def _in_grid_count(rec, scale, full_scale, camera_coords) -> int:
    """Points that land inside the scaled full_scale grid — what the
    runtime budget actually applies to (the datasets filter to in-bounds
    BEFORE pad_sample truncates; raw record counts overestimate for
    64-beam scans whose far points fall outside the grid).  Computed with
    the eval-path transform (no augmentation: coords = points*scale
    shifted to the positive octant).  Still an upper bound on loaded
    points: image-FoV crops (KITTI-family) can only reduce it further."""
    pts = rec.get("pts_cam_coord") if camera_coords else rec.get("points")
    if pts is None:
        pts = rec.get("points")
    c = np.asarray(pts, np.float64) * scale
    c -= c.min(axis=0)
    return int((c < full_scale).all(axis=1).sum())


def check_split(
    doc: Doctor,
    scenario: str,
    preprocess_dir: str,
    split: str,
    data_dir: str = "",
    resize: Optional[tuple] = None,
    image_cache_dir: Optional[str] = None,
    num_classes_raw: Optional[int] = None,
    sample: int = 5,
    point_counts: Optional[Dict] = None,
    counts_key: Optional[str] = None,
    scale: Optional[float] = None,
    full_scale: Optional[int] = None,
    camera_coords: bool = False,
):
    path = osp.join(preprocess_dir, split + ".pkl")
    if not osp.exists(path):
        doc.problem(
            f"{path} missing",
            f"run the offline preprocessing (mm2d3d_tpu_torch.data.preprocess) "
            f"to produce {split}.pkl, or fix the split name in the config")
        return
    try:
        with open(path, "rb") as f:
            records = pickle.load(f)
    except Exception as e:
        doc.problem(f"{path} failed to unpickle: {e}")
        return
    if not isinstance(records, list) or not records:
        doc.problem(f"{path}: expected a non-empty list of dicts, got "
                    f"{type(records).__name__} of len "
                    f"{len(records) if hasattr(records, '__len__') else '?'}")
        return
    doc.ok()
    print(f"{split}: {len(records)} scans")

    # full-split point-count distribution: sizes the static n_points /
    # eval_n_points budgets (pad_sample truncates scans over budget; at
    # EVAL that silently drops points from the metric — the reference
    # evaluates every in-bounds point, train.py:319-330)
    recs = [r for r in records if isinstance(r, dict) and "points" in r]
    if scale is not None and full_scale is not None:
        counts = np.array([
            _in_grid_count(r, scale, full_scale, camera_coords) for r in recs
        ])
        kind_note = "in-grid points"
    else:
        counts = np.array([len(r["points"]) for r in recs])
        kind_note = "raw points (no scale/full_scale given)"
    if counts.size:
        p50, p99 = np.percentile(counts, [50, 99]).astype(int)
        print(
            f"{split}: {kind_note}/scan min={counts.min()} p50={p50} "
            f"p99={p99} max={counts.max()}"
        )
        if point_counts is not None:
            point_counts[counts_key or split] = counts

    cache = None
    if image_cache_dir:
        from ..data.image_cache import ImageCache

        try:
            cache = ImageCache(image_cache_dir)
            if resize and tuple(cache.resize) != tuple(resize):
                doc.problem(
                    f"image cache at {image_cache_dir} stores "
                    f"{tuple(cache.resize)} but the config resize is "
                    f"{tuple(resize)}",
                    "rebuild the cache (tools/cache_images) at the config "
                    "resolution")
                cache = None
        except Exception as e:
            doc.problem(f"image cache at {image_cache_dir} unreadable: {e}")
            cache = None

    idxs = np.linspace(0, len(records) - 1, min(sample, len(records)),
                       dtype=int)
    for i in map(int, idxs):
        rec = records[i]
        where = f"{split}.pkl[{i}]"
        if not isinstance(rec, dict):
            doc.problem(f"{where}: record is {type(rec).__name__}, not dict")
            continue
        missing = [k for k in REQUIRED_KEYS[scenario] if k not in rec]
        if missing:
            doc.problem(
                f"{where}: missing keys {missing} (has {sorted(rec)[:12]})",
                "the pkl schema must match the offline preprocessor output "
                "(see mm2d3d_tpu_torch/data/preprocess/)")
            continue
        doc.ok()

        pts = _check_array(doc, where, rec, "points", 2, dtype_kind="f")
        n = None if pts is None else len(pts)
        if pts is not None and pts.shape[1] != 3:
            doc.problem(f"{where}: 'points' shape {pts.shape}, expected (N, 3)")
        _check_array(doc, where, rec, "pts_cam_coord", 2, n, "f")
        labels = _check_array(doc, where, rec, "seg_labels", 1, n, "iu")
        if labels is not None and num_classes_raw is not None:
            if labels.max(initial=0) >= num_classes_raw:
                doc.problem(
                    f"{where}: raw label {labels.max()} out of range "
                    f"(dataset defines {num_classes_raw} raw classes)",
                    "check the label files / preprocessing label mapping")
        pimg = _check_array(doc, where, rec, "points_img", 2, n, "f")
        if pimg is not None and (pimg < 0).any():
            doc.problem(f"{where}: 'points_img' has negative pixel coords",
                        "the preprocessor must FoV-filter points")

        if scenario == "nuscenes":
            calib = rec.get("calib", {})
            K = np.asarray(calib.get("cam_intrinsic", []), dtype=np.float64)
            if K.shape != (3, 3):
                doc.problem(f"{where}: calib.cam_intrinsic shape "
                            f"{K.shape}, expected (3, 3)")
            else:
                doc.ok()
        if scenario == "semantic_kitti":
            K = np.asarray(rec.get("intrinsics", []), dtype=np.float64)
            if K.shape not in ((3, 3), (3, 4)):
                doc.problem(f"{where}: intrinsics shape {K.shape}, expected "
                            "(3, 3) or (3, 4)")
            else:
                doc.ok()

        cam = rec.get("camera_path")
        if cam is not None:
            if cache is not None:
                if cache.get(cam) is None:
                    doc.problem(
                        f"{where}: '{cam}' not in the image cache",
                        "rebuild the cache over ALL splits "
                        "(tools/cache_images)")
                else:
                    doc.ok()
            elif data_dir:
                full = osp.join(data_dir, cam)
                if not osp.exists(full):
                    doc.problem(
                        f"{where}: image {full} missing",
                        "check datasets.*.nuscenes_dir / *_dir points at "
                        "the raw data root")
                else:
                    doc.ok()
                    if resize and pimg is not None:
                        from PIL import Image

                        with Image.open(full) as im:
                            W, H = im.size
                        if W < resize[0] or H < resize[1]:
                            doc.problem(
                                f"{where}: image {W}x{H} smaller than the "
                                f"config resize {resize} (never enlarged)")
                        if pimg is not None and (
                            (pimg[:, 0] >= H).any() or (pimg[:, 1] >= W).any()
                        ):
                            doc.problem(
                                f"{where}: points_img exceeds the {W}x{H} "
                                "image",
                                "points_img must be (row, col) into the RAW "
                                "image; the dataset rescales it")


def check_pselab(doc: Doctor, path: str, preprocess_dir: str, split: str):
    if not osp.exists(path):
        doc.problem(f"pseudo-label file {path} missing",
                    "generate it with tools/generate_pseudo_labels.py")
        return
    try:
        records = list(np.load(path, allow_pickle=True))
    except Exception as e:
        doc.problem(f"{path} failed to load: {e}")
        return
    if not records:
        doc.problem(f"{path}: empty")
        return
    missing = [k for k in PSELAB_KEYS if k not in records[0]]
    if missing:
        doc.problem(f"{path}: records miss keys {missing}",
                    "regenerate with tools/generate_pseudo_labels.py "
                    "(schema: probs_/pseudo_label_ x 2d/3d/ensemble)")
        return
    doc.ok()
    pkl = osp.join(preprocess_dir, split + ".pkl")
    if osp.exists(pkl):
        with open(pkl, "rb") as f:
            scans = pickle.load(f)
        if len(scans) != len(records):
            doc.problem(
                f"{path}: {len(records)} records vs {len(scans)} scans in "
                f"{split}.pkl",
                "pseudo labels must be generated from the SAME split")
        else:
            doc.ok()
            for i in (0, len(scans) - 1):
                if len(records[i]["pseudo_label_2d"]) != len(
                    scans[i]["seg_labels"]
                ):
                    doc.problem(
                        f"{path}[{i}]: {len(records[i]['pseudo_label_2d'])} "
                        f"pseudo labels vs "
                        f"{len(scans[i]['seg_labels'])} points")


_SCENARIO_DATASETS = {
    # datamodule name -> (source dataset kind, target dataset kind)
    "nuscenes": ("nuscenes", "nuscenes"),
    "a2d2_semantic_kitti": ("a2d2", "semantic_kitti"),
    "vkitti_semantic_kitti": ("virtual_kitti", "semantic_kitti"),
}


def _raw_classes(kind: str) -> Optional[int]:
    if kind == "nuscenes":
        from ..data.nuscenes import NuScenesLidarSeg

        return len(NuScenesLidarSeg.class_names)
    return None  # kitti-family labels are id-keyed, not dense


def check_point_budgets(
    doc: Doctor,
    cfg: Dict,
    train_counts: Dict,
    eval_counts: Dict,
):
    """Compare the configured static point budgets against the actual
    per-split point-count distributions and recommend both.

    - train.n_points should cover the TRAIN splits' p99 (the tail over it
      is truncated — a monitored speed/quality trade-off);
    - train.eval_n_points must cover the target VAL/TEST splits' MAX: the
      reference evaluates every in-bounds point, so a too-small eval
      budget is flagged as a problem, not a preference.

    Counts are in-grid per-scan counts (see _in_grid_count) — the quantity
    the runtime budget applies to, and a tight upper bound on loaded
    points (image-FoV crops can only reduce it).
    """
    tr = cfg.get("train", {})
    n_points = int(tr.get("n_points", 8192))
    eval_np = tr.get("eval_n_points") or n_points

    def rec(x):  # round a budget up to the next multiple of 1024
        return int(-(-int(x) // 1024) * 1024)

    if train_counts:
        p99 = int(np.percentile(np.concatenate(list(train_counts.values())), 99))
        print(f"recommended train.n_points >= {rec(p99)} (train p99 {p99}; "
              f"configured {n_points})")
        if p99 > n_points:
            print(
                f"NOTE: train.n_points={n_points} truncates >1% of training "
                f"scans (p99 {p99}) — monitored as train/points_dropped; "
                f"raise it if the truncation hurts"
            )
        doc.ok()
    if eval_counts:
        mx = int(max(c.max() for c in eval_counts.values()))
        print(f"recommended train.eval_n_points >= {rec(mx)} (eval max {mx}; "
              f"configured {eval_np})")
        if mx > eval_np:
            doc.problem(
                f"eval point budget {eval_np} < largest eval scan ({mx} "
                "points): evaluation would truncate in-bounds points and "
                "the reported IoU would miss them",
                f"set train.eval_n_points: {rec(mx)} (evaluation-only — "
                "training keeps its own n_points budget)")
        else:
            doc.ok()


def run_from_config(cfg: Dict, sample: int = 5) -> int:
    doc = Doctor()
    ds = cfg["dataset"]
    kinds = _SCENARIO_DATASETS[ds["name"]]
    specific = ds.get("specific") or {}
    resize = specific.get("resize")
    train_counts, eval_counts = {}, {}
    for side, kind in zip(("source", "target"), kinds):
        side_cfg = ds[side]
        pre = side_cfg["preprocess_dir"]
        data_dir = (side_cfg.get("nuscenes_dir")
                    or side_cfg.get("semantic_kitti_dir")
                    or side_cfg.get("virtual_kitti_dir") or pre)
        print(f"--- {side} ({kind}) @ {pre}")
        if not osp.isdir(pre):
            doc.problem(f"{side}: preprocess_dir {pre} does not exist",
                        f"set dataset.{side}.preprocess_dir")
            continue
        any_split = False
        for key in ("TRAIN", "VAL", "TEST"):
            for split in side_cfg.get(key) or []:
                any_split = True
                # the registry evaluates on the TARGET val/test loaders
                # (data/registry.py) — those splits set the eval budget
                counts = (
                    eval_counts if side == "target" and key != "TRAIN"
                    else train_counts if key == "TRAIN" else {}
                )
                check_split(
                    doc, kind, pre, split, data_dir=data_dir,
                    resize=tuple(resize) if resize else None,
                    image_cache_dir=side_cfg.get("image_cache_dir"),
                    num_classes_raw=_raw_classes(kind), sample=sample,
                    point_counts=counts,
                    # source/target TRAIN splits may share a name
                    # (a2d2/vkitti -> semantic_kitti both use "train")
                    counts_key=f"{side}/{split}",
                    scale=specific.get("scale"),
                    full_scale=specific.get("full_scale"),
                    camera_coords=bool(specific.get("camera_coords")),
                )
        if not any_split:
            doc.problem(f"{side}: no TRAIN/VAL/TEST splits configured")
        if side_cfg.get("pselab_paths"):
            train = (side_cfg.get("TRAIN") or [None])[0]
            check_pselab(doc, side_cfg["pselab_paths"], pre, train)
    check_point_budgets(doc, cfg, train_counts, eval_counts)
    return doc.report()


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--perf" in argv:
        # forward everything else verbatim to autotune (parsing here would
        # let doctor's positional `overrides` swallow autotune's values)
        argv.remove("--perf")
        from .autotune import main as autotune_main

        return autotune_main(argv)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="experiment config (checks every "
                    "configured split of both domains)")
    ap.add_argument("overrides", nargs="*", help="group=name or a.b=c")
    ap.add_argument("--preprocess-dir")
    ap.add_argument("--scenario", choices=sorted(REQUIRED_KEYS),
                    default="nuscenes")
    ap.add_argument("--splits", nargs="*", default=["train_usa"])
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--resize", type=int, nargs=2)
    ap.add_argument("--image-cache-dir")
    ap.add_argument("--pselab")
    ap.add_argument("--sample", type=int, default=5,
                    help="records checked per split")
    ap.add_argument("--perf", action="store_true",
                    help="re-measure the host-dependent performance defaults "
                    "(host topology / prefetch / workers) on THIS machine and "
                    "print the recommended config (tools.autotune; handled "
                    "above, listed here for --help)")
    args = ap.parse_args(argv)

    if args.config:
        from ..utils.config import load_config

        return run_from_config(load_config(args.config, args.overrides),
                               sample=args.sample)

    if not args.preprocess_dir:
        ap.error("--config or --preprocess-dir required")
    doc = Doctor()
    for split in args.splits:
        check_split(
            doc, args.scenario, args.preprocess_dir, split,
            data_dir=args.data_dir or args.preprocess_dir,
            resize=tuple(args.resize) if args.resize else None,
            image_cache_dir=args.image_cache_dir,
            num_classes_raw=_raw_classes(args.scenario), sample=args.sample,
        )
    if args.pselab:
        check_pselab(doc, args.pselab, args.preprocess_dir, args.splits[0])
    return doc.report()


if __name__ == "__main__":
    sys.exit(main())
