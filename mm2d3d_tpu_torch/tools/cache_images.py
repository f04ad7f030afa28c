"""Build the decoded-image cache for a scenario's datasets (port of
`mm2d3d_tpu/tools/cache_images.py`; the format `data.image_cache` reads,
which the JAX package reads too).

One-time preprocessing that moves the per-sample JPEG decode + bilinear
resize (the dominant host input cost) out of the training loop: every
camera frame referenced by the given split pkls is decoded once, resized
to the training resolution, and stored as uint8 ``.npy`` (`data.image_cache`).  Point the dataset at it via
``datasets.source/target.image_cache_dir`` (nuScenes scenarios).

Usage:
    python -m mm2d3d_tpu_torch.tools.cache_images \
        --preprocess-dir /data/nuscenes_preprocess \
        --image-dir /data/nuscenes \
        --splits train_usa train_singapore val_singapore test_singapore \
        --out /data/nuscenes_cache_400x225 [--resize 400 225]
"""

from __future__ import annotations

import argparse
import os.path as osp
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preprocess-dir", required=True,
                    help="directory with <split>.pkl scan lists")
    ap.add_argument("--image-dir", required=True,
                    help="root the records' camera_path is relative to")
    ap.add_argument("--splits", nargs="+", required=True)
    ap.add_argument("--out", required=True, help="cache directory")
    ap.add_argument("--resize", type=int, nargs=2, default=(400, 225),
                    metavar=("W", "H"),
                    help="training resolution (must match the dataset config)")
    args = ap.parse_args(argv)

    from ..data.image_cache import build_image_cache

    paths = []
    for split in args.splits:
        with open(osp.join(args.preprocess_dir, split + ".pkl"), "rb") as f:
            records = pickle.load(f)
        paths.extend(rec["camera_path"] for rec in records)

    n = build_image_cache(paths, args.image_dir, args.out, tuple(args.resize))
    print(f"cached {n} new frames ({len(set(paths))} referenced) -> {args.out}")


if __name__ == "__main__":
    main()
