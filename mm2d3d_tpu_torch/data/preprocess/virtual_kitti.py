"""Offline VirtualKITTI preprocessing -> per-split pickle lists (port of
`mm2d3d_tpu/data/preprocess/virtual_kitti.py`, numpy only).

Capability parity with ``lib/dataset/preprocces_virtual_kitti.py:21-104``:
glob ``vkitti_npy/<scene>/*.npy``, extract xyz (cols 0:3) + label (col 6),
emit {points, seg_labels, lidar_path, scene_id, frame_id} records per split.

Usage:
    python -m mm2d3d_tpu_torch.data.preprocess.virtual_kitti \
        --root data/virtual_kitti --out data/virtual_kitti
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import pickle

import numpy as np

from ..splits import virtual_kitti_splits


def preprocess(split_name: str, root_dir: str, out_dir: str):
    scenes = virtual_kitti_splits()[split_name]
    records = []
    skipped = 0
    for scene in scenes:
        paths = sorted(glob.glob(osp.join(root_dir, "vkitti_npy", scene, "*.npy")))
        if not paths:
            print(f"warning: no frames for scene {scene}")
        for path in paths:
            frame_id = osp.splitext(osp.basename(path))[0]
            assert frame_id.isdigit(), path
            try:
                cloud = np.load(path)
            except Exception as e:  # corrupt frame -> skip (reference behavior)
                print(f"skipping {path}: {e}")
                skipped += 1
                continue
            records.append(
                {
                    "points": cloud[:, :3].astype(np.float32),
                    "seg_labels": cloud[:, 6].astype(np.uint8),
                    "lidar_path": path.replace(root_dir + "/", ""),
                    "scene_id": scene,
                    "frame_id": frame_id,
                }
            )
    print(f"{len(records)} frames, {skipped} skipped")

    save_dir = osp.join(out_dir, "preprocess")
    os.makedirs(save_dir, exist_ok=True)
    save_path = osp.join(save_dir, f"{split_name}.pkl")
    with open(save_path, "wb") as f:
        pickle.dump(records, f)
    print(f"wrote {save_path}")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", default="data/virtual_kitti")
    parser.add_argument("--out", default="data/virtual_kitti")
    parser.add_argument("--split", default="train")
    args = parser.parse_args()
    preprocess(args.split, args.root, args.out)


if __name__ == "__main__":
    main()
