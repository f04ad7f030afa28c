"""Offline SemanticKITTI preprocessing -> per-split pickle lists (port of
`mm2d3d_tpu/data/preprocess/semantic_kitti.py`, numpy only).

Reads the standard KITTI odometry layout
(sequences/<seq>/{velodyne,labels,image_2,calib.txt}), projects points into
image_2 with the calib chain (Tr velo->cam0, then P2), keeps in-FoV points,
and emits {points, seg_labels, points_img, lidar_path, camera_path,
intrinsics, pts_cam_coord} records.

Split convention (semantic-kitti.yaml): train = seqs 00-07,09,10;
val = seq 08 (used as target-val); test = seq 08 too in the UDA protocol
(reference uses val/test on the same labeled target split).

Usage:
    python -m mm2d3d_tpu_torch.data.preprocess.semantic_kitti \
        --root data/semantic_kitti --out data/semantic_kitti
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import pickle

import numpy as np

SPLITS = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "test": ["08"],
}


def read_calib(path: str):
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            out[key.strip()] = np.array([float(v) for v in vals.split()])
    p2 = out["P2"].reshape(3, 4)
    tr = np.eye(4)
    tr[:3] = out["Tr"].reshape(3, 4)
    return p2, tr


def project(points: np.ndarray, p2: np.ndarray, tr: np.ndarray, im_shape):
    """Velodyne xyz -> (mask, pts_cam (N,3), pts_img (M,2) row/col)."""
    homo = np.concatenate([points, np.ones((len(points), 1))], 1)
    cam = (tr @ homo.T)[:3]  # cam0 frame
    # P2 includes the cam0->cam2 baseline; apply on homogeneous cam coords
    proj = p2 @ np.concatenate([cam, np.ones((1, cam.shape[1]))], 0)
    depth = proj[2]
    uv = proj[:2] / np.maximum(depth, 1e-9)
    mask = (
        (depth > 0)
        & (uv[0] > 0) & (uv[0] < im_shape[1])
        & (uv[1] > 0) & (uv[1] < im_shape[0])
    )
    pts_img = np.stack([uv[1], uv[0]], 1)[mask]  # (row, col)
    return mask, cam.T, pts_img.astype(np.float32)


def preprocess(split_name: str, root_dir: str, out_dir: str,
               image_shape=(376, 1241)):
    records = []
    for seq in SPLITS[split_name]:
        seq_dir = osp.join(root_dir, "sequences", seq)
        p2, tr = read_calib(osp.join(seq_dir, "calib.txt"))
        intrinsics = p2[:3, :3]
        scans = sorted(glob.glob(osp.join(seq_dir, "velodyne", "*.bin")))
        for scan_path in scans:
            frame = osp.splitext(osp.basename(scan_path))[0]
            pts = np.fromfile(scan_path, dtype=np.float32).reshape(-1, 4)[:, :3]
            label_path = osp.join(seq_dir, "labels", frame + ".label")
            if osp.exists(label_path):
                labels = np.fromfile(label_path, dtype=np.uint32) & 0xFFFF
            else:  # unlabeled test sequences
                labels = None

            mask, cam, pts_img = project(pts, p2, tr, image_shape)
            rec = {
                "points": pts[mask],
                "seg_labels": labels[mask].astype(np.int32) if labels is not None else None,
                "points_img": pts_img,
                "lidar_path": scan_path.replace(root_dir + "/", ""),
                "camera_path": osp.join("sequences", seq, "image_2", frame + ".png"),
                "intrinsics": intrinsics,
                "pts_cam_coord": cam[mask],
            }
            records.append(rec)
        print(f"seq {seq}: {len(scans)} scans")

    save_dir = osp.join(out_dir, "preprocess")
    os.makedirs(save_dir, exist_ok=True)
    path = osp.join(save_dir, f"{split_name}.pkl")
    with open(path, "wb") as f:
        pickle.dump(records, f)
    print(f"wrote {len(records)} records to {path}")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", default="data/semantic_kitti")
    parser.add_argument("--out", default="data/semantic_kitti")
    parser.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    args = parser.parse_args()
    for s in args.splits:
        preprocess(s, args.root, args.out)


if __name__ == "__main__":
    main()
