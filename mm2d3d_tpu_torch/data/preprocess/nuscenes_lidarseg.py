"""Offline nuScenes-lidarseg preprocessing -> per-split pickle lists (port of
`mm2d3d_tpu/data/preprocess/nuscenes_lidarseg.py`, numpy only).

For every sample: chain the five SE(3) transforms (lidar -> ego(t_lidar) ->
global -> ego(t_cam) -> camera), project through the front camera's
intrinsics, keep the points in its field of view, read the lidarseg labels
through the devkit's fine -> coarse class map, and route the sample into
usa/singapore (by the log's location) or day/night (by a keyword of the
scene description) splits, with the validation scenes of `data.splits`
carved out of train.

Record schema (the same as the JAX package's, so pickles serve both):
{points, seg_labels, points_img, lidar_path, camera_path, sample_token,
scene_name, calib, pts_cam_coord}.

Needs the `nuscenes` devkit (`LidarsegClassMapper` in `preprocess`,
`NuScenes` in `main`, imported there only); the quaternion and projection
math is this module's own.

Usage:
    python -m mm2d3d_tpu_torch.data.preprocess.nuscenes_lidarseg \
        --root data/nuscenes --out data/nuscenes/preprocessed_nuscenes_lidarseg
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
from typing import Dict, Optional

import numpy as np

from ..splits import nuscenes_splits

IMAGE_SHAPE = (900, 1600, 3)  # the front camera's frames


def quat_to_rot(q) -> np.ndarray:
    """Quaternion (w, x, y, z), normalised here -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def map_pointcloud_to_image(pc: np.ndarray, im_shape, info: Dict):
    """Project (3, N) lidar points into the front camera.

    Returns (valid mask (N,), points in the camera frame (3, N), the valid
    points' image coordinates (M, 2) as (u, v) float32)."""
    pc = quat_to_rot(info["lidar2ego_rotation"]) @ pc
    pc = pc + np.asarray(info["lidar2ego_translation"])[:, None]
    pc = quat_to_rot(info["ego2global_rotation_lidar"]) @ pc
    pc = pc + np.asarray(info["ego2global_translation_lidar"])[:, None]
    pc = pc - np.asarray(info["ego2global_translation_cam"])[:, None]
    pc = quat_to_rot(info["ego2global_rotation_cam"]).T @ pc
    pc = pc - np.asarray(info["cam2ego_translation"])[:, None]
    pc = quat_to_rot(info["cam2ego_rotation"]).T @ pc

    depths = pc[2, :]
    proj = np.asarray(info["cam_intrinsic"]) @ pc
    proj = (proj[:2] / np.maximum(proj[2:3], 1e-9)).astype(np.float32)
    mask = ((depths > 0) & (proj[0] > 0) & (proj[0] < im_shape[1])
            & (proj[1] > 0) & (proj[1] < im_shape[0]))
    return mask, pc, proj.T[mask][:, :2]


def _split_of(scene_name: str, split_names, tables, subset_name) -> Optional[str]:
    """The first of `split_names` whose table holds the scene; a train scene
    of a UDA subset's validation table goes to val."""
    split = next((name for name in split_names if scene_name in tables[name]), None)
    if (split == "train" and subset_name in ("night", "singapore", "all")
            and scene_name in tables[f"val_{subset_name}"]):
        return "val"
    return split


def _calib(nusc, lidar_token: str, cam_token: str, cam_intrinsic) -> Dict:
    sd_lidar = nusc.get("sample_data", lidar_token)
    cs_lidar = nusc.get("calibrated_sensor", sd_lidar["calibrated_sensor_token"])
    pose_lidar = nusc.get("ego_pose", sd_lidar["ego_pose_token"])
    sd_cam = nusc.get("sample_data", cam_token)
    cs_cam = nusc.get("calibrated_sensor", sd_cam["calibrated_sensor_token"])
    pose_cam = nusc.get("ego_pose", sd_cam["ego_pose_token"])
    return {
        "lidar2ego_translation": cs_lidar["translation"],
        "lidar2ego_rotation": cs_lidar["rotation"],
        "ego2global_translation_lidar": pose_lidar["translation"],
        "ego2global_rotation_lidar": pose_lidar["rotation"],
        "ego2global_translation_cam": pose_cam["translation"],
        "ego2global_rotation_cam": pose_cam["rotation"],
        "cam2ego_translation": cs_cam["translation"],
        "cam2ego_rotation": cs_cam["rotation"],
        "cam_intrinsic": cam_intrinsic,
    }


def preprocess(nusc, split_names, root_dir: str, out_dir: str,
               keyword: Optional[str] = None, keyword_action: Optional[str] = None,
               subset_name: Optional[str] = None, location: Optional[str] = None):
    """Write ``<out_dir>/preprocess/<split>[_<subset_name>].pkl`` for each
    of `split_names`, keeping the scenes whose log location contains
    `location`, or whose description does (`keyword_action="filter"`) or
    does not (`"exclude"`) contain `keyword`."""
    if keyword and location:
        raise ValueError("give a keyword or a location, not both")
    if keyword and keyword_action not in ("filter", "exclude"):
        raise ValueError(f"keyword_action must be filter or exclude, got "
                         f"{keyword_action!r}")

    from nuscenes.eval.lidarseg.utils import LidarsegClassMapper  # devkit

    tables = nuscenes_splits()
    pkl_dict = {name: [] for name in split_names}
    mapper = LidarsegClassMapper(nusc).get_fine_idx_2_coarse_idx()
    fine_to_coarse = np.array([mapper[i] for i in range(len(mapper))])

    for i, sample in enumerate(nusc.sample):
        scene = nusc.get("scene", sample["scene_token"])
        scene_name = scene["name"]
        split = _split_of(scene_name, split_names, tables, subset_name)
        if split is None:
            continue
        if keyword:
            hit = keyword.lower() in scene["description"].lower()
            if hit == (keyword_action == "exclude"):
                continue
        if location and location not in nusc.get("log", scene["log_token"])["location"]:
            continue

        lidar_token = sample["data"]["LIDAR_TOP"]
        cam_token = sample["data"]["CAM_FRONT"]
        lidar_path, _, _ = nusc.get_sample_data(lidar_token)
        cam_path, _, cam_intrinsic = nusc.get_sample_data(cam_token)
        calib = _calib(nusc, lidar_token, cam_token, cam_intrinsic)

        pts = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 5)[:, :3].T
        valid, pts_cam, pts_img = map_pointcloud_to_image(pts, IMAGE_SHAPE, calib)
        pts_img = np.ascontiguousarray(np.fliplr(pts_img))  # (row, col)
        seg_path = osp.join(nusc.dataroot, nusc.get("lidarseg", lidar_token)["filename"])
        seg_labels = fine_to_coarse[np.fromfile(seg_path, dtype=np.uint8)[valid]]

        pkl_dict[split].append({
            "points": pts[:, valid].T,
            "seg_labels": seg_labels.astype(np.uint8),
            "points_img": pts_img,
            "lidar_path": lidar_path.replace(root_dir + "/", ""),
            "camera_path": cam_path.replace(root_dir + "/", ""),
            "sample_token": sample["token"],
            "scene_name": scene_name,
            "calib": calib,
            "pts_cam_coord": pts_cam[:, valid].T,
        })
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{len(nusc.sample)}")

    save_dir = osp.join(out_dir, "preprocess")
    os.makedirs(save_dir, exist_ok=True)
    suffix = f"_{subset_name}" if subset_name else ""
    for name in split_names:
        path = osp.join(save_dir, f"{name}{suffix}.pkl")
        with open(path, "wb") as f:
            pickle.dump(pkl_dict[name], f)
        print(f"wrote {len(pkl_dict[name])} samples to {path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default="data/nuscenes")
    parser.add_argument("--out", default="data/nuscenes/preprocessed_nuscenes_lidarseg")
    parser.add_argument("--version", default="v1.0-trainval")
    args = parser.parse_args(argv)

    from nuscenes.nuscenes import NuScenes  # devkit

    nusc = NuScenes(version=args.version, dataroot=args.root, verbose=True)
    splits = ["train", "val", "test"]
    preprocess(nusc, splits, args.root, args.out, location="boston", subset_name="usa")
    preprocess(nusc, splits, args.root, args.out, location="singapore",
               subset_name="singapore")
    preprocess(nusc, splits, args.root, args.out, keyword="night",
               keyword_action="exclude", subset_name="day")
    preprocess(nusc, splits, args.root, args.out, keyword="night",
               keyword_action="filter", subset_name="night")


if __name__ == "__main__":
    main()
