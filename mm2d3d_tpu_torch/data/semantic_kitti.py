"""SemanticKITTI dataset, the UDA target of the A2D2 and VirtualKITTI
scenarios (port of `mm2d3d_tpu/data/semantic_kitti.py`; numpy, with the C++
image ops of `data.augment`).

Capability parity with ``lib/dataset/semantic_kitti.py:13-492``:

- raw semantic-kitti label ids -> three merge styles ("A2D2" 10 classes,
  "VirtualKITTI" 6, "nuScenes" 6), -100 for unmapped ids;
- 2D crops: bottom crop (random horizontal position) or random crop
  (fractional bounds + resize back to crop_size), retried up to 10x until
  more than 100 projected points survive; points outside the crop are
  dropped and the intrinsics shifted exactly as the JAX package shifts
  them (``intrinsics[0, 2] -= top``, ``intrinsics[1, 2] -= left``);
- the rest of the pipeline (depth/label maps, jitter, flip, 3D augment,
  in-bounds filter, RGB feats) matches the shared recipe.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import augment as A
from .base import IGNORE, ScanListDataset
from .nuscenes import load_image


class SemanticKITTI(ScanListDataset):
    id_to_class_name = {
        0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
        15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
        30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
        44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
        51: "fence", 52: "other-structure", 60: "lane-marking",
        70: "vegetation", 71: "trunk", 72: "terrain", 80: "pole",
        81: "traffic-sign", 99: "other-object", 252: "moving-car",
        253: "moving-bicyclist", 254: "moving-person",
        255: "moving-motorcyclist", 256: "moving-on-rails", 257: "moving-bus",
        258: "moving-truck", 259: "moving-other-vehicle",
    }
    class_name_to_id = {v: k for k, v in id_to_class_name.items()}

    merge_styles = {
        "A2D2": {
            "car": ["car", "moving-car"],
            "truck": ["truck", "moving-truck"],
            "bike": ["bicycle", "motorcycle", "bicyclist", "motorcyclist",
                     "moving-bicyclist", "moving-motorcyclist"],
            "person": ["person", "moving-person"],
            "road": ["road", "lane-marking"],
            "parking": ["parking"],
            "sidewalk": ["sidewalk"],
            "building": ["building"],
            "nature": ["vegetation", "trunk", "terrain"],
            "other-objects": ["fence", "pole", "traffic-sign", "other-object"],
        },
        "VirtualKITTI": {
            "vegetation_terrain": ["vegetation", "trunk", "terrain"],
            "building": ["building"],
            "road": ["road", "lane-marking"],
            "object": ["fence", "pole", "traffic-sign", "other-object"],
            "truck": ["truck", "moving-truck"],
            "car": ["car", "moving-car"],
        },
        "nuScenes": {
            "vehicle": ["truck", "moving-truck", "car", "moving-car", "bicycle",
                        "motorcycle", "bicyclist", "motorcyclist",
                        "moving-bicyclist", "moving-motorcyclist"],
            "driveable_surface": ["road", "lane-marking", "parking"],
            "sidewalk": ["sidewalk"],
            "terrain": ["terrain"],
            "manmade": ["building", "fence", "pole", "traffic-sign", "other-object"],
            "vegetation": ["vegetation", "trunk"],
        },
    }

    def __init__(
        self,
        split: Sequence[str],
        preprocess_dir: str,
        semantic_kitti_dir: str = "",
        pselab_paths: Optional[str] = None,
        merge_classes_style: str = "A2D2",
        scale: float = 20,
        full_scale: int = 4096,
        image_normalizer=None,
        noisy_rot: float = 0.0,
        flip_x: float = 0.0,
        rot: float = 0.0,
        transl: bool = False,
        crop_size: Tuple[int, int] = (),  # (W, H)
        bottom_crop: bool = False,
        rand_crop: Tuple[float, ...] = (),
        fliplr: float = 0.0,
        color_jitter: Optional[Tuple[float, float, float]] = None,
        output_orig: bool = False,
        camera_coords: bool = False,
        use_rgb: bool = True,
        device_image_ops: bool = False,
    ):
        self.merge_style = merge_classes_style
        super().__init__(split, preprocess_dir, merge_classes=False,
                         pselab_paths=pselab_paths)
        # the mapping is indexed by the raw (sparse) label id
        highest_id = max(self.id_to_class_name.keys())
        self.label_mapping = np.full(highest_id + 2, IGNORE, np.int64)
        for cat_idx, cat_list in enumerate(self.merge_styles[merge_classes_style].values()):
            for name in cat_list:
                self.label_mapping[self.class_name_to_id[name]] = cat_idx
        self.merged_class_names = list(self.merge_styles[merge_classes_style].keys())

        self.semantic_kitti_dir = semantic_kitti_dir
        self.scale = scale
        self.full_scale = full_scale
        self.image_normalizer = image_normalizer
        self.noisy_rot = noisy_rot
        self.flip_x = flip_x
        self.rot = rot
        self.transl = transl
        self.crop_size = tuple(crop_size)
        if self.crop_size:
            assert bottom_crop != bool(rand_crop), (
                "exactly one crop method must be active when crop_size is set"
            )
        else:
            assert not bottom_crop and not rand_crop
        self.bottom_crop = bottom_crop
        self.rand_crop = np.asarray(rand_crop)
        assert len(self.rand_crop) in (0, 4)
        self.fliplr = fliplr
        self.color_jitter = color_jitter
        self.output_orig = output_orig
        self.camera_coords = camera_coords
        self.use_rgb = use_rgb
        if device_image_ops and image_normalizer:
            raise ValueError("device_image_ops does not support image_normalizer")
        self.device_image_ops = device_image_ops

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        rec = self.data[index]

        pts_cam = rec["pts_cam_coord"].copy()
        points = pts_cam.copy() if self.camera_coords else rec["points"].copy()
        seg_label = rec["seg_labels"]
        if seg_label is not None:
            seg_label = self.label_mapping[seg_label.astype(np.int64)]
        intrinsics = np.asarray(rec["intrinsics"], np.float64).copy()

        points_img = rec["points_img"].copy()
        image = load_image(osp.join(self.semantic_kitti_dir, rec["camera_path"]))

        keep_idx = np.ones(len(points), bool)
        if self.crop_size:
            image, points_img, keep_idx, (top, left) = A.crop_with_retry(
                image, points_img, rng, self.crop_size, self.bottom_crop, self.rand_crop
            )
            intrinsics[0, 2] -= top
            intrinsics[1, 2] -= left
            points = points[keep_idx]
            pts_cam = pts_cam[keep_idx]
            if seg_label is not None:
                seg_label = seg_label[keep_idx]

        img_indices = points_img.astype(np.int64)
        h, w = image.shape[0], image.shape[1]
        labels_for_map = (
            seg_label if seg_label is not None else np.full(len(img_indices), IGNORE)
        )
        depth, seg_labels_2d = A.build_depth_and_label_maps(
            img_indices, pts_cam[:, 2], labels_for_map, (h, w)
        )

        image, jitter_params = A.image_jitter_stage(
            image, rng, self.color_jitter, self.device_image_ops
        )
        if rng.rand() < self.fliplr:
            image, depth, img_indices, seg_labels_2d, intrinsics = A.fliplr_sample(
                image, depth, img_indices, seg_labels_2d, intrinsics
            )
        if self.image_normalizer:
            mean, std = self.image_normalizer
            image = A.normalize_image(image, mean, std)

        coords, min_value, offset, rot_matrix = A.augment_and_scale_3d(
            points, self.scale, self.full_scale, rng,
            noisy_rot=self.noisy_rot, flip_x=self.flip_x,
            rot_z=0.0 if self.camera_coords else self.rot,
            rot_y=self.rot if self.camera_coords else 0.0,
            transl=self.transl,
        )
        coords = coords.astype(np.int64)
        idxs = (coords.min(1) >= 0) & (coords.max(1) < self.full_scale)

        out: Dict[str, Any] = {
            "img": image,
            "depth": depth[..., None],
            "img_indices": img_indices[idxs],
            "coords": coords[idxs],
            "points": points[idxs],
            "seg_label": (
                seg_label[idxs] if seg_label is not None
                else np.full(int(idxs.sum()), IGNORE, np.int64)
            ),
            "seg_labels_2d": seg_labels_2d,
            "intrinsics": intrinsics,
            "min_value": min_value,
            "offset": offset,
            "rot_matrix": rot_matrix,
        }
        if self.pselab_data is not None:
            ps = self.pselab_data[index]
            out["pseudo_label_2d"] = ps["pseudo_label_2d"][keep_idx][idxs]
            out["pseudo_label_3d"] = (
                None if ps["pseudo_label_3d"] is None
                else ps["pseudo_label_3d"][keep_idx][idxs]
            )
            out["pseudo_label_ensemble"] = ps["pseudo_label_ensemble"][keep_idx][idxs]
        if self.output_orig:
            out["orig_seg_label"] = seg_label
            out["orig_points_idx"] = idxs
        if jitter_params is not None:
            out["jitter_params"] = jitter_params
        out["feats"] = A.rgb_feats_stage(
            image, out["img_indices"], self.use_rgb, self.device_image_ops,
            int(idxs.sum()),
        )
        return out
