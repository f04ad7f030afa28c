"""VirtualKITTI, the synthetic source of the sim-to-real scenario (port of
`mm2d3d_tpu/data/virtual_kitti.py`; numpy, with the C++ image ops of
`data.augment`).

Capability parity with ``lib/dataset/virtual_kitti_dataloader.py:12-364``:

- 14 raw classes -> 6 merged (vegetation_terrain/building/road/object/
  truck/car), label id 99 remapped to "Don't care";
- uniform random point downsample without replacement (fixed count or a
  (min, max) range);
- projection on the fly with the fixed `PROJ_MATRIX` after the axis
  permutation (-y, -z, x) -> camera coords;
- a random weather variant of the frame, read from
  ``vkitti_1.3.1_rgb/<scene>/<weather>/<frame>.png``;
- bottom/random crop with the same retry loop as SemanticKITTI.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import augment as A
from .base import ScanListDataset
from .nuscenes import load_image

PROJ_MATRIX = np.array(
    [[725, 0, 620.5], [0, 725, 187], [0, 0, 1]], dtype=np.float32
)

WEATHERS = ("clone", "fog", "morning", "overcast", "rain", "sunset")


class VirtualKITTI(ScanListDataset):
    class_names = [
        "Terrain", "Tree", "Vegetation", "Building", "Road", "GuardRail",
        "TrafficSign", "TrafficLight", "Pole", "Misc", "Truck", "Car", "Van",
        "Don't care",
    ]
    categories = {
        "vegetation_terrain": ["Terrain", "Tree", "Vegetation"],
        "building": ["Building"],
        "road": ["Road"],
        "object": ["TrafficSign", "TrafficLight", "Pole", "Misc"],
        "truck": ["Truck"],
        "car": ["Car"],
    }

    def __init__(
        self,
        split: Sequence[str],
        preprocess_dir: str,
        virtual_kitti_dir: str = "",
        merge_classes: bool = True,
        scale: float = 20,
        full_scale: int = 4096,
        image_normalizer=None,
        noisy_rot: float = 0.0,
        flip_x: float = 0.0,
        rot: float = 0.0,
        transl: bool = False,
        downsample: Tuple[int, ...] = (-1,),
        crop_size: Tuple[int, int] = (),
        bottom_crop: bool = False,
        rand_crop: Tuple[float, ...] = (),
        fliplr: float = 0.0,
        color_jitter: Optional[Tuple[float, float, float]] = None,
        random_weather: Tuple[str, ...] = WEATHERS,
        camera_coords: bool = False,
        use_rgb: bool = True,
        device_image_ops: bool = False,
        output_orig: bool = False,
    ):
        super().__init__(split, preprocess_dir, merge_classes=merge_classes)
        self.virtual_kitti_dir = virtual_kitti_dir
        self.scale = scale
        self.full_scale = full_scale
        self.image_normalizer = image_normalizer
        self.noisy_rot = noisy_rot
        self.flip_x = flip_x
        self.rot = rot
        self.transl = transl
        self.downsample = downsample[0] if len(downsample) == 1 else tuple(downsample)
        self.crop_size = tuple(crop_size)
        if self.crop_size:
            assert bottom_crop != bool(rand_crop)
        else:
            assert not bottom_crop and not rand_crop
        self.bottom_crop = bottom_crop
        self.rand_crop = np.asarray(rand_crop)
        self.fliplr = fliplr
        self.color_jitter = color_jitter
        self.random_weather = random_weather
        self.camera_coords = camera_coords
        self.use_rgb = use_rgb
        if device_image_ops and image_normalizer:
            raise ValueError("device_image_ops does not support image_normalizer")
        self.device_image_ops = device_image_ops
        self.output_orig = output_orig

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        rec = self.data[index]

        points = rec["points"].copy()
        seg_label = rec["seg_labels"].astype(np.int64)

        num_points = self.downsample
        if isinstance(num_points, tuple):
            num_points = rng.randint(num_points[0], num_points[1])
        if num_points > 0:
            assert num_points < len(points)
            choice = rng.choice(len(points), size=num_points, replace=False)
            points = points[choice]
            seg_label = seg_label[choice]

        seg_label[seg_label == 99] = len(self.label_mapping) - 1  # 99 -> "Don't care"
        seg_label = self.label_mapping[seg_label]

        # project into the virtual camera: cam = (-y, -z, x)
        pts_cam = np.array([-1, -1, 1]) * points[:, [1, 2, 0]]
        if self.camera_coords:
            points = pts_cam.copy()
        proj = (PROJ_MATRIX @ pts_cam.T).T
        points_img = np.fliplr(proj[:, :2] / proj[:, 2:3])  # (row, col)

        weather = "clone"
        if self.random_weather:
            weather = self.random_weather[rng.randint(len(self.random_weather))]
        img_path = osp.join(
            self.virtual_kitti_dir, "vkitti_1.3.1_rgb", rec["scene_id"], weather,
            rec["frame_id"] + ".png",
        )
        image = load_image(img_path)

        intrinsics = PROJ_MATRIX.astype(np.float64).copy()
        if self.crop_size:
            image, points_img, keep_idx, (top, left) = A.crop_with_retry(
                image, points_img, rng, self.crop_size, self.bottom_crop, self.rand_crop
            )
            intrinsics[0, 2] -= top
            intrinsics[1, 2] -= left
            points = points[keep_idx]
            pts_cam = pts_cam[keep_idx]
            seg_label = seg_label[keep_idx]

        img_indices = points_img.astype(np.int64)
        h, w = image.shape[0], image.shape[1]
        depth, seg_labels_2d = A.build_depth_and_label_maps(
            img_indices, pts_cam[:, 2], seg_label, (h, w)
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
            "seg_label": seg_label[idxs],
            "seg_labels_2d": seg_labels_2d,
            "intrinsics": intrinsics,
            "min_value": min_value,
            "offset": offset,
            "rot_matrix": rot_matrix,
        }
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
