"""A2D2 (Audi), the source of the A2D2 -> SemanticKITTI scenario (port of
`mm2d3d_tpu/data/a2d2.py`; numpy, with the C++ image ops of `data.augment`).

Capability parity with ``lib/dataset/a2d2.py:15-408``:

- 55 raw classes (the hex-RGB keyed ``class_list.json``, optional) merged
  to 10 (car, truck, bike, person, road, parking, sidewalk, building,
  nature, other-objects), -100 for the rest;
- the sensor config read from the optional ``cams_lidars.json``; the
  hardcoded front-camera intrinsics (a2d2.py:261-267);
- scan pickles under ``<preprocess_dir>/preprocess``, frames under
  ``<preprocess_dir>``;
- a probabilistic random crop (crop_prob + fractional dims, the retry loop
  of `augment.crop_with_retry`), then always the resize to 480x302 with
  the intrinsics / 4;
- the remaining pipeline matches the shared recipe.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import augment as A
from .base import ScanListDataset
from .nuscenes import load_image

HARDCODED_INTRINSICS = np.array(
    [
        [1687.3369140625, 0.0, 965.43414055823814],
        [0.0, 1783.428466796875, 684.4193604186803],
        [0.0, 0.0, 1.0],
    ]
)


class A2D2(ScanListDataset):
    class_names = [
        "Car 1", "Car 2", "Car 3", "Car 4", "Bicycle 1", "Bicycle 2",
        "Bicycle 3", "Bicycle 4", "Pedestrian 1", "Pedestrian 2",
        "Pedestrian 3", "Truck 1", "Truck 2", "Truck 3", "Small vehicles 1",
        "Small vehicles 2", "Small vehicles 3", "Traffic signal 1",
        "Traffic signal 2", "Traffic signal 3", "Traffic sign 1",
        "Traffic sign 2", "Traffic sign 3", "Utility vehicle 1",
        "Utility vehicle 2", "Sidebars", "Speed bumper", "Curbstone",
        "Solid line", "Irrelevant signs", "Road blocks", "Tractor",
        "Non-drivable street", "Zebra crossing", "Obstacles / trash",
        "Poles", "RD restricted area", "Animals", "Grid structure",
        "Signal corpus", "Drivable cobblestone", "Electronic traffic",
        "Slow drive area", "Nature object", "Parking area", "Sidewalk",
        "Ego car", "Painted driv. instr.", "Traffic guide obj.",
        "Dashed line", "RD normal street", "Sky", "Buildings",
        "Blurred area", "Rain dirt",
    ]
    categories = {
        "car": ["Car 1", "Car 2", "Car 3", "Car 4", "Ego car"],
        "truck": ["Truck 1", "Truck 2", "Truck 3"],
        "bike": ["Bicycle 1", "Bicycle 2", "Bicycle 3", "Bicycle 4",
                 "Small vehicles 1", "Small vehicles 2", "Small vehicles 3"],
        "person": ["Pedestrian 1", "Pedestrian 2", "Pedestrian 3"],
        "road": ["RD normal street", "Zebra crossing", "Solid line",
                 "RD restricted area", "Slow drive area",
                 "Drivable cobblestone", "Dashed line", "Painted driv. instr."],
        "parking": ["Parking area"],
        "sidewalk": ["Sidewalk", "Curbstone"],
        "building": ["Buildings"],
        "nature": ["Nature object"],
        "other-objects": ["Poles", "Traffic signal 1", "Traffic signal 2",
                          "Traffic signal 3", "Traffic sign 1",
                          "Traffic sign 2", "Traffic sign 3", "Sidebars",
                          "Speed bumper", "Irrelevant signs", "Road blocks",
                          "Obstacles / trash", "Animals", "Signal corpus",
                          "Electronic traffic", "Traffic guide obj.",
                          "Grid structure"],
    }

    def __init__(
        self,
        split: Sequence[str],
        preprocess_dir: str,
        merge_classes: bool = True,
        scale: float = 20,
        full_scale: int = 4096,
        resize: Tuple[int, int] = (480, 302),
        image_normalizer=None,
        noisy_rot: float = 0.0,
        flip_x: float = 0.0,
        rot: float = 0.0,
        transl: bool = False,
        rand_crop: Tuple[float, ...] = (),
        fliplr: float = 0.0,
        color_jitter: Optional[Tuple[float, float, float]] = None,
        camera_coords: bool = False,
        use_rgb: bool = True,
        device_image_ops: bool = False,
        output_orig: bool = False,
    ):
        # the pickles live in <preprocess_dir>/preprocess, the JSONs and
        # frames under <preprocess_dir>
        self.root_dir = preprocess_dir
        self.sensor_config = self._load_json(osp.join(preprocess_dir, "cams_lidars.json"))
        super().__init__(split, osp.join(preprocess_dir, "preprocess"),
                         merge_classes=merge_classes)
        class_list = self._load_json(osp.join(preprocess_dir, "class_list.json"))
        if class_list is not None:
            self.rgb_to_class = {
                tuple(int(k.lstrip("#")[i : i + 2], 16) for i in (0, 2, 4)): v
                for k, v in class_list.items()
            }
            assert self.class_names == list(self.rgb_to_class.values())

        self.scale = scale
        self.full_scale = full_scale
        self.resize = tuple(resize)
        self.image_normalizer = image_normalizer
        self.noisy_rot = noisy_rot
        self.flip_x = flip_x
        self.rot = rot
        self.transl = transl
        if rand_crop:
            self.crop_prob = rand_crop[0]
            self.crop_dims = np.asarray(rand_crop[1:])
        else:
            self.crop_prob = 0.0
            self.crop_dims = np.zeros(4)
        self.fliplr = fliplr
        self.color_jitter = color_jitter
        self.camera_coords = camera_coords
        self.use_rgb = use_rgb
        if device_image_ops and image_normalizer:
            raise ValueError("device_image_ops does not support image_normalizer")
        self.device_image_ops = device_image_ops
        self.output_orig = output_orig

    @staticmethod
    def _load_json(path):
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        rec = self.data[index]

        pts_cam = rec["pts_cam_coord"].copy()
        points = pts_cam.copy() if self.camera_coords else rec["points"].copy()
        seg_label = self.map_labels(rec["seg_labels"])
        intrinsics = HARDCODED_INTRINSICS.copy()

        points_img = rec["points_img"].copy()
        image = load_image(osp.join(self.root_dir, rec["camera_path"]))

        if rng.rand() < self.crop_prob:
            image, points_img, keep_idx, _ = A.crop_with_retry(
                image, points_img, rng, crop_size=(),
                bottom_crop=False, rand_crop=self.crop_dims,
            )
            points = points[keep_idx]
            pts_cam = pts_cam[keep_idx]
            seg_label = seg_label[keep_idx]

        in_size = (image.shape[1], image.shape[0])
        if self.resize and in_size != self.resize:
            assert in_size[0] > self.resize[0]
            points_img = A.rescale_points_img(points_img, in_size, self.resize)
            image = A.bilinear_resize(image, (self.resize[1], self.resize[0]))
            intrinsics[:2] /= 4

        img_indices = points_img.astype(np.int64)
        h, w = image.shape[0], image.shape[1]
        assert (img_indices >= 0).all()
        assert (img_indices[:, 0] < h).all() and (img_indices[:, 1] < w).all()
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
