"""nuScenes-lidarseg dataset (USA/Singapore & Day/Night UDA scenarios; port
of `mm2d3d_tpu/data/nuscenes.py`; numpy, with the C++ image ops of
`data.augment`).

Capability parity with ``lib/dataset/nuscenes_dataloader.py:180-369``:
pickled scans -> class merge 16->6 (-100 ignore), lidar-or-camera coords,
image resize 1600x900 -> 400x225 with projected-point + intrinsics rescale,
sparse depth / dense 2D label maps, color jitter, horizontal flip, 3D
augmentation + voxelization, in-bounds filter, per-point RGB features
(``use_rgb``) or ones.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from . import augment as A
from .base import ScanListDataset


def load_image(path: str) -> np.ndarray:
    """Decode an image file to uint8 RGB (Pillow, imported here: a run that
    reads every frame from an `image_cache_dir` never needs it)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


class NuScenesLidarSeg(ScanListDataset):
    class_names = [
        "ignore", "barrier", "bicycle", "bus", "car", "construction_vehicle",
        "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
        "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
        "vegetation",
    ]
    categories = {
        "vehicle": ["bicycle", "bus", "car", "construction_vehicle",
                    "motorcycle", "trailer", "truck"],
        "driveable_surface": ["driveable_surface"],
        "sidewalk": ["sidewalk"],
        "terrain": ["terrain"],
        "manmade": ["manmade"],
        "vegetation": ["vegetation"],
    }

    def __init__(
        self,
        split: Sequence[str],
        preprocess_dir: str,
        nuscenes_dir: str = "",
        pselab_paths: Optional[str] = None,
        merge_classes: bool = True,
        scale: float = 20,
        full_scale: int = 4096,
        resize: Tuple[int, int] = (400, 225),  # (W, H), PIL convention
        image_normalizer=None,
        noisy_rot: float = 0.0,
        flip_x: float = 0.0,
        rot: float = 0.0,
        transl: bool = False,
        fliplr: float = 0.0,
        color_jitter: Optional[Tuple[float, float, float]] = None,
        output_orig: bool = False,
        camera_coords: bool = False,
        use_rgb: bool = True,
        image_cache_dir: Optional[str] = None,
        device_image_ops: bool = False,
    ):
        super().__init__(
            split, preprocess_dir, merge_classes=merge_classes,
            pselab_paths=pselab_paths,
        )
        self.nuscenes_dir = nuscenes_dir
        # Optional decoded-image cache (data.image_cache): replaces the
        # per-sample JPEG decode + resize — the dominant host cost — with
        # one small .npy read.  Built once via tools/cache_images.
        self._image_cache = None
        if image_cache_dir:
            from .image_cache import ImageCache

            self._image_cache = ImageCache(image_cache_dir)
            if resize and tuple(self._image_cache.resize) != tuple(resize):
                raise ValueError(
                    f"image cache resolution {self._image_cache.resize} != "
                    f"dataset resize {tuple(resize)}; rebuild the cache"
                )
        self.scale = scale
        self.full_scale = full_scale
        self.resize = resize
        self.image_normalizer = image_normalizer
        self.noisy_rot = noisy_rot
        self.flip_x = flip_x
        self.rot = rot
        self.transl = transl
        self.fliplr = fliplr
        self.color_jitter = color_jitter
        self.output_orig = output_orig
        self.camera_coords = camera_coords
        self.use_rgb = use_rgb
        # wire format: ship raw uint8 pixels + jitter params; /255, jitter,
        # and the RGB feats gather run on DEVICE
        # (train.batch.prepare_device_batch) — 4x less image traffic
        if device_image_ops and image_normalizer:
            raise ValueError(
                "device_image_ops does not support image_normalizer; "
                "disable one of them"
            )
        self.device_image_ops = device_image_ops

    def __getitem__(self, index: int, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        rec = self.data[index]

        pts_cam = rec["pts_cam_coord"].copy()
        points = pts_cam.copy() if self.camera_coords else rec["points"].copy()
        seg_label = self.map_labels(rec["seg_labels"])
        intrinsics = np.asarray(rec["calib"]["cam_intrinsic"], np.float64).copy()

        points_img = rec["points_img"].copy()
        image = None
        if self._image_cache is not None:
            hit = self._image_cache.get(rec["camera_path"])
            if hit is not None:
                image, in_size = hit  # resized uint8 + original (W, H)
        if image is None:
            image = load_image(osp.join(self.nuscenes_dir, rec["camera_path"]))
            in_size = (image.shape[1], image.shape[0])  # (W, H)
            if self.resize and in_size != tuple(self.resize):
                assert in_size[0] > self.resize[0], "never enlarge images"
                image = A.bilinear_resize(
                    image, (self.resize[1], self.resize[0])
                )

        if self.resize and in_size != tuple(self.resize):
            points_img = A.rescale_points_img(
                points_img, in_size, tuple(self.resize)
            )
            intrinsics[:2] /= in_size[0] / self.resize[0]

        img_indices = points_img.astype(np.int64)
        h, w = image.shape[0], image.shape[1]
        assert (img_indices[:, 0] >= 0).all() and (img_indices[:, 0] < h).all()
        assert (img_indices[:, 1] >= 0).all() and (img_indices[:, 1] < w).all()

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
            noisy_rot=self.noisy_rot,
            flip_x=self.flip_x,
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
        if jitter_params is not None:
            out["jitter_params"] = jitter_params
        self.attach_pseudo_labels(out, index, idxs)
        if self.output_orig:
            out["orig_seg_label"] = seg_label
            out["orig_points_idx"] = idxs
        out["feats"] = A.rgb_feats_stage(
            image, out["img_indices"], self.use_rgb, self.device_image_ops,
            int(idxs.sum()),
        )
        return out
