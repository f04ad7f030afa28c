"""Datamodule assembly (port of `mm2d3d_tpu/data/registry.py`,
`load_datamodule`): a scenario name selects the dataset classes, and four
datasets (source-train, target-train, target-val, target-test) are wrapped
into loaders; the train pair is consumed through `loader.max_size_cycle`.

Scenarios: `nuscenes` (USA/Singapore, Day/Night), `a2d2_semantic_kitti`
and `vkitti_semantic_kitti`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from .a2d2 import A2D2
from .loader import Loader
from .nuscenes import NuScenesLidarSeg
from .semantic_kitti import SemanticKITTI
from .virtual_kitti import VirtualKITTI


@dataclass
class DataModule:
    source_train: Loader
    target_train: Loader
    target_val: Loader
    target_test: Loader
    num_classes: int
    class_names: list


def load_datamodule(
    name: str,
    cfg_source: Dict[str, Any],
    cfg_target: Dict[str, Any],
    batch_size: int = 8,
    n_points: int = 8192,
    test_batch_size: Optional[int] = None,
    num_workers: int = 0,
    augmentations: Optional[Dict] = None,
    specific: Optional[Dict] = None,
    seed: int = 42,
    full_scale: int = 4096,
    eval_n_points: Optional[int] = None,
    num_shards: int = 1,
    shard_id: int = 0,
) -> DataModule:
    """The four datasets and loaders of a UDA scenario, as the JAX
    `load_datamodule` builds them: `augmentations` reach the train datasets
    only, `specific` all four, less the keys each dataset class does not
    take; `eval_n_points` is the val/test loaders' point budget (default
    `n_points`); the val/test loaders pad their tail batch.  `batch_size`
    and `test_batch_size` are per process; with `num_shards` > 1 every
    loader takes its `shard_id` slice of each global batch (`Loader`)."""
    specific = specific or {}
    augmentations = augmentations or {}
    if augmentations.get("image_normalizer"):
        # augmentations reach the train datasets only, so a normalizer here
        # would train on normalized images and evaluate on unnormalized ones
        raise ValueError(
            "image_normalizer belongs under datasets.specific (it must "
            "apply identically to train AND val/test datasets), not under "
            "datasets.augmentations, which only reaches the train datasets")
    common = dict(specific)
    # raw uint8 images and jitter parameters go to the device, which runs
    # /255, the jitter and the RGB feats gather (train.batch
    # .prepare_device_batch); it has no normalizer, so one forces the host
    common.setdefault("device_image_ops", not common.get("image_normalizer"))

    def splits(cfg, key):
        v = cfg.get(key)
        return tuple(v) if v else None

    def kwargs(train, drop=(), eval_drop=()):
        kw = {**common, **(augmentations if train else {})}
        for key in drop + (() if train else eval_drop):
            kw.pop(key, None)
        return kw

    def skitti(cfg, key, train, style, drop):
        """The SemanticKITTI target: crops in training, the full frame at
        eval."""
        return SemanticKITTI(
            split=splits(cfg, key),
            preprocess_dir=cfg["preprocess_dir"],
            semantic_kitti_dir=cfg.get("semantic_kitti_dir", ""),
            pselab_paths=cfg.get("pselab_paths") if train else None,
            output_orig=not train,
            **{**kwargs(train, drop, ("crop_size", "bottom_crop")),
               "merge_classes_style": style},
        )

    if name == "nuscenes":
        def make_src(cfg, key, train):
            return NuScenesLidarSeg(
                split=splits(cfg, key),
                preprocess_dir=cfg["preprocess_dir"],
                nuscenes_dir=cfg.get("nuscenes_dir", ""),
                # the file holds the TRAIN split's labels (the JAX registry
                # hands it to the eval splits too, which then fail its
                # length check)
                pselab_paths=cfg.get("pselab_paths") if train else None,
                image_cache_dir=cfg.get("image_cache_dir"),
                output_orig=not train,
                **kwargs(train, ("merge_classes_style",)),
            )

        make_trg = make_src
    elif name == "a2d2_semantic_kitti":
        style = specific.get("merge_classes_style", "A2D2")

        def make_src(cfg, key, train):
            return A2D2(
                split=splits(cfg, key), preprocess_dir=cfg["preprocess_dir"],
                **kwargs(train, ("merge_classes_style", "crop_size", "bottom_crop")),
            )

        def make_trg(cfg, key, train):
            return skitti(cfg, key, train, style,
                          ("merge_classes", "resize", "rand_crop"))
    elif name == "vkitti_semantic_kitti":
        def make_src(cfg, key, train):
            return VirtualKITTI(
                split=splits(cfg, key), preprocess_dir=cfg["preprocess_dir"],
                virtual_kitti_dir=cfg.get("virtual_kitti_dir", ""),
                output_orig=not train,
                **kwargs(train, ("merge_classes_style",)),
            )

        def make_trg(cfg, key, train):
            return skitti(cfg, key, train, "VirtualKITTI",
                          ("merge_classes", "downsample", "random_weather"))
    else:
        raise ValueError(f"unknown datamodule {name!r}")

    src_train = make_src(cfg_source, "TRAIN", True)
    trg_train = make_trg(cfg_target, "TRAIN", True)
    trg_val = make_trg(cfg_target, "VAL", False)
    trg_test = make_trg(cfg_target, "TEST", False)

    test_bs = test_batch_size or batch_size
    eval_np = eval_n_points or n_points
    shard_kw = dict(num_shards=num_shards, shard_id=shard_id,
                    full_scale=full_scale)
    return DataModule(
        source_train=Loader(src_train, batch_size, n_points, shuffle=True,
                            drop_last=True, seed=seed, num_workers=num_workers,
                            **shard_kw),
        target_train=Loader(trg_train, batch_size, n_points, shuffle=True,
                            drop_last=True, seed=seed + 1,
                            num_workers=num_workers, **shard_kw),
        target_val=Loader(trg_val, test_bs, eval_np, num_workers=num_workers,
                          pad_last=True, **shard_kw),
        target_test=Loader(trg_test, test_bs, eval_np, num_workers=num_workers,
                           pad_last=True, **shard_kw),
        num_classes=src_train.num_classes,
        class_names=list(src_train.merged_class_names),
    )
