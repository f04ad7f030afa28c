"""Experiment CLI (port of `mm2d3d_tpu/run.py`).

Usage:
    python -m mm2d3d_tpu_torch.run --config configs/config.yaml [overrides...]
    python -m mm2d3d_tpu_torch.run --config configs/config.yaml run=test
    python -m mm2d3d_tpu_torch.run --config configs/config.yaml --device cpu \
        run.fast_dev_run=true

Seeding, the logger, the datamodule, one optimizer with its schedule per
branch, the task, checkpoint/resume, fit then test, on the CUDA device
unless `--device` names another (`--device cpu` runs on the CPU).
Qualitative figures go to ``<out_dir>/figures`` every
`train.params.train_log_images_step` steps (2000 unless set; null turns
them off) and `val_log_images_step` eval batches, in the colours of
`train.params.class_palette` or, where a config names none, the
dataset's palette.

Data parallelism is one process per device, started by a launcher:

    torchrun --nproc_per_node=N -m mm2d3d_tpu_torch.run --config ... [overrides]

Every rank trains on its shard of each global batch (`run.batch_size` and
`run.test_batch_size` are global and must divide by the world size) and
averages gradients, running statistics and logs with the others
(`parallel.mesh`).  The JAX CLI runs one process over all local devices;
this one does not start its own workers, so with several visible GPUs and
no launcher it raises.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict

import numpy as np
import torch

def build_task(cfg: Dict, num_classes: int, device="cuda", group=None):
    from .models.registry import get_entry, load_model
    from .train.losses import LossComposer
    from .train.step import MM2D3DTask

    m3 = cfg["models"]["net3d"]["backbone_3d"]
    params = cfg["train"]["params"]
    composer = LossComposer(cfg.get("losses", ["cross_entropy"]))
    # the step predicts segmentation only; losses for any other target
    # would be silently ignored
    unknown = composer.targets() - {"segmentation"}
    if unknown:
        raise ValueError(
            f"losses configured for unsupported target(s) {sorted(unknown)}; "
            "the cross-modal UDA step only produces 'segmentation' predictions")
    cw = composer.class_weights("segmentation")
    if isinstance(cw, str):
        raise ValueError(
            f"class weight {cw!r} is unresolved; 'compute' is resolved from "
            "the source train split by the CLI (resolve_auto_params) "
            "— pass explicit per-class weights when building a task directly")
    if cw is not None and len(cw) != num_classes:
        raise ValueError(
            f"losses: {len(cw)} cross-entropy class weights but the dataset "
            f"has num_classes={num_classes}")
    frozen = cfg["models"]["net2d"].get("frozen_batch_norm", False)
    residual = m3.get("residual_blocks", False)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["train"].get("compute_dtype", "bfloat16")]
    name2d = cfg["models"]["net2d"].get("name", "net2d")
    name3d = cfg["models"]["net3d"].get("name", "net3d")
    model2d = load_model(name2d, num_classes=num_classes, compute_dtype=dtype,
                         frozen_batch_norm=frozen,
                         **cfg["models"]["net2d"].get("args", {}))
    # only the shape keys the config gives: the named network takes those
    # its constructor declares, and its own defaults stand for the rest
    shape3d = {k: m3[k] for k in ("m", "block_reps", "num_planes") if k in m3}
    model3d = load_model(
        name3d, num_classes=num_classes, in_channels=m3.get("in_channels", 3),
        residual_blocks=residual, compute_dtype=dtype, **shape3d,
        **cfg["models"]["net3d"].get("args", {}))
    levels = getattr(model3d, "num_levels", None)
    if levels is not None and m3.get("num_planes", levels) != levels:
        raise ValueError(
            f"models.net3d.backbone_3d.num_planes is {m3['num_planes']}, but "
            f"{name3d!r} runs on {levels} levels")
    task = MM2D3DTask(
        num_classes=num_classes,
        class_weights=cw,
        loss_composer=composer,
        lambda_xm_src=params.get("lambda_xm_src", 1.0),
        lambda_xm_trg=params.get("lambda_xm_trg", 0.1),
        full_scale=m3["full_scale"],
        residual_blocks=residual,
        in_channels_3d=m3.get("in_channels", 3),
        frozen_batch_norm=frozen,
        compute_dtype=dtype,
        optimizer_2d=cfg["models"]["net2d"]["optimizer"],
        optimizer_3d=cfg["models"]["net3d"]["optimizer"],
        model2d=model2d,
        model3d=model3d,
        device=device,
        **shape3d,
        slot_profile=cfg["train"].get("slot_profile", "default"),
        group=group,
    )
    # the models' plugin metadata for the run record
    task.model_info = {}
    for branch, name in (("net2d", name2d), ("net3d", name3d)):
        entry = get_entry(name)
        sig = entry.get("signature")
        task.model_info[branch] = {
            "name": name,
            "dependencies": list(entry.get("dependencies") or []),
            "signature": None if sig is None else [
                {k: list(v.shape) for k, v in part.items()} for part in sig],
        }
    return task


def resolve_auto_params(cfg: Dict, dm) -> None:
    """Resolve data-dependent config placeholders in place:
    ``losses[*].args.weight: compute`` -> log-smoothed class weights from
    the source train split; ``optimizer.lr_scheduler.total_steps: auto`` ->
    max_epochs x steps per epoch (max_size_cycle pairing)."""
    from .utils.logging import rank_zero

    for entry in cfg.get("losses", []):
        if isinstance(entry, dict) and entry.get("args", {}).get("weight") == "compute":
            from .data.base import compute_class_weights

            w = compute_class_weights(dm.source_train.dataset)
            entry["args"]["weight"] = [float(x) for x in w]
            if rank_zero():
                print(f"computed class weights: {entry['args']['weight']}")
    steps_per_epoch = max(len(dm.source_train), len(dm.target_train))
    for branch in cfg["models"].values():
        sched = (branch.get("optimizer") or {}).get("lr_scheduler") or {}
        if sched.get("total_steps") == "auto":
            sched["total_steps"] = cfg["run"]["max_epochs"] * steps_per_epoch
            if rank_zero():
                print(f"total_steps=auto -> {sched['total_steps']}")


def resolve_num_workers(value) -> int:
    """``train.num_workers: auto`` -> cpu_count() // 4 (0 below 4 CPUs);
    integers pass through."""
    if value == "auto":
        n = os.cpu_count() or 1
        return n // 4 if n >= 4 else 0
    return int(value)


def build_datamodule(cfg: Dict, num_shards: int = 1, shard_id: int = 0):
    """The config's datamodule; with `num_shards` > 1, this process's shard:
    the global `run.batch_size` and `run.test_batch_size` divided by the
    shard count."""
    from .data.registry import load_datamodule

    ds = cfg["dataset"]
    run = cfg["run"]
    test_bs = run.get("test_batch_size")
    return load_datamodule(
        ds["name"],
        cfg_source=ds["source"],
        cfg_target=ds["target"],
        batch_size=run["batch_size"] // num_shards,
        test_batch_size=None if test_bs is None else test_bs // num_shards,
        n_points=cfg["train"].get("n_points", 8192),
        eval_n_points=cfg["train"].get("eval_n_points"),
        num_workers=resolve_num_workers(cfg["train"].get("num_workers", "auto")),
        augmentations=ds.get("augmentations"),
        specific=ds.get("specific"),
        seed=cfg["train"].get("seed", 42),
        full_scale=cfg["models"]["net3d"]["backbone_3d"].get("full_scale", 4096),
        num_shards=num_shards,
        shard_id=shard_id,
    )


# the palette of each datamodule's target classes (`utils.visualize.PALETTES`)
DATASET_PALETTES = {"nuscenes": "nuscenes", "a2d2_semantic_kitti": "a2d2",
                    "vkitti_semantic_kitti": "virtual_kitti"}


def class_palette(cfg: Dict):
    """The figures' colours: `train.params.class_palette` (a palette name or
    per-class RGB rows), else the dataset's palette.  The JAX CLI draws no
    figure where a config names no palette (configs/a2d2.yaml)."""
    palette = cfg["train"]["params"].get("class_palette")
    return DATASET_PALETTES.get(cfg["dataset"]["name"]) if palette is None else palette


def data_parallel_off(run_cfg: Dict) -> bool:
    # YAML reads an unquoted `off` as false
    return run_cfg.get("data_parallel", "auto") in ("off", False)


def check_data_parallel(run_cfg: Dict, world: int) -> None:
    """The JAX CLI's refusals for a run over `world` processes."""
    bs, tbs = run_cfg["batch_size"], run_cfg.get("test_batch_size")
    if data_parallel_off(run_cfg) and world > 1:
        # without the averages each process would train a model of its own
        # on its shard while writing to the same out_dir
        raise ValueError(
            "multi-host run requires the data-parallel mesh: "
            "run.data_parallel must not be 'off' and the global batch "
            f"({bs}) must be divisible by the device count ({world})")
    if bs % world:
        raise ValueError(f"global batch {bs} not divisible by {world} processes")
    if tbs is not None and tbs % world:
        raise ValueError(
            f"run.test_batch_size {tbs} not divisible by {world} processes (the "
            "floor-divided shards would silently shrink the global eval batch "
            "and drop extra tail scans)")


def parse(argv=None):
    """The command line -> (its arguments, the config with its overrides)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("overrides", nargs="*", help="group=name or a.b=c")
    args = parser.parse_args(argv)
    return args, parse_config(args.config, args.overrides)


def parse_config(path: str, overrides=()) -> Dict:
    """The config at `path` with its overrides and the dataset's
    `train_overrides` merged into `train`."""
    from .utils.config import _deep_merge, load_config

    cfg = load_config(path, list(overrides))
    # dataset-specific train overrides (e.g. lambda_xm for vkitti)
    if "train_overrides" in cfg:
        cfg["train"] = _deep_merge(cfg["train"], cfg.pop("train_overrides"))
    return cfg


def main(argv=None):
    """Run the config -> (the `Trainer` after fit and test, the test
    results)."""
    from .parallel import mesh
    from .train.step import resolve_device

    args, cfg = parse(argv)
    run_cfg = cfg["run"]
    world = int(os.environ.get("WORLD_SIZE", "1"))
    group = None
    if (world > 1 or run_cfg.get("distributed")
            or os.environ.get("MM2D3D_DISTRIBUTED") == "1"):
        check_data_parallel(run_cfg, world)
        device = mesh.init_process_group(args.device)
        group = torch.distributed.group.WORLD
        if torch.distributed.get_rank() == 0:
            print(f"data parallel over {world} processes "
                  f"({torch.distributed.get_backend()}, {device})", flush=True)
    else:
        device = resolve_device(args.device)
        n_gpu = torch.cuda.device_count() if device.type == "cuda" else 0
        if n_gpu > 1 and not mesh.launched() and not data_parallel_off(run_cfg):
            raise RuntimeError(
                f"{n_gpu} CUDA devices are visible: train on all of them with one "
                f"process each, `torchrun --nproc_per_node={n_gpu} -m "
                "mm2d3d_tpu_torch.run --config ...` (this CLI starts no workers of "
                "its own), or on one with run.data_parallel=off or "
                "CUDA_VISIBLE_DEVICES")

    seed = cfg["train"].get("seed", 42)
    np.random.seed(seed)
    torch.manual_seed(seed)
    out_dir = cfg["train"].get("out_dir", "runs/default")
    os.makedirs(out_dir, exist_ok=True)

    from .utils.logging import create_logger, snapshot_code

    logger = create_logger(cfg.get("logging"), out_dir=out_dir,
                           resume=cfg["run"].get("resume", False))
    logger.log_hyperparams(
        {"config": args.config, "overrides": args.overrides, **cfg["train"]["params"]})
    snapshot_code(out_dir, osp.dirname(osp.dirname(osp.abspath(__file__))))

    shards = (world, torch.distributed.get_rank()) if group is not None else (1, 0)
    dm = build_datamodule(cfg, *shards)
    resolve_auto_params(cfg, dm)
    task = build_task(cfg, dm.num_classes, device=device, group=group)
    logger.log_hyperparams({"models": task.model_info})
    params = cfg["train"]["params"]

    from .train.trainer import Trainer

    trainer = Trainer(
        task,
        source_loader=dm.source_train,
        target_loader=dm.target_train,
        val_loader=dm.target_val,
        test_loader=dm.target_test,
        ckpt_dir=osp.join(out_dir, "ckpts"),
        max_epochs=run_cfg["max_epochs"],
        check_val_every_n_epoch=run_cfg.get("check_val_every_n_epoch", 1),
        class_names=dm.class_names,
        logger=logger,
        seed=seed,
        limit_train_batches=run_cfg.get("limit_train_batches"),
        limit_val_batches=run_cfg.get("limit_val_batches"),
        fast_dev_run=run_cfg.get("fast_dev_run", False),
        strict_eval_points=cfg["train"].get("strict_eval_points", False),
        strict_eval_overflow=cfg["train"].get("strict_eval_overflow", False),
        prefetch_batches=cfg["train"].get("prefetch_batches", 2),
        host_topology=cfg["train"].get("host_topology", False),
        train_log_images_step=params.get("train_log_images_step", 2000),
        val_log_images_step=params.get("val_log_images_step"),
        class_palette=class_palette(cfg),
        viz_dir=osp.join(out_dir, "figures"),
    )
    try:
        trainer.init_or_resume(resume=run_cfg.get("resume", False))
        pretrained = cfg["models"]["net2d"].get("pretrained_backbone")
        # a resumed run keeps its trained weights
        if pretrained and trainer.global_step == 0:
            from .models.torch_import import load_pretrained_backbone

            sd = load_pretrained_backbone(pretrained)
            missing = set(sd) - set(task.model2d.state_dict())
            if missing:
                raise KeyError(f"pretrained entries without a module: {sorted(missing)}")
            task.model2d.load_state_dict(sd, strict=False)
            print(f"imported pretrained RGB backbone from {pretrained}")
        if run_cfg.get("mode", "train") == "train":
            trainer.fit(resume=run_cfg.get("resume", False))
        results = trainer.test()
    finally:
        # drain and close the worker pools, also on an aborted run
        for lo in (dm.source_train, dm.target_train, dm.target_val, dm.target_test):
            lo.close()
        if group is not None:
            mesh.destroy_process_group()
    logger.finish()
    return trainer, results


if __name__ == "__main__":
    main()
