"""Training orchestration (port of `mm2d3d_tpu/train/trainer.py`): the
fit / validate / test loop, checkpoints and resume.

- per-epoch loop over paired source/target batches (max_size_cycle), the
  host-to-device copies a few pairs ahead in a background thread; with
  ``host_topology`` both batches' topologies are built on the CPU
  (`data.host_topology`, C++) in a thread pool a few pairs ahead and travel
  with the batches, so the train step builds none on the device (eval
  still does, as in JAX);
- validation every ``check_val_every_n_epoch`` on the target val and test
  loaders, with per-class IoUs for 2D, 3D and the ensemble;
- ``last``, ``best_2d`` (best ``val/target/iou``) and ``best_3d`` (best
  ``val/target/iou_3d``) checkpoints, each a `torch.save` file with a
  ``.meta.json`` beside it (epoch, step, best IoUs, results);
- resume from ``last``: weights, running statistics, both optimizers (with
  their gradient accumulators, `optim.MultiSteps`) and their schedules,
  `task.step` and the dropout generator, so the resumed run continues as
  the uninterrupted one would, between two micro-steps too;
- data parallelism, when the task has a process group (`parallel.mesh`):
  rank 0's state replicated at the start, each eval batch's metrics and
  logs reduced over the ranks, so every rank reports the same numbers and
  takes the same checkpoint decisions; rank 0 writes the checkpoints, and
  every rank waits for each one;
- qualitative figures of the first scan of a batch (`_log_images`, the
  5-panel figure of `utils.visualize`) every ``train_log_images_step``
  steps for both train batches and every ``val_log_images_step`` eval
  batches, written to ``viz_dir`` as ``<stage>_step<global step>.png`` and
  handed to the logger's `log_image`; with a class palette and a
  directory only, and on rank 0 only (the eval-mode forward has no
  collective, so the other ranks skip it).

The task holds its state in its modules and optimizers
(`train.step.MM2D3DTask`); the dropout generator is this trainer's, on the
task's device, seeded from `seed`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import host_topology as HT
from ..data.loader import max_size_cycle, prefetch_topology_pairs, prefetched
from ..parallel import mesh
from ..utils import profiling
from ..utils.logging import rank_zero
from ..utils.visualize import PALETTES, draw_points_image_labels_with_confidence
from .batch import PointBatch, prepare_device_batch
from .metrics import iou_per_class
from .step import EvalMetrics, MM2D3DTask

# capacity-overflow monitors -> suggested remedy; an overflow corrupts
# gradients, so both log paths (per-step flush with a logger, epoch-end scan
# without) warn
_OVERFLOW_FIXES = {
    "train/nbr_slot_overflow":
        "raise the slot caps (train.slot_profile: dense for 64-beam "
        "scans, or explicit slot_caps)",
    "train/voxel_overflow_levels":
        "raise the level capacities (train.batch.default_capacities)",
}


def _median_ms(spans, name: str) -> str:
    """", median <name> <ms> ms" over the steps' span records that hold
    `name`, or "" if none does."""
    ns = [s[name] for s in spans if name in s]
    return f", median {name} {float(np.median(ns)) / 1e6:.1f} ms" if ns else ""


class CheckpointIO:
    """Named checkpoints of a task under one directory: ``<name>.pt``
    (`torch.save`) and ``<name>.meta.json``."""

    def __init__(self, ckpt_dir: str):
        self.dir = osp.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return osp.join(self.dir, name + ".pt")

    def save(self, name: str, task: MM2D3DTask, generator: torch.Generator,
             meta: Dict) -> None:
        """Rank 0 writes; under data parallelism every rank waits for it."""
        if rank_zero():
            self._write(name, task, generator, meta)
        mesh.barrier()

    def _write(self, name: str, task: MM2D3DTask, generator: torch.Generator,
               meta: Dict) -> None:
        state = {
            "model2d": task.model2d.state_dict(),
            "model3d": task.model3d.state_dict(),
            "opt2d": task.opt2d.state_dict(),
            "opt3d": task.opt3d.state_dict(),
            "sched2d": task.sched2d.state_dict(),
            "sched3d": task.sched3d.state_dict(),
            "step": task.step,
            "generator": generator.get_state(),
        }
        tmp = self._path(name) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(name))
        with open(osp.join(self.dir, name + ".meta.json"), "w") as f:
            json.dump(meta, f)

    def restore(self, name: str, task: MM2D3DTask,
                generator: Optional[torch.Generator]) -> Dict:
        """Load checkpoint `name` into `task` and `generator` -> its meta.
        With `generator` None the dropout stream is not restored (an
        inference run, which may sit on another device than the training
        run's generator)."""
        state = torch.load(self._path(name), map_location=task.device,
                           weights_only=True)
        task.model2d.load_state_dict(state["model2d"])
        task.model3d.load_state_dict(state["model3d"])
        task.opt2d.load_state_dict(state["opt2d"])
        task.opt3d.load_state_dict(state["opt3d"])
        task.sched2d.load_state_dict(state["sched2d"])
        task.sched3d.load_state_dict(state["sched3d"])
        task.step = state["step"]
        if generator is not None:
            generator.set_state(state["generator"].cpu())
        meta_path = osp.join(self.dir, name + ".meta.json")
        if not osp.exists(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)

    def exists(self, name: str) -> bool:
        return osp.exists(self._path(name))


def batch_to_device(batch: PointBatch, dev: torch.device) -> PointBatch:
    """The batch's tensors on `dev`: from pinned memory with non-blocking
    copies on CUDA."""
    if dev.type != "cuda":
        return batch.to(dev)
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).pin_memory().to(dev, non_blocking=True)
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)
    })


class Trainer:
    def __init__(
        self,
        task: MM2D3DTask,
        source_loader,
        target_loader,
        val_loader=None,
        test_loader=None,
        ckpt_dir: str = "ckpts",
        max_epochs: int = 1,
        check_val_every_n_epoch: int = 1,
        class_names=None,
        logger=None,
        seed: int = 42,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        fast_dev_run: bool = False,
        strict_eval_points: bool = False,
        strict_eval_overflow: bool = False,
        prefetch_batches: int = 2,  # host-to-device pairs in flight (0: none)
        host_topology: bool = False,  # train topologies built on the CPU
        train_log_images_step: Optional[int] = None,
        val_log_images_step: Optional[int] = None,
        class_palette=None,  # a `utils.visualize.PALETTES` name or (C, 3) RGB
        viz_dir: Optional[str] = None,
    ):
        self.task = task
        self.source_loader = source_loader
        self.target_loader = target_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.ckpt = CheckpointIO(ckpt_dir)
        self.max_epochs = 1 if fast_dev_run else max_epochs
        self.check_val_every = check_val_every_n_epoch
        self.class_names = class_names or [
            f"class_{i}" for i in range(task.num_classes)]
        self.logger = logger
        self.seed = seed
        self.limit_train_batches = 2 if fast_dev_run else limit_train_batches
        self.limit_val_batches = 2 if fast_dev_run else limit_val_batches
        # scans beyond the eval point budget are cut by pad_sample, which
        # changes the metric (the reference evaluates every in-bounds
        # point): warned always, refused in strict mode; the same for hits
        # dropped by the slot tables at eval
        self.strict_eval_points = strict_eval_points
        self.strict_eval_overflow = strict_eval_overflow
        self.prefetch_batches = prefetch_batches
        self.train_log_images_step = train_log_images_step
        self.val_log_images_step = val_log_images_step
        if isinstance(class_palette, str):
            class_palette = PALETTES[class_palette]
        self.class_palette = (None if class_palette is None
                              else np.asarray(class_palette, np.uint8))
        self.viz_dir = viz_dir
        self._rank0 = rank_zero()
        if host_topology and task.group is not None:
            # as the JAX trainer does under a mesh: each rank builds its
            # shard's topologies on its device
            if self._rank0:
                print("train.host_topology is off under data parallelism: each "
                      "rank builds its topologies on its device", flush=True)
            host_topology = False
        if host_topology and getattr(task, "stem_kernel", 3) != 3:
            raise ValueError(
                "train.host_topology builds no 125-neighbour table, which the 3D "
                f"network's {task.stem_kernel}^3 stem needs: set "
                "train.host_topology=false")
        self.host_topology = host_topology
        if host_topology:
            from .. import native

            native.lib()  # builds or loads the host library, or raises
        self.generator = torch.Generator(device=task.device).manual_seed(seed)
        self.global_step = 0
        self.start_epoch = 0
        self.best = {
            "best_target_iou": 0.0,
            "best_target_iou_3d": 0.0,
            "best_target_iou_avg": 0.0,
        }
        # set by init_or_resume; a caller that loads weights into the task
        # itself (a pretrained or reference import) sets it too
        self.initialized = False
        self._overflow_warned = set()

    # -- lifecycle -----------------------------------------------------------

    def init_or_resume(self, resume: bool = False) -> None:
        """Seeded random weights, then, with `resume` and a ``last``
        checkpoint, the state it holds (every rank reads it onto its own
        device); under data parallelism, then rank 0's state on every rank."""
        self.task.init_params(torch.Generator().manual_seed(self.seed))
        self.initialized = True
        if resume and self.ckpt.exists("last"):
            meta = self.ckpt.restore("last", self.task, self.generator)
            self.best.update(meta.get("best", {}))
            self.start_epoch = meta.get("epoch", -1) + 1
            self.global_step = meta.get("global_step", 0)
            if self._rank0:
                print(f"resumed from epoch {self.start_epoch}, "
                      f"step {self.global_step}", flush=True)
        if self.task.group is not None:
            mesh.replicate(self.task, self.task.group)

    def _item_to_device(self, item):
        """(src, trg[, topo_src, topo_trg]) on the task's device."""
        src, trg, *topos = item
        dev = self.task.device
        return (batch_to_device(src, dev), batch_to_device(trg, dev),
                *(HT.to_device(t, dev) for t in topos))

    # -- train ---------------------------------------------------------------

    def fit(self, resume: bool = False) -> MM2D3DTask:
        if not self.initialized:
            self.init_or_resume(resume=resume)
        pending_logs = None  # (step, device logs, spans), read back one step late
        overflow_hist = []  # without a logger: the per-step overflow scalars
        self._overflow_warned = set()
        for epoch in range(self.start_epoch, self.max_epochs):
            self.source_loader.set_epoch(epoch)
            self.target_loader.set_epoch(epoch)
            t_epoch = time.time()
            n = 0
            pairs = max_size_cycle(self.source_loader, self.target_loader)
            if self.host_topology:
                task = self.task
                pairs = prefetch_topology_pairs(
                    pairs, task.full_scale, task.num_planes, task.slot_profile)
            items = (self._item_to_device(item) for item in pairs)
            if self.prefetch_batches:
                items = prefetched(items, self.prefetch_batches)
            spans = []  # each step's span record
            try:
                item = next(items, None)
                while item is not None:
                    src, trg, *topos = item
                    if (self.train_log_images_step
                            and self.global_step % self.train_log_images_step == 0):
                        self._log_images(src, "train_source")
                        self._log_images(trg, "train_target")
                    # one record: the step, then the wait for the next item
                    with profiling.call("train") as rec:
                        logs = self.task.train_step(src, trg, self.generator, *topos)
                        self.global_step += 1
                        n += 1
                        # the previous step's scalars, read while this one runs
                        if pending_logs is not None and self.logger is not None:
                            self._flush_train_logs(*pending_logs)
                        elif pending_logs is not None:
                            s_prev, l_prev, _ = pending_logs
                            overflow_hist.append((s_prev, {
                                k: l_prev[k] for k in _OVERFLOW_FIXES if k in l_prev}))
                        pending_logs = (self.global_step, logs, rec["spans"])
                        spans.append(rec["spans"])
                        if self.limit_train_batches and n >= self.limit_train_batches:
                            break
                        with profiling.span("fit/loader_wait"):
                            item = next(items, None)
            finally:
                items.close()  # stops the prefetch thread now, not at collection
                pairs.close()  # and the topology pool
            if pending_logs is not None:
                # flushed even without a logger: the overflow monitors warn
                self._flush_train_logs(*pending_logs)
                pending_logs = None
            self._check_overflow_history(overflow_hist)
            overflow_hist = []
            if self._rank0:
                print(f"epoch {epoch}: {n} steps in {time.time() - t_epoch:.1f}s"
                      + _median_ms(spans, "step") + _median_ms(spans, "fit/loader_wait"),
                      flush=True)
            if (epoch + 1) % self.check_val_every == 0 or epoch == self.max_epochs - 1:
                self.validate(epoch)
        return self.task

    def _warn_overflow(self, key: str, value: float, step: int) -> None:
        if key in self._overflow_warned:
            return
        self._overflow_warned.add(key)
        if self._rank0:
            print(
                f"WARNING: {key} = {value:.0f} at step {step} — "
                f"dropped topology entries make the computed gradients "
                f"inconsistent with the forward; {_OVERFLOW_FIXES[key]}.",
                flush=True,
            )

    def _check_overflow_history(self, hist) -> None:
        """Without a logger the per-step logs are not read back; the fit
        loop keeps the overflow scalars and this scans them once per epoch,
        so an overflow on any step warns."""
        for key in _OVERFLOW_FIXES:
            entries = [(s, d[key]) for s, d in hist if key in d]
            if not entries:
                continue
            arr = torch.stack([v.float() for _, v in entries]).cpu()
            nz = torch.nonzero(arr > 0).flatten()
            if nz.numel():
                i = int(nz[0])
                self._warn_overflow(key, float(arr[i]), entries[i][0])

    def _flush_train_logs(self, step: int, logs,
                          spans: Optional[Dict[str, int]] = None) -> None:
        """The step's logs, its learning rates and its spans' host ms
        (`time/<span>_ms`, from the step's record) to the logger, one
        device-to-host copy."""
        keys = list(logs)
        vals = torch.stack([logs[k].float() for k in keys]).cpu()  # one copy
        host = dict(zip(keys, map(float, vals)))
        for key in _OVERFLOW_FIXES:
            if host.get(key, 0.0) > 0:
                self._warn_overflow(key, host[key], step)
        if self.logger is not None:
            times = {f"time/{name}_ms": ns / 1e6 for name, ns in (spans or {}).items()}
            self.logger.log_metrics({**host, **self.task.current_lrs(step), **times}, step)

    def _log_images(self, batch: PointBatch, stage: str) -> None:
        """The 5-panel figure of the batch's first scan (the JAX trainer's
        `_log_images`): the eval-mode predictions of `viz_forward` over the
        image the network consumed (the device-jittered one, for a wire
        batch with `jitter_params`)."""
        if self.class_palette is None or self.viz_dir is None or not self._rank0:
            return
        out = {k: v[0].cpu().numpy() for k, v in self.task.viz_forward(batch).items()}
        mask = batch.point_mask[0].cpu().numpy()
        path = osp.join(self.viz_dir, f"{stage}_step{self.global_step}.png")
        draw_points_image_labels_with_confidence(
            prepare_device_batch(batch).img[0].cpu().numpy(),
            out["pred_2d_dense"],
            out["pred_2d_points"][mask],
            out["pred_3d_points"][mask],
            out["confidence"][mask],
            batch.seg_label[0].cpu().numpy()[mask],
            batch.img_indices[0].cpu().numpy()[mask],
            color_palette=self.class_palette,
            out_path=path,
        )
        if self.logger is not None:
            self.logger.log_image(f"{stage}/figure", path, self.global_step)

    # -- eval ----------------------------------------------------------------

    def _eval_batches(self, loader, stage: str):
        """The loader's batches on the device, a figure of every
        ``val_log_images_step``-th one first."""
        for i, batch in enumerate(loader):
            batch = batch_to_device(batch, self.task.device)
            if self.val_log_images_step and i % self.val_log_images_step == 0:
                self._log_images(batch, stage.replace("/", "_"))
            yield batch

    def _run_eval(self, loader, stage: str) -> Dict[str, float]:
        metrics, losses, points_dropped = evaluate(
            self.task, self._eval_batches(loader, stage), self.limit_val_batches)

        if points_dropped:
            msg = (
                f"{stage}: {points_dropped} in-bounds points were truncated "
                f"by the n_points={loader.n_points} budget — the reported "
                "IoU misses them (the reference evaluates every point). "
                "Raise train.n_points to cover the dataset."
            )
            if self.strict_eval_points:
                raise RuntimeError(msg)
            if self._rank0:
                print(f"WARNING: {msg}", flush=True)

        out = {f"{stage}/points_dropped": float(points_dropped)}
        for head, cm in (("", metrics.cm_2d), ("_3d", metrics.cm_3d),
                         ("_avg", metrics.cm_avg)):
            ious = iou_per_class(cm).cpu()
            if self._rank0:
                print(f"{stage} {head or '2d'}:")
                print([(c, round(float(v), 4))
                       for c, v in zip(self.class_names, ious)])
            out[f"{stage}/iou{head}"] = float(ious.mean())
        if losses:
            keys = list(losses[0])
            stacked = torch.stack([
                torch.stack([l[k].float() for l in losses]) for k in keys
            ]).cpu()  # one copy for the whole eval run
            # the losses are masked means: average them across batches
            # weighted by each batch's class-weight sum over valid points,
            # so the padded tail batch does not count like a full one
            w = stacked[keys.index("valid_weight")] if "valid_weight" in keys else None
            for j, k in enumerate(keys):
                if k == "valid_weight":
                    continue
                if w is not None and k.startswith("loss"):
                    out[f"{stage}/{k}"] = float(
                        (stacked[j] * w).sum() / max(float(w.sum()), 1.0))
                else:
                    out[f"{stage}/{k}"] = float(stacked[j].mean())

        # hits dropped by the slot tables at eval change the predictions
        overflow = out.get(f"{stage}/nbr_slot_overflow", 0.0)
        if overflow > 0:
            msg = (
                f"{stage}: neighbour-slot overflow (mean {overflow:.1f} "
                "dropped conv hits/batch) — the reported IoU is computed on "
                "truncated sparse convolutions. Raise the slot caps "
                "(train.slot_profile: dense, or explicit slot_caps)."
            )
            if self.strict_eval_overflow:
                raise RuntimeError(msg)
            if self._rank0:
                print(f"WARNING: {msg}", flush=True)
        return out

    def validate(self, epoch: int) -> Dict[str, float]:
        results = {}
        if self.val_loader is not None:
            results.update(self._run_eval(self.val_loader, "val/target"))
        if self.test_loader is not None:
            results.update(self._run_eval(self.test_loader, "test/target"))

        iou_2d = results.get("val/target/iou", 0.0)
        iou_3d = results.get("val/target/iou_3d", 0.0)
        iou_avg = results.get("val/target/iou_avg", 0.0)
        meta = {
            "epoch": epoch,
            "global_step": self.global_step,
            "best": self.best,
            "results": results,
        }
        if iou_2d > self.best["best_target_iou"]:
            self.best["best_target_iou"] = iou_2d
            self.ckpt.save("best_2d", self.task, self.generator, meta)
        if iou_3d > self.best["best_target_iou_3d"]:
            self.best["best_target_iou_3d"] = iou_3d
            self.ckpt.save("best_3d", self.task, self.generator, meta)
        if iou_avg > self.best["best_target_iou_avg"]:
            self.best["best_target_iou_avg"] = iou_avg
        self.ckpt.save("last", self.task, self.generator, meta)

        if self.logger is not None:
            self.logger.log_metrics({**results, **self.best}, self.global_step)
        return results

    def test(self) -> Dict[str, float]:
        assert self.test_loader is not None and self.initialized
        return self._run_eval(self.test_loader, "test/target")


def evaluate(task: MM2D3DTask, batches, limit: Optional[int] = None):
    """The eval loop over `batches` (at most `limit` of them) -> (confusion
    matrices, the logs of each batch, in-bounds points cut by the point
    budget).  With the task's process group, each batch's metrics and logs
    are reduced over the ranks (`parallel.mesh.reduce_eval`) and the cut
    points summed, so every rank returns the same."""
    metrics = EvalMetrics.create(task.num_classes, task.device)
    losses = []
    dropped = torch.zeros((), dtype=torch.int64, device=task.device)
    for i, batch in enumerate(batches):
        if batch.n_dropped is not None:
            dropped += batch.n_dropped.sum()
        new, logs = task.eval_step(batch, metrics)
        if task.group is not None:
            new, logs = mesh.reduce_eval(metrics, new, logs, task.group)
        metrics = new
        losses.append(logs)
        if limit and i + 1 >= limit:
            break
    if task.group is not None:
        dist.all_reduce(dropped, group=task.group)
    return metrics, losses, int(dropped)
