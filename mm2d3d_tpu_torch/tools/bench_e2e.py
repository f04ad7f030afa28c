"""Sustained end-to-end training rate: loader -> copy -> train step, through
the real `Trainer.fit` on one NVIDIA GPU (port of `tools/bench_e2e.py`).

The train step (`chip_smoke.py` phase 6) and the loader
(`tools/bench_loader.py`) are each measured alone; this composes them
through the trainer's hot path (forkserver loader workers, uint8 wire
batches, the pinned non-blocking copies in the prefetch thread, the flagship
bf16 train step) and reports one sustained scans/s number with what
explains it:

1. the unpipelined stage split, 0 workers: loader ms per batch, the batch's
   bytes, the copy to the card, the train step on batches already there
   (`bench_loader.split_stages`);
2. the loader's scans/s per worker count, two epochs each;
3. `Trainer.fit` at the fastest worker count: a warm epoch, then a timed
   one (`e2e_*`; an epoch of `--scans` at batch 8 may end before
   `--steps`, as in the JAX tool: `e2e_steps_measured` says how many ran);
4. two controls on the same task, `--steps` steps each: (a) the stage
   split's four host batches repeated by a list loader, (b) the same
   batches already on the card, `Trainer._item_to_device` the identity;
5. step 3 again with `Trainer(host_topology=True)`: both domains'
   topologies built on the host (C++) in 3 threads ahead
   (`e2e_ms_per_step_host_topology`).

The data is a synthetic on-disk nuScenes tree in a temporary directory
(`bench_loader.write_dataset`: 1600x900 JPEG frames, `--points` a scan) and,
unless `--no-cache`, its decoded-image cache; batch 8 per domain, 8192
points, the JAX tool's augmentations.  Usage::

    python -m mm2d3d_tpu_torch.tools.bench_e2e [--scans 64] [--steps 30]
        [--workers 0 2 4] [--points 12000] [--no-cache] [--no-wire] [--keep]

Prints the card's name and power limit first and one JSON line with the JAX
tool's keys and ``e2e_ms_per_step_host_topology``.  `main` refuses to run
without a CUDA device; the functions take the device from the task, so a
CPU task runs them on the CPU.  Every loader is closed and the loader
pools' server processes stopped before `run` returns.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import shutil
import subprocess
import tempfile
import time

import torch

from . import bench_loader
from .autotune import ListLoader, sync

BATCH = 8  # per domain, per step
N_POINTS = 8192
HOST_BATCHES = 4  # the stage split's and the controls' host batches
STAGE_STEPS = 6  # timed train steps of the stage split, after 2 warm
SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def batch_wire_bytes(batch) -> int:
    """Bytes of the batch's tensors: what one copy to the card moves."""
    return sum(t.numel() * t.element_size()
               for t in (getattr(batch, f.name) for f in dataclasses.fields(batch))
               if isinstance(t, torch.Tensor))


def make_loaders(root: str, cache_dir, workers: int, wire: bool, full_scale: int,
                 seed: int = 0):
    """The source and target train loaders over the tree at `root`: the
    nuScenes dataset with the flagship's augmentations, seeds `seed` and
    `seed` + 1."""
    from ..data.loader import Loader
    from ..data.nuscenes import NuScenesLidarSeg

    def loader(s):
        ds = NuScenesLidarSeg(
            split=("train_usa",), preprocess_dir=root, nuscenes_dir=root,
            full_scale=full_scale, resize=bench_loader.RESIZE_WH,
            image_cache_dir=cache_dir, device_image_ops=wire, noisy_rot=0.1, flip_x=0.5, rot=6.2831,
            transl=True, fliplr=0.5, color_jitter=(0.4, 0.4, 0.4))
        return Loader(ds, batch_size=BATCH, n_points=N_POINTS, shuffle=True,
                      drop_last=True, seed=seed + s, num_workers=workers,
                      full_scale=full_scale)

    return loader(0), loader(1)


def loader_rates(root: str, cache_dir, workers, wire: bool, full_scale: int) -> dict:
    """Scans/s of the source loader over two epochs per worker count, after
    a warm batch; each pool closed before the next starts."""
    rates = {}
    for w in workers:
        lo = make_loaders(root, cache_dir, w, wire, full_scale, seed=10)[0]
        try:
            next(iter(lo))  # warm the pool
            t0 = time.perf_counter()
            n = 0
            for ep in range(2):
                lo.set_epoch(ep)
                for b in lo:
                    n += b.batch_size
            rates[str(w)] = n / (time.perf_counter() - t0)
        finally:
            lo.close()
    return rates


def timed_fit(trainer) -> tuple:
    """A warm epoch, then a timed one through `Trainer.fit`, the device
    synchronised before and after -> (ms per step, steps timed).  The fit
    reads its last step's logs back at the epoch's end; nothing else syncs
    inside the timed window."""
    dev = trainer.task.device
    trainer.validate = lambda epoch: {}  # no eval or checkpoint in the timing
    trainer.fit()
    sync(dev)
    trainer.start_epoch, trainer.max_epochs = 1, 2
    g0 = trainer.global_step
    t0 = time.perf_counter()
    trainer.fit()
    sync(dev)
    dt = time.perf_counter() - t0
    steps = trainer.global_step - g0
    if steps <= 0:
        raise ValueError("the timed epoch ran no step")
    return dt * 1e3 / steps, steps


def fit_rate(task, root: str, cache_dir, workers: int, wire: bool, steps: int,
             ckpt_dir: str, host_topology: bool = False) -> tuple:
    """`Trainer.fit` over the tree's loaders from the trainer's seeded
    weights -> (ms per step, steps timed); the loaders are closed."""
    from ..train.trainer import Trainer

    src, trg = make_loaders(root, cache_dir, workers, wire, task.full_scale, seed=20)
    try:
        trainer = Trainer(task, source_loader=src, target_loader=trg,
                          ckpt_dir=ckpt_dir, max_epochs=1,
                          check_val_every_n_epoch=1000, limit_train_batches=steps,
                          host_topology=host_topology)
        return timed_fit(trainer)
    finally:
        src.close()
        trg.close()


def control(task, batches, steps: int, ckpt_dir: str, on_device: bool) -> float:
    """`Trainer.fit` over fixed batches repeated by a list loader, on the
    task's weights as they stand -> ms per step.  With `on_device` the
    batches are copied to the device first and the trainer copies nothing."""
    from ..train.trainer import Trainer, batch_to_device

    if on_device:
        batches = [batch_to_device(b, task.device) for b in batches]
        sync(task.device)
    trainer = Trainer(task, source_loader=ListLoader(batches, steps),
                      target_loader=ListLoader(batches, steps), ckpt_dir=ckpt_dir,
                      max_epochs=1, check_val_every_n_epoch=1000,
                      limit_train_batches=steps)
    trainer.initialized = True  # the task holds its weights already
    if on_device:
        trainer._item_to_device = lambda item: item
    return timed_fit(trainer)[0]


def run(task, scans: int = 64, steps: int = 30, workers=(0,), points: int = 12000,
        cache: bool = True, wire: bool = True, keep: bool = False) -> dict:
    """Parts 1-5 of the module's docstring on the task's device -> the
    result (the JAX tool's keys and ``e2e_ms_per_step_host_topology``)."""
    from ..data.image_cache import build_image_cache
    from ..data.loader import stop_worker_server

    tmp = tempfile.mkdtemp(prefix="mm2d3d_e2e_")
    try:
        print(f"dataset: {scans} scans x {points} pts -> {tmp}", flush=True)
        records = bench_loader.write_dataset(tmp, scans, points)
        cache_dir = None
        if cache:
            cache_dir = osp.join(tmp, "img_cache")
            t0 = time.perf_counter()
            build_image_cache([r["camera_path"] for r in records], tmp, cache_dir,
                              bench_loader.RESIZE_WH)
            print(f"cache build: {time.perf_counter() - t0:.1f}s one-time", flush=True)
        result = {"wire_format": wire, "cache": cache_dir is not None}

        src = make_loaders(tmp, cache_dir, 0, wire, task.full_scale)[0]
        try:
            task.init_params(torch.Generator().manual_seed(0))
            stages, host = bench_loader.split_stages(src, task, HOST_BATCHES, 1,
                                                     STAGE_STEPS)
        finally:
            src.close()
        result["stage_loader_ms_per_batch"] = stages["stage_loader_ms_per_batch"]
        result["batch_wire_bytes"] = batch_wire_bytes(host[0])
        result["stage_transfer_ms_per_batch"] = stages["stage_transfer_ms_per_batch"]
        result["stage_device_step_ms"] = stages["stage_device_step_ms"]

        rates = loader_rates(tmp, cache_dir, workers, wire, task.full_scale)
        result["loader_scans_per_sec_by_workers"] = rates
        best = int(max(rates, key=rates.get))

        ms, n = fit_rate(task, tmp, cache_dir, best, wire, steps, osp.join(tmp, "ck1"))
        result["e2e_steps_measured"] = n
        result["e2e_train_scans_per_sec"] = 2 * BATCH * 1e3 / ms
        result["e2e_ms_per_step"] = ms

        result["ctrl_host_batches_ms_per_step"] = control(
            task, host, steps, osp.join(tmp, "ck2"), on_device=False)
        result["ctrl_device_batches_ms_per_step"] = control(
            task, host, steps, osp.join(tmp, "ck3"), on_device=True)

        result["e2e_ms_per_step_host_topology"] = fit_rate(
            task, tmp, cache_dir, best, wire, steps, osp.join(tmp, "ck4"),
            host_topology=True)[0]
        return result
    finally:
        stop_worker_server()
        if keep:
            print(f"kept {tmp}", flush=True)
        else:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--workers", type=int, nargs="*", default=[0])
    ap.add_argument("--points", type=int, default=12000)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--no-wire", action="store_true")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_e2e times the card: no CUDA device")
    from ..flagship import flagship_task

    print(subprocess.run(SMI, capture_output=True, text=True).stdout.strip(), flush=True)
    task = flagship_task(device=torch.device("cuda", 0))
    result = run(task, args.scans, args.steps, args.workers, args.points,
                 cache=not args.no_cache, wire=not args.no_wire, keep=args.keep)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
