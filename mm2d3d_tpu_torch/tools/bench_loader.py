"""Host input pipeline rate: can the loader feed the card?

Port of `tools/bench_loader.py`, with the stage split of `tools/bench_e2e.py`.
Writes a synthetic on-disk nuScenes tree into a temporary directory
(1600x900 JPEG frames and the preprocess pickles' records) and drives
`configs/config.yaml` as shipped (batch 16 per domain, 8192 points, every
augmentation, the device image ops) with only its paths, the batch and the
worker count overridden.  It measures the source train loader's scans/s
(JPEG decode, resize, depth and label maps, flip, 3D augmentation, Morton
pre-sort, collate) on three paths:

  numpy   ``MM2D3D_HOST_NATIVE=0``: the numpy image ops
  native  the C++ image ops (`csrc/host_ops.cpp`, the default)
  cache   the decoded-image cache (`tools.cache_images`) with the C++ ops

and, unless ``--no-step``, the stage split of one train step at the loader's
batch on the native path: loader ms per batch in this process, the copy of
a batch to the card (pinned, non-blocking, as `Trainer` copies it) and the
flagship bf16 train step on those batches.  The stages are measured one
after another, not overlapped, as `tools/bench_e2e.py` does::

    python -m mm2d3d_tpu_torch.tools.bench_loader [--scans 48] [--points 12000]
        [--batch 16] [--workers 0] [--epochs 2] [--device cuda] [--no-step]

Prints one JSON line at the end.  Each path runs with its own loader
worker server (`data.loader.stop_worker_server` between paths), since the
workers take ``MM2D3D_HOST_NATIVE`` from the environment that server
started in.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import os.path as osp
import pickle
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from .autotune import sync

PATHS = ("numpy", "native", "cache")
SPLITS = ("train_usa", "train_singapore", "val_singapore", "test_singapore")
FRAME_WH = (1600, 900)
RESIZE_WH = (400, 225)  # configs/datasets/nuscenes_usa_singapore.yaml
CONFIG = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
                  "configs", "config.yaml")


def write_dataset(root: str, n_scans: int, n_points: int, seed: int = 0) -> list:
    """`n_scans` frames and scan records in the preprocess pickles' schema,
    the same records in each of the config's four splits -> the records."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(osp.join(root, "samples"), exist_ok=True)
    records = []
    for i in range(n_scans):
        # a smooth image, so that the JPEG is of a camera frame's size
        low = rng.randint(0, 255, size=(45, 80, 3), dtype=np.uint8)
        img = Image.fromarray(low).resize(FRAME_WH, Image.BILINEAR)
        rel = f"samples/frame_{i:04d}.jpg"
        img.save(osp.join(root, rel), quality=90)
        pts_cam = np.stack([rng.uniform(-20, 20, n_points), rng.uniform(-3, 3, n_points),
                            rng.uniform(2, 60, n_points)], 1).astype(np.float32)
        points_img = np.stack([rng.uniform(0, FRAME_WH[1] - 1, n_points),
                               rng.uniform(0, FRAME_WH[0] - 1, n_points)],
                              1).astype(np.float32)
        records.append({
            "points": pts_cam + rng.randn(3).astype(np.float32),
            "pts_cam_coord": pts_cam,
            "seg_labels": rng.randint(0, 17, size=n_points).astype(np.uint8),
            "points_img": points_img,
            "camera_path": rel,
            "lidar_path": "",
            "sample_token": f"tok{i}",
            "scene_name": "scene-0001",
            "calib": {"cam_intrinsic": [[1266.0, 0, 816.0], [0, 1266.0, 491.0],
                                        [0, 0, 1.0]]},
        })
    for split in SPLITS:
        with open(osp.join(root, split + ".pkl"), "wb") as f:
            pickle.dump(records, f)
    return records


def config(root: str, batch: int, workers: int, cache_dir=None) -> dict:
    """configs/config.yaml over the tree at `root`."""
    from ..run import parse_config

    over = [f"run.batch_size={batch}", f"train.num_workers={workers}"]
    for side in ("source", "target"):
        over += [f"dataset.{side}.preprocess_dir={root}",
                 f"dataset.{side}.nuscenes_dir={root}"]
        if cache_dir:
            over.append(f"dataset.{side}.image_cache_dir={cache_dir}")
    return parse_config(CONFIG, over)


def close(dm) -> None:
    for loader in (dm.source_train, dm.target_train, dm.target_val, dm.target_test):
        loader.close()


def loader_rate(cfg: dict, native: bool, epochs: int) -> float:
    """Scans/s of the config's source train loader over `epochs` epochs,
    after one warm-up batch (imports, the host library, file caches)."""
    from ..data.loader import stop_worker_server
    from ..run import build_datamodule

    before = os.environ.get("MM2D3D_HOST_NATIVE")
    os.environ["MM2D3D_HOST_NATIVE"] = "1" if native else "0"
    dm = build_datamodule(cfg)
    try:
        loader = dm.source_train
        next(iter(loader))
        n, t0 = 0, time.perf_counter()
        for ep in range(epochs):
            loader.set_epoch(ep)
            for b in loader:
                n += b.batch_size
        return n / (time.perf_counter() - t0)
    finally:
        close(dm)
        stop_worker_server()  # the next path's workers read the switch anew
        if before is None:
            os.environ.pop("MM2D3D_HOST_NATIVE", None)
        else:
            os.environ["MM2D3D_HOST_NATIVE"] = before


def stage_split(cfg: dict, device: str, reps: int = 3, steps: int = 3) -> dict:
    """Loader, copy and train-step ms per batch, one after another."""
    from ..flagship import flagship_task
    from ..run import build_datamodule

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("the stage split times the card: pass a CUDA device")
    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    dm = build_datamodule(cfg)
    try:
        out, _ = split_stages(dm.source_train, task, 2, reps, steps)
    finally:
        close(dm)
    return {**out, "device": torch.cuda.get_device_name(dev)}


def split_stages(loader, task, n_batches: int, reps: int, steps: int):
    """The unpipelined stages of a train step on the task's device: the
    loader's ms per batch over `n_batches` (after a warm batch), the copy of
    those batches to the device (pinned, non-blocking, as `Trainer` copies
    them) and the train step on the first two copies (2 warm steps, then
    the median of `reps` samples of `steps`) -> (ms by stage, the host
    batches)."""
    from ..train.trainer import batch_to_device

    dev = task.device
    next(iter(loader))  # warm
    loader.set_epoch(1)
    t0 = time.perf_counter()
    host = list(itertools.islice(loader, n_batches))
    load_ms = (time.perf_counter() - t0) / n_batches * 1e3
    if len(host) < max(n_batches, 2):
        raise ValueError(f"the stage split needs {max(n_batches, 2)} batches of "
                         f"the loader, it has {len(host)}")
    batch_to_device(host[0], dev)
    sync(dev)
    t0 = time.perf_counter()
    on_card = [batch_to_device(b, dev) for b in host]
    sync(dev)
    copy_ms = (time.perf_counter() - t0) / len(host) * 1e3

    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        task.train_step(on_card[0], on_card[1], gen)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            logs = task.train_step(on_card[0], on_card[1], gen)
        sync(dev)
        samples.append((time.perf_counter() - t0) / steps * 1e3)
    loss = float(logs["train/loss_total"])
    if not np.isfinite(loss):
        raise AssertionError(f"train/loss_total {loss}")
    out = {"stage_loader_ms_per_batch": load_ms,
           "stage_transfer_ms_per_batch": copy_ms,
           "stage_device_step_ms": statistics.median(samples),
           "stage_device_step_ms_band": [min(samples), max(samples)]}
    if dev.type == "cuda":
        out["stage_device_step_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out, host


def run(scans: int = 48, points: int = 12000, batch: int = 16, workers: int = 0,
        epochs: int = 2, device: str = "cuda", step: bool = True) -> dict:
    from ..data.image_cache import build_image_cache

    root = tempfile.mkdtemp(prefix="mm2d3d_loaderbench_")
    try:
        records = write_dataset(root, scans, points)
        cache_dir = osp.join(root, "img_cache")
        t0 = time.perf_counter()
        build_image_cache([r["camera_path"] for r in records], root, cache_dir,
                          RESIZE_WH)
        out = {"metric": "loader_scans_per_sec", "scans": scans, "points": points,
               "batch": batch, "workers": workers, "epochs": epochs,
               "cache_build_s": time.perf_counter() - t0, "results": {}}
        for path in PATHS:
            cfg = config(root, batch, workers, cache_dir if path == "cache" else None)
            rate = loader_rate(cfg, native=path != "numpy", epochs=epochs)
            out["results"][path] = rate
            print(f"{path:7s} {rate:8.2f} scans/s ({1e3 / rate:7.2f} ms per scan, "
                  f"{workers} workers)", flush=True)
        if step:
            out.update(stage_split(config(root, batch, 0), device))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=48)
    ap.add_argument("--points", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-step", action="store_true",
                    help="measure the loader paths only (no card needed)")
    args = ap.parse_args(argv)
    out = run(args.scans, args.points, args.batch, args.workers, args.epochs,
              args.device, step=not args.no_step)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
