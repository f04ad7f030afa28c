"""Host self-validation: re-measure the defaults that depend on the host, on
THE CURRENT host and card, and print the configuration to use (port of
`mm2d3d_tpu/tools/autotune.py`).

Three of the port's performance defaults depend on the machine: host-built
topologies off (`train.host_topology`), `train.prefetch_batches=2` and the
loader's worker count (`train.num_workers`).  This command re-runs the A/B
probes that decide them, at the flagship problem size, and prints what
THIS machine wants:

1. workers       — forkserver loader pools (0, 2, 4 workers) over the real
                   per-sample 3D augment and collate;
2. host topology — the eval forward with its topology built on the card
                   (K3) against the forward with the topology built on the
                   host (C++, `data/host_topology.py`) in 3 threads ahead;
3. prefetch      — the real `Trainer.fit` hot path at depths 0, 2 and 4.

The JAX tool's first probe, buffer donation to a jitted train step, has no
counterpart: the port's train step updates the weights and the optimizer
state in place, so there is nothing to choose.  `--skip donation` is
accepted; otherwise one line says so, and neither `measured` nor
`recommended` has a donation entry.

Usage:
    python -m mm2d3d_tpu_torch.tools.autotune [--iters 8] [--skip workers ...]

(also reachable as `python -m mm2d3d_tpu_torch.tools.doctor --perf`)

The device probes run the flagship task (batch 8, 8192 points, bf16) on the
CUDA device and raise where there is none.  The host-topology probe raises
where the host library cannot be built, as every path of the port that asks
for it does (the JAX tool instead recommends off with a note).  The last
line is one JSON object, {"measured": {...}, "recommended": {...}}, with
the JAX tool's keys; apply the recommendation through
`train.host_topology`, `train.prefetch_batches` and `train.num_workers`.
The probe functions take the task, the batches and the sizes as arguments.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 8
N_POINTS = 8192
SCAN = dict(height=225, width=400, n_points=N_POINTS, num_classes=6,
            full_scale=4096)
DONATION_NOTE = ("not probed: the port's train step updates the weights and "
                 "the optimizer state in place, so there is no buffer "
                 "donation to choose")
# what a train step updates in place, restored before every prefetch depth
_TASK_STATE = ("model2d", "model3d", "opt2d", "opt3d", "sched2d", "sched3d")


def host_topology_rule(ms) -> bool:
    """Host-built topologies win only below 0.95x the device build's time."""
    return ms["host-topo"] < ms["device-topo"] * 0.95


def prefetch_rule(ms) -> int:
    """The smallest depth within 3% of the fastest (less memory pinned)."""
    best = min(ms.values())
    return next(int(d) for d in sorted(ms, key=int) if ms[d] <= best * 1.03)


def workers_rule(rates) -> int:
    """The smallest worker count within 5% of the highest rate."""
    best = max(rates.values())
    return next(int(w) for w in sorted(rates, key=int)
                if rates[w] >= best * 0.95)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_batches(seeds=(0, 1), batch_size: int = BATCH, **scan):
    """Synthetic flagship batches on the CPU, one per seed."""
    from ..data.synthetic import make_batch

    return [make_batch(np.random.RandomState(s), batch_size=batch_size,
                       **{**SCAN, **scan}) for s in seeds]


def probe_host_topology(task, host_batches, dev_batches, iters):
    """The eval forward with its topology built on the device vs built on
    the host (C++) in a pool of 3 threads, submitted up front, and copied
    to the device.  The first forward of each path (batch 0) warms it and
    must give the other's outputs bit for bit."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import native
    from ..data.host_topology import to_device, topology_for_batch

    native.lib()  # builds or loads the host library, or raises

    def build(i):
        t = topology_for_batch(host_batches[i % len(host_batches)],
                               task.full_scale, task.num_planes,
                               slot_profile=task.slot_profile)
        return to_device(t, task.device)

    dev = task.device
    ms = {}
    # device build
    warm_dev = task.forward(dev_batches[0])
    sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        task.forward(dev_batches[i % len(dev_batches)])
    sync(dev)
    ms["device-topo"] = (time.perf_counter() - t0) / iters * 1000
    # host build, pipelined 3 deep
    with ThreadPoolExecutor(max_workers=3) as pool:
        warm_host = task.forward(dev_batches[0], topo=build(0))
        sync(dev)
        for k, v in warm_dev.items():
            if not torch.equal(v, warm_host[k]):
                raise AssertionError(
                    f"host-built topology: forward output {k} differs from "
                    "the device-built topology's")
        t0 = time.perf_counter()
        futs = [pool.submit(build, i) for i in range(iters)]
        for i, fut in enumerate(futs):
            task.forward(dev_batches[i % len(dev_batches)], topo=fut.result())
        sync(dev)
        ms["host-topo"] = (time.perf_counter() - t0) / iters * 1000
    return ms, {"host_topology": host_topology_rule(ms)}


class ListLoader:
    """Fixed host batches as a train loader: what `Trainer.fit` and
    `max_size_cycle` call on one."""

    def __init__(self, items, n):
        self.items, self.n = items, n

    def set_epoch(self, epoch):
        pass

    def set_cycle(self, cycle):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield self.items[i % len(self.items)]


def probe_prefetch(task, host_batches, iters, depths=(0, 2, 4)):
    """The real Trainer.fit hot path (host batches -> the prefetch thread's
    copies -> train step) at each depth: a warm epoch, then a timed one.
    Every depth starts from the task's state on entry (weights, running
    statistics, optimizers, schedules, step), which the task holds again
    on return."""
    from ..train.trainer import Trainer

    saved = copy.deepcopy({k: getattr(task, k).state_dict() for k in _TASK_STATE})
    step0 = task.step

    def restore():
        for k, state in copy.deepcopy(saved).items():
            getattr(task, k).load_state_dict(state)
        task.step = step0

    ms = {}
    try:
        for depth in depths:
            restore()
            with tempfile.TemporaryDirectory(prefix="mm2d3d_autotune_ck_") as ck:
                tr = Trainer(
                    task, source_loader=ListLoader(host_batches, iters),
                    target_loader=ListLoader(host_batches[::-1], iters),
                    ckpt_dir=ck, max_epochs=1, check_val_every_n_epoch=1000,
                    limit_train_batches=iters, prefetch_batches=depth,
                )
                tr.initialized = True  # the task holds its weights already
                tr.validate = lambda epoch: {}
                tr.fit()  # warm epoch
                sync(task.device)
                tr.start_epoch, tr.max_epochs = 1, 2
                t0 = time.perf_counter()
                tr.fit()
                sync(task.device)
                ms[str(depth)] = (time.perf_counter() - t0) / iters * 1000
    finally:
        restore()
    return ms, {"prefetch_batches": prefetch_rule(ms)}


class SynthDataset:
    """Representative host cost: the real 3D augment + in-bounds filter
    (collate then pads/Morton-sorts, as for any dataset).  Module-level so
    the worker pool (forkserver context) can pickle it."""

    def __init__(self, length: int = 64):
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, index, rng=None):
        from ..data.augment import augment_and_scale_3d

        rng = rng or np.random.RandomState(index)
        n = 24000
        pts = rng.randn(n, 3).astype(np.float32) * 20
        coords, _, _, _ = augment_and_scale_3d(
            pts, 20.0, 4096, rng, noisy_rot=0.1, flip_x=0.5,
            rot_z=6.2831, transl=True,
        )
        coords = coords.astype(np.int64)
        keep = ((coords >= 0) & (coords < 4096)).all(1)
        coords = coords[keep]
        m = len(coords)
        h, w = 225, 400
        return {
            "img": (rng.rand(h, w, 3) * 255).astype(np.uint8),
            "depth": np.zeros((h, w, 1), np.float32),
            "img_indices": np.stack(
                [rng.randint(0, h, m), rng.randint(0, w, m)], 1
            ).astype(np.int64),
            "coords": coords,
            "feats": rng.rand(m, 3).astype(np.float32),
            "seg_label": rng.randint(0, 6, m).astype(np.int64),
        }


def probe_workers(iters, worker_counts=(0, 2, 4), dataset=None,
                  batch_size: int = BATCH, n_points: int = N_POINTS):
    """Worker-pool scaling of the real per-sample augment+pad host pipeline.

    Times one FULL epoch after a full warm epoch: the pooled loader
    pre-submits a ~2-batch readahead window, so timing from mid-epoch
    (after a warm batch) hands the pool up to 2 batches of free head
    start and overstates its rate vs num_workers=0.  A complete epoch has
    no freebies — the window refills inside the first timed next() and
    drains to empty by the last — and the warm epoch absorbs the one-time
    pool/imports startup for both paths.  Every pool is closed and the
    pools' server processes stopped before it returns."""
    del iters  # epoch length (len(dataset) / batch_size) fixes the work
    from ..data.loader import Loader, stop_worker_server

    dataset = SynthDataset() if dataset is None else dataset
    rates = {}
    try:
        for w in worker_counts:
            lo = Loader(dataset, batch_size=batch_size, n_points=n_points,
                        shuffle=True, seed=0, num_workers=w, full_scale=4096)
            try:
                n_warm = sum(b.batch_size for b in lo)  # warm full epoch
                t0 = time.perf_counter()
                n = sum(b.batch_size for b in lo)
                rates[str(w)] = n / (time.perf_counter() - t0)
                if n != n_warm:
                    raise AssertionError(f"{w} workers: {n} scans after {n_warm}")
            finally:
                lo.close()
    finally:
        stop_worker_server()
    rec = {"num_workers": workers_rule(rates)}
    return {k: round(v, 1) for k, v in rates.items()}, rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=["donation", "host_topology", "prefetch",
                             "workers"])
    args = ap.parse_args(argv)

    import faulthandler
    import signal

    # kill -USR1 <pid> dumps all Python stacks — first-line diagnosis when
    # a probe appears stuck on an unfamiliar machine
    faulthandler.register(signal.SIGUSR1, file=sys.__stderr__)

    measured, recommended = {}, {}

    # The workers probe runs before any CUDA work, as in the JAX tool.  The
    # pools fork from a fresh forkserver, so they hold no copy of this
    # process's device state; the probe stops the server when done.
    if "workers" not in args.skip:
        ms, rec = probe_workers(args.iters)
        measured["loader_scans_per_sec_by_workers"] = ms
        recommended.update(rec)
        print(f"workers: {ms} -> {rec}", flush=True)

    cuda = torch.cuda.is_available()
    print(f"autotune: backend={'cuda' if cuda else 'none'} "
          f"devices={torch.cuda.device_count()}"
          + (f" ({torch.cuda.get_device_name(0)})" if cuda else "")
          + f" iters={args.iters}", flush=True)

    if "donation" not in args.skip:
        print(f"donation: {DONATION_NOTE}", flush=True)

    if {"host_topology", "prefetch"} <= set(args.skip):
        print(json.dumps({"measured": measured, "recommended": recommended}))
        return 0

    from ..flagship import flagship_task

    task = flagship_task()  # the CUDA device; raises where there is none
    task.init_params(torch.Generator().manual_seed(0))
    hosts = host_batches()
    devs = [b.to(task.device) for b in hosts]

    if "host_topology" not in args.skip:
        ms, rec = probe_host_topology(task, hosts, devs, args.iters)
        measured["fwd_ms_by_topology"] = {k: round(v, 1) for k, v in ms.items()}
        recommended.update(rec)
        print(f"host_topology: {measured['fwd_ms_by_topology']} -> {rec}",
              flush=True)

    if "prefetch" not in args.skip:
        ms, rec = probe_prefetch(task, hosts, args.iters)
        measured["fit_step_ms_by_prefetch"] = {
            k: round(v, 1) for k, v in ms.items()}
        recommended.update(rec)
        print(f"prefetch: {measured['fit_step_ms_by_prefetch']} -> {rec}",
              flush=True)

    print(json.dumps({"measured": measured, "recommended": recommended}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
