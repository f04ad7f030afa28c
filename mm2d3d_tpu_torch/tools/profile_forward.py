"""Where the time of the flagship eval forward goes, on one NVIDIA GPU.

    python -m mm2d3d_tpu_torch.tools.profile_forward

For each stage (topology build, 2D branch, 3D branch, the whole fused
forward over four rotating batches) prints, per call: the host time until
the calls return and the wall time until the device is done (host clock, no
profiler, all taken before the profiler first runs), the device's busy
time from a `torch.profiler` trace (the union of kernel intervals), the idle
share (1 - busy / wall), the kernel count, the host-device synchronisations
(CUDA sync debug mode), and the kernel time by kind.  Weights are random
(seeded), bf16 compute, batch 8 from `data.synthetic.make_batch` seeds 0-3.
Refuses to run without a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..data.synthetic import make_batch
from ..flagship import flagship_task
from ..train.batch import build_topology, flatten_points, prepare_device_batch

BATCH = 8
REPS = 8  # calls per sample

SMI = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
       "--format=csv,noheader"]

# kernel-name fragment -> kind, first match wins
KINDS = (
    ("apply_kernel", "K1 bandmm"), ("propagate_kernel", "K3 propagate"),
    ("maxpool_", "K4 maxpool"), ("bn_fw", "cuDNN batch norm"),
    ("xmma", "cuDNN/cutlass conv"), ("cutlass", "cuDNN/cutlass conv"),
    ("conv", "cuDNN/cutlass conv"), ("gemm", "GEMM"),
    ("gather", "gather/index"), ("index", "gather/index"),
    ("scatter", "scatter"), ("copy", "copy/cast"), ("cat", "cat"),
    ("reduce", "reductions"), ("scan", "cumsum/scan"), ("sort", "sort"),
    ("elementwise", "elementwise"),
)


def kind(name: str) -> str:
    n = name.lower()
    return next((k for frag, k in KINDS if frag in n), "other")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def time_stage(fn, n: int):
    """(host ms, wall ms) per call, medians of 3 samples of n calls: host =
    until the calls return (the enqueue), wall = until the device is done."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3 / n)
        wall.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(host), statistics.median(wall)


def count_syncs(fn) -> int:
    """Host-device synchronisations one call makes (CUDA sync debug mode)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_profile(fn, n: int):
    """(busy ms per call, kernels per call, {kind: ms per call}) from a
    torch.profiler trace of n calls."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in evs]) / 1e3 / n
    by_kind = {}
    for e in evs:
        k = kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / n
    return busy, len(evs) / n, by_kind


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(SMI, capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    batches = [make_batch(np.random.RandomState(s), batch_size=BATCH,
                          height=225, width=400, n_points=8192).to(dev)
               for s in range(4)]
    with torch.inference_mode():
        b = prepare_device_batch(batches[0])
        topo = build_topology(b, task.full_scale, task.num_planes)
        _, feats, _, _, _ = flatten_points(b)
        it = iter(range(1 << 30))
        stages = {
            "topology": lambda: build_topology(b, task.full_scale, task.num_planes),
            "2D branch": lambda: task.model2d(b.img, b.depth, b.img_indices,
                                              b.point_mask),
            "3D branch": lambda: task.model3d(feats, *topo),
            "forward (4 batches rotating)":
                lambda: task.forward(batches[next(it) % 4]),
        }
        # every clock reading before the profiler first runs
        times = {tag: time_stage(fn, REPS) for tag, fn in stages.items()}
        for tag, fn in stages.items():
            host, wall = times[tag]
            busy, n_kernels, by_kind = device_profile(fn, REPS)
            print(f"{tag}: host {host:.3f} ms, wall {wall:.3f} ms (no profiler), "
                  f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.2%}, "
                  f"{n_kernels:.0f} kernels, {count_syncs(fn)} host syncs")
            for k, t in sorted(by_kind.items(), key=lambda x: -x[1]):
                print(f"    {k:22s} {t:8.3f} ms")
    print(subprocess.run(SMI, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
