"""Where the time of the flagship eval forward and train step goes, on one
NVIDIA GPU.

    python -m mm2d3d_tpu_torch.tools.profile_forward [--optin]

Two stage tables.  The eval forward: topology build, 2D branch, 3D branch,
the whole fused forward over four rotating batches.  The train step (batch
8 per domain, seeds 10 and 11): both topologies, both branches' forwards on
both domains with the losses, the same plus the backward, the two optimizer
steps, and the whole `train_step`.  For each stage it prints, per call: the
host time until the calls return and the wall time until the device is done
(host clock, no profiler, all taken before the profiler first runs), the
device's busy time from a `torch.profiler` trace (the union of kernel
intervals), the idle share (1 - busy / wall), the kernel count, the
host-device synchronisations (CUDA sync debug mode), the kernel time by
kind, and the largest kernels by name.  Weights are random (seeded), bf16
compute, batches from `data.synthetic.make_batch`.  With `--optin` the
same tables for the opt-in path: the fused 2D head (K5) and topologies
without slot tables (`slot_caps=None`, the dense 27-tap convs through K6),
handed to the task as `topo=` / `topo_src=`, `topo_trg=`.  Refuses to run
without a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..data.synthetic import make_batch
from ..flagship import flagship_task
from ..models.net2d import Net2DSeg
from ..train.batch import build_topology, flatten_points, prepare_device_batch
from ..utils.profiling import count_syncs

BATCH = 8
REPS = 8  # calls per sample
TRAIN_REPS = 3  # train calls per sample
TOP_KERNELS = 5  # kernels listed by name per stage

SMI = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
       "--format=csv,noheader"]

# kernel-name fragment -> kind, first match wins
KINDS = (
    ("multi_tensor_apply", "optimizer"), ("bandmm_mma_kernel", "K1 bandmm"),
    ("bandmm_reduce_kernel", "K1 bandmm"), ("apply_kernel", "K1 bandmm"),
    ("dw_mma_kernel", "K2 bandmm_dw"), ("dw_partial_kernel", "K2 bandmm_dw"),
    ("dw_reduce_kernel", "K2 bandmm_dw"),
    ("propagate_kernel", "K3 propagate"),
    ("maxpool_", "K4 maxpool"), ("head_conv_", "K5 head2d"),
    ("head_box_kernel", "K5 head2d"), ("tapsum_", "K6 tapsum"),
    ("bn_fw", "cuDNN batch norm"),
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


def device_profile(fn, n: int):
    """(busy ms per call, kernels per call, {kind: ms per call}, {kernel
    name: ms per call}) from a torch.profiler trace of n calls."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # device kernels and copies; not the device-side ranges of user
    # annotations such as "Optimizer.step#AdamW.step", which span kernels
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in evs]) / 1e3 / n
    by_kind, by_name = {}, {}
    for e in evs:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / n
        by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    return busy, len(evs) / n, by_kind, by_name


def report(stages, reps: int, profiled: int = 0) -> dict:
    """One stage table: every clock reading (`reps` calls a sample) before
    the profiler first runs over `profiled` calls (`reps` if 0) -> {stage:
    its numbers per call}."""
    times = {tag: time_stage(fn, reps) for tag, fn in stages.items()}
    out = {}
    for tag, fn in stages.items():
        host, wall = times[tag]
        busy, n_kernels, by_kind, by_name = device_profile(fn, profiled or reps)
        syncs = count_syncs(fn)
        print(f"{tag}: host {host:.3f} ms, wall {wall:.3f} ms (no profiler), "
              f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.2%}, "
              f"{n_kernels:.0f} kernels, {syncs} host syncs")
        for k, t in sorted(by_kind.items(), key=lambda x: -x[1]):
            print(f"    {k:22s} {t:8.3f} ms")
        top = sorted(by_name.items(), key=lambda x: -x[1])[:TOP_KERNELS]
        print("    largest kernels: " + "; ".join(f"{t:.3f} ms {n[:90]}" for n, t in top))
        out[tag] = {"host_ms": host, "wall_ms": wall, "device_busy_ms": busy,
                    "idle_share": 1 - busy / wall, "kernels": n_kernels,
                    "host_syncs": syncs, "device_ms_by_kind": by_kind}
    return out


def train_stages(task, dev, slot_caps):
    src, trg = (make_batch(np.random.RandomState(s), batch_size=BATCH,
                           height=225, width=400, n_points=8192).to(dev)
                for s in (10, 11))
    gen = torch.Generator(device=dev).manual_seed(0)

    def topos():
        with torch.no_grad():
            return tuple(build_topology(b, task.full_scale, task.num_planes,
                                        slot_caps=slot_caps) for b in (src, trg))

    inputs = task.train_inputs(src, trg, *topos())
    task.train_step(src, trg, gen, *topos())  # optimizer state, gradients in place

    def optimizers():
        task.opt2d.step()
        task.opt3d.step()

    return {
        "train: topology x2": topos,
        "train: forwards + losses": lambda: task.train_losses(*inputs, gen),
        "train: forwards + backward": lambda: task.train_losses(*inputs, gen)[0].backward(),
        "train: optimizer steps": optimizers,
        "train step (all)": lambda: task.train_step(src, trg, gen, *topos()),
    }


def main(argv=None) -> int:
    optin = "--optin" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(SMI, capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    slot_caps = None if optin else "default"
    over = {"model2d": Net2DSeg(6, torch.bfloat16, fused_head=True)} if optin else {}
    print("path: " + ("opt-in (fused head, dense 27-tap convs)" if optin else "default"))
    task = flagship_task(device=dev, **over)
    task.init_params(torch.Generator().manual_seed(0))
    batches = [make_batch(np.random.RandomState(s), batch_size=BATCH,
                          height=225, width=400, n_points=8192).to(dev)
               for s in range(4)]
    with torch.inference_mode():
        b = prepare_device_batch(batches[0])

        def topology(x):
            return build_topology(x, task.full_scale, task.num_planes,
                                  slot_caps=slot_caps)

        topo = topology(b)
        _, feats, _, _, _ = flatten_points(b)
        it = iter(range(1 << 30))

        def forward():
            x = batches[next(it) % 4]
            return task.forward(x, topo=topology(x))

        stages = {
            "topology": lambda: topology(b),
            "2D branch": lambda: task.model2d(b.img, b.depth, b.img_indices,
                                              b.point_mask, with_features=False),
            "3D branch": lambda: task.model3d(feats, *topo),
            "forward (4 batches rotating)": forward,
        }
        report(stages, REPS)
    report(train_stages(task, dev, slot_caps), TRAIN_REPS)
    print(subprocess.run(SMI, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
