"""Smoke run of the PyTorch port (mm2d3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from mm2d3d_tpu_torch/csrc, holds each
against its plain PyTorch version at the flagship shapes, drives the eval
slice (flagship configuration, bf16, batch 8) through the launch-counted
kernels, and compares the card's fp32 forward with the CPU's.  Prints, in
its last lines, the card (nvidia-smi name and power limit), one JSON line of
kernel results, and one JSON line {"ok": true, "device": {...}}.  Any failed
phase raises, and the script exits non-zero without the final line; it also
refuses to run without a CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 8
FLAGSHIP_BATCH = dict(height=225, width=400, n_points=8192, num_classes=6,
                      full_scale=4096)
K1_REL_TOL = 1e-4  # max |kernel - plain| <= 1e-4 * max |plain|
LOGIT_REL_TOL = 1e-3  # card vs CPU, fp32 forward
TIE_GAP = 1e-3
SLEEP_CYCLES = 100_000_000  # ~50-300 ms of SM clock: longer than the queued calls' dispatch


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of fn(), by CUDA events around `reps` calls,
    median of 3 samples.  The calls are queued behind a sleep kernel, so
    the host's dispatch between them is hidden and the events time the
    device's work alone (a call that synchronises still waits its turn)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def flagship_batch(seed: int, batch_size: int, device):
    from mm2d3d_tpu_torch.data.synthetic import make_batch

    return make_batch(np.random.RandomState(seed), batch_size=batch_size,
                      **FLAGSHIP_BATCH).to(device)


# --------------------------------------------------------------------------
# phase 1-2: environment and build
# --------------------------------------------------------------------------

def environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    from mm2d3d_tpu_torch.ops.kernels import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def build() -> float:
    from mm2d3d_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    dt = time.perf_counter() - t0
    for k in kernels.all_kernels().values():
        with open(k.build_log) as f:
            usage = [ln.split(":", 1)[-1].strip() for ln in f
                     if "registers" in ln or "spill" in ln]
        log(f"built {k.name}: " + " | ".join(usage))
    log(f"kernel build: {dt:.1f} s")
    return dt


# --------------------------------------------------------------------------
# phase 3: each kernel vs its plain version at flagship shapes
# --------------------------------------------------------------------------

class Results:
    def __init__(self):
        self.cases = []  # (kernel, case, max_abs_err, tol, ms, plain_ms)

    def add(self, kernel, case, err, tol, ms, plain_ms):
        self.cases.append((kernel, case, err, tol, ms, plain_ms))
        log(f"  {kernel:9s} {case:42s} max|d|={err:.3e} (tol {tol:.1e})  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"{kernel} {case}: max|d| {err} > {tol}")

    def max_err(self, kernel):
        return max(c[2] for c in self.cases if c[0] == kernel)


def check_k3(res: Results, dev) -> None:
    """K3 at levels 0-5 of a batch-8 flagship topology: bit-identical."""
    from mm2d3d_tpu_torch.ops import hierarchy as H
    from mm2d3d_tpu_torch.ops.kernels.propagate import propagate_slots, propagate_slots_ref
    from mm2d3d_tpu_torch.ops.voxelize import voxelize
    from mm2d3d_tpu_torch.train.batch import default_capacities, default_slot_caps, flatten_points

    batch = flagship_batch(0, BATCH, dev)
    coords, _, _, mask, bidx = flatten_points(batch)
    levels = 7
    caps = default_capacities(coords.shape[0], levels, batch_size=BATCH)
    specs = default_slot_caps(levels, caps)
    grids = [voxelize(coords, bidx, mask, 4096, capacity=caps[0], presorted=True)]
    trans = []
    for l in range(1, levels):
        g, t = H._coarsen_grid(grids[-1], capacity=caps[l])
        grids.append(g)
        trans.append(t)
    nbr = H.build_nbr(grids[-1], BATCH)
    for l in range(levels - 2, -1, -1):
        crows = H._propagate_candidates(grids[l], trans[l], nbr)
        par = (grids[l].coords & 1).T.contiguous().to(torch.int32)
        valid = grids[l].valid.to(torch.int32)[None]
        h1 = specs[l][0]
        out = propagate_slots(crows, par, valid, h1)
        ref = propagate_slots_ref(crows, par, valid, h1)
        for a, b in zip(out, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"K3 level {l}: kernel != plain version")
        ms = cuda_ms(lambda: propagate_slots(crows, par, valid, h1))
        plain = cuda_ms(lambda: propagate_slots_ref(crows, par, valid, h1), reps=10)
        res.add("propagate", f"L{l} V={crows.shape[2]} h1={h1}", 0.0, 0.0, ms, plain)
        nbr = out[0]


def check_k4(res: Results, dev) -> None:
    """K4 on the stem output shape, fp32 and bf16, plus odd shapes: exact."""
    from mm2d3d_tpu_torch.ops.kernels.maxpool import maxpool3x3s2, maxpool3x3s2_ref

    g = torch.Generator(device=dev).manual_seed(4)
    for shape in ((BATCH, 240, 400, 64), (3, 33, 47, 64), (2, 17, 10, 64)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.relu(torch.randn(shape, generator=g, device=dev)).to(dt)
            out, ref = maxpool3x3s2(x), maxpool3x3s2_ref(x)
            if out.shape != ref.shape or not torch.equal(out, ref):
                raise AssertionError(f"K4 {shape} {dt}: kernel != plain version")
            ms = cuda_ms(lambda: maxpool3x3s2(x))
            plain = cuda_ms(lambda: maxpool3x3s2_ref(x))
            res.add("maxpool", f"{tuple(shape)} {str(dt)[6:]}", 0.0, 0.0, ms, plain)


def check_k1(res: Results, dev) -> None:
    """K1, bf16 and fp32, for every call form the slice makes at level 0,
    and at level 5 for the widest ones: the deepest decoder's concat
    (Ci = 2 x 96) in each of its tiers and the strided conv down to L6."""
    from mm2d3d_tpu_torch.ops.kernels.bandmm import slot_conv_apply, slot_conv_apply_ref
    from mm2d3d_tpu_torch.train.batch import build_topology

    _, hier = build_topology(flagship_batch(0, BATCH, dev), 4096, 7)
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def subm_forms(l, ci, co, name, every_tier):
        lev = hier.levels[l]
        v = lev.capacity
        x = torch.cat([rnd(v, ci), torch.zeros((1, ci), device=dev)])
        w = rnd(27, ci, co) * 0.1
        xm = torch.where(lev.valid[:, None], x[:v], 0)
        forms = [(f"{name} tier1+center H={lev.slot_src.shape[0]}",
                  (xm, x[lev.slot_src.long()], lev.slot_tap, w))]
        if every_tier and lev.slot_srcm is not None:
            forms.append((f"{name} mid tier H={lev.slot_srcm.shape[0]}",
                          (None, x[lev.slot_srcm.long()], lev.slot_tapm, w)))
        if every_tier and lev.slot_src2 is not None:
            forms.append((f"{name} heavy tier H={lev.slot_src2.shape[0]}",
                          (None, x[lev.slot_src2.long()], lev.slot_tap2, w)))
        return forms

    def strided_form(l, ci, co):
        off_id = hier.transitions[l].off_id
        return (f"down L{l}->L{l + 1} K=8 H=1 {ci}->{co}",
                (None, rnd(1, off_id.shape[0], ci), off_id[None].contiguous(),
                 rnd(8, ci, co) * 0.1))

    forms = (subm_forms(0, 3, 16, "input conv Ci=3", False)
             + subm_forms(0, 16, 16, "enc L0", True)
             + subm_forms(0, 32, 16, "dec L0 (concat)", False)
             + [strided_form(0, 16, 32)]
             + subm_forms(5, 192, 96, "dec L5 (concat)", True)
             + [strided_form(5, 96, 112)])
    for dt in (torch.bfloat16, torch.float32):
        for name, (xm, xs, tap, w) in forms:
            args = (None if xm is None else xm.to(dt).contiguous(),
                    xs.to(dt).contiguous(), tap, w.to(dt).contiguous())
            out = slot_conv_apply(*args)
            ref = slot_conv_apply_ref(*args)
            err = float((out - ref).abs().max())
            tol = K1_REL_TOL * float(ref.abs().max())
            ms = cuda_ms(lambda: slot_conv_apply(*args))
            plain = cuda_ms(lambda: slot_conv_apply_ref(*args), reps=10)
            res.add("bandmm", f"{name} {str(dt)[6:]} V={xs.shape[1]}", err, tol,
                    ms, plain)


# --------------------------------------------------------------------------
# phase 4: the slice, bf16, batch 8, through the counted kernels
# --------------------------------------------------------------------------

def tiers(level) -> int:
    return 3 if level.slot_srcm is not None else (2 if level.slot_src2 is not None else 1)


def expected_launches(hier) -> dict:
    """Kernel launches of one forward, from the hierarchy: K3 at every level
    but the coarsest, K4 once per encoder, K1 once per tier of every
    submanifold conv (input conv, encoder and decoder blocks) plus once per
    strided conv."""
    lv = hier.levels
    n = len(lv)
    k1 = tiers(lv[0]) + sum(tiers(l) for l in lv) + sum(tiers(l) for l in lv[:-1])
    return {"propagate": n - 1, "maxpool": 2, "bandmm": k1 + 2 * (n - 1)}


def run_slice(dev):
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.train.batch import build_topology

    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    batches = [flagship_batch(s, BATCH, dev) for s in range(4)]
    task.eval_step(batches[0])  # warm-up: first launches, cuDNN plans
    torch.cuda.synchronize()

    kernels.reset_counts()
    results = [(task.eval_step(b), task.forward(b)) for b in batches]
    torch.cuda.synchronize()
    launches = kernels.counts()

    per_forward = None
    for (metrics, logs), fwd in results:
        for name, t in list(logs.items()) + list(fwd.items()):
            if not torch.isfinite(t).all():
                raise AssertionError(f"non-finite {name}")
        if float(logs["nbr_slot_overflow"]) != 0:
            raise AssertionError(f"slot overflow {float(logs['nbr_slot_overflow'])}")
        rowsum = fwd["ensemble"].sum(-1)
        if float((rowsum - 1).abs().max()) > 1e-3:
            raise AssertionError("ensemble rows do not sum to 1")
        if fwd["seg_logit_2d"].shape != (BATCH, 8192, 6) or \
                fwd["seg_logit_3d"].shape != (BATCH * 8192, 6):
            raise AssertionError("unexpected output shapes")
        if int(metrics.cm_avg.sum()) <= 0:
            raise AssertionError("empty confusion matrix")
    for b in batches:
        _, hier = build_topology(b, 4096, 7)
        for l, lev in enumerate(hier.levels):
            if int(lev.num_voxels) >= lev.capacity:
                raise AssertionError(f"level {l} at capacity {lev.capacity}")
        exp = expected_launches(hier)
        per_forward = exp if per_forward is None else per_forward
    runs = 2 * len(batches)  # eval_step + forward per batch
    for name, n in per_forward.items():
        if launches[name] != runs * n:
            raise AssertionError(
                f"{name}: {launches[name]} launches, expected {runs} x {n}")
    log(f"launch counts over {runs} forwards: {launches} "
        f"(per forward {per_forward})")

    # steady-state throughput of the fused forward (topology included)
    for b in batches:
        task.forward(b)
    torch.cuda.synchronize()
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(3):
            for b in batches:
                out = task.forward(b)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / 12)
    ms = statistics.median(samples) * 1e3
    log(f"slice bf16 batch {BATCH}: {ms:.2f} ms/batch (median of 3 x 12, "
        f"band {min(samples) * 1e3:.2f}-{max(samples) * 1e3:.2f}), "
        f"{BATCH * 1e3 / ms:.1f} scans/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out
    return launches, ms


# --------------------------------------------------------------------------
# phase 5: card vs CPU, fp32, batch 2
# --------------------------------------------------------------------------

def compare_card_cpu(dev) -> None:
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.train.batch import build_topology

    tasks = {}
    for d in (dev, torch.device("cpu")):
        t = flagship_task(compute_dtype=torch.float32, device=d)
        t.init_params(torch.Generator().manual_seed(1))
        tasks[d.type] = t
    batch = flagship_batch(5, 2, "cpu")

    (g_gpu, h_gpu) = build_topology(batch.to(dev), 4096, 7)
    (g_cpu, h_cpu) = build_topology(batch, 4096, 7)
    n_tables = 0
    for a, b in [(g_gpu, g_cpu)] + list(zip(h_gpu.levels, h_cpu.levels)) + \
            list(zip(h_gpu.transitions, h_cpu.transitions)):
        for name, x in vars(a).items():
            if isinstance(x, torch.Tensor):
                if not torch.equal(x.cpu(), getattr(b, name)):
                    raise AssertionError(f"topology table {name} differs")
                n_tables += 1
    log(f"card vs CPU: {n_tables} topology tables identical")

    t0 = time.perf_counter()
    out_gpu = tasks["cuda"].forward(batch.to(dev))
    m_gpu, logs_gpu = tasks["cuda"].eval_step(batch.to(dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_cpu = tasks["cpu"].forward(batch)
    m_cpu, logs_cpu = tasks["cpu"].eval_step(batch)
    log(f"fp32 batch 2: card {t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s "
        "(host clock, first calls)")
    for name in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        a, b = out_gpu[name].cpu(), out_cpu[name]
        err = float((a - b).abs().max())
        tol = LOGIT_REL_TOL * float(b.abs().max())
        log(f"  {name}: max|card - CPU| = {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name}: card vs CPU {err} > {tol}")
    labels = batch.seg_label.reshape(-1)
    mask = batch.point_mask.reshape(-1)
    ties = torch.zeros_like(mask)
    for name in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        for o in (out_gpu[name].cpu(), out_cpu[name]):
            top2 = o.reshape(-1, 6).topk(2, -1).values
            ties |= (top2[:, 0] - top2[:, 1]) < TIE_GAP
    keep = mask & ~ties
    from mm2d3d_tpu_torch.train.metrics import confusion_matrix_update

    for name, key in (("cm_2d", "seg_logit_2d"), ("cm_3d", "seg_logit_3d"),
                      ("cm_avg", "ensemble")):
        zero = torch.zeros((6, 6), dtype=torch.int32)
        a = confusion_matrix_update(zero, out_gpu[key].cpu().reshape(-1, 6).argmax(-1),
                                    labels, keep)
        b = confusion_matrix_update(zero, out_cpu[key].reshape(-1, 6).argmax(-1),
                                    labels, keep)
        if not torch.equal(a, b):
            raise AssertionError(f"{name} differs off the near-ties")
        if not (ties & mask).any() and not torch.equal(
                getattr(m_gpu, name).cpu(), getattr(m_cpu, name)):
            raise AssertionError(f"{name} from eval_step differs")
    for name in ("loss_segmentation", "loss_segmentation_3d", "valid_weight"):
        a, b = float(logs_gpu[name]), float(logs_cpu[name])
        if abs(a - b) > 1e-3 * abs(b):
            raise AssertionError(f"{name}: card {a} vs CPU {b}")
    log(f"card vs CPU: confusion matrices equal ({int(ties[mask].sum())} "
        "near-tie points left out), losses agree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = environment()
    build()

    res = Results()
    log("phase 3: kernels vs plain versions (CUDA events, device time per call)")
    check_k3(res, dev)
    check_k4(res, dev)
    check_k1(res, dev)

    log("phase 4: slice, bf16, batch 8")
    launches, slice_ms = run_slice(dev)

    log("phase 5: card vs CPU, fp32, batch 2")
    compare_card_cpu(dev)

    from mm2d3d_tpu_torch.ops import kernels

    main_case = {"propagate": "L0 ", "maxpool": f"({BATCH}, 240, 400, 64) float32",
                 "bandmm": "enc L0 tier1+center H=3 bfloat16"}
    rows = []
    for name, k in kernels.all_kernels().items():
        case = next(c for c in res.cases if c[0] == name and c[1].startswith(main_case[name]))
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": res.max_err(name), "ms": case[4], "plain_ms": case[5],
        })
    log(f"slice: {slice_ms:.2f} ms/batch of {BATCH}, {BATCH * 1e3 / slice_ms:.1f} scans/s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
