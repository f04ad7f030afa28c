"""Smoke run of the PyTorch port (mm2d3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from mm2d3d_tpu_torch/csrc, holds each
against its plain PyTorch version at the flagship shapes and times it beside
its bound and, where one exists, a single PyTorch call that computes the same
function (phase 3), drives the eval slice (flagship configuration, bf16,
batch 8) through the launch-counted kernels (phase 4), compares the card's
fp32 forward with the CPU's (phase 5), drives the train slice (bf16, batch 8
per domain: launch counts, timing, a 12-step loss trajectory; phase 6), and
compares the card's fp32 train step with the CPU's (phase 7).  Phase 8
drives the opt-in path (the fused 2D head, K5, and the dense 27-tap sparse
convolutions, K6, through topologies built with `slot_caps=None`) for eval
and training at the same sizes, and phase 9 holds it, card against CPU, in
fp32.  Prints, in its last lines, the card (nvidia-smi name and power
limit), one JSON line of kernel results, and one JSON line
{"ok": true, "device": {...}}.  Any failed phase raises, and
the script exits non-zero without the final line; it also refuses to run
without a CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from mm2d3d_tpu_torch.tools.kernel_cases import BATCH, cuda_ms, flagship_batch

# cuBLAS's reproducible workspace, for the deterministic phases 7 and 9
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

K1_REL_TOL = 1e-4  # max |kernel - plain| <= 1e-4 * max |plain| (K1, K2, K5, K6)
LOGIT_REL_TOL = 1e-3  # card vs CPU, fp32 forward and train step
TIE_GAP = 1e-3
COMPARE_BATCH = 2  # scans per domain of phase 7's card-vs-CPU train step
# H100 SXM data sheet (dense): HBM bytes/s, peak FLOP/s by input type (fp32
# outside the tensor cores; TF32 is off in this script)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


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

def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: int, flops: float = 0.0, dtype=torch.float32):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the HBM rate and the operations over the
    peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Results:
    def __init__(self):
        # (kernel, case, max_abs_err, tol, ms, plain_ms, bound_ms, bound_by,
        #  library_ms)
        self.cases = []

    def add(self, kernel, case, err, tol, ms, plain_ms, bnd, library_ms=None):
        self.cases.append((kernel, case, err, tol, ms, plain_ms, *bnd, library_ms))
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"  {kernel:9s} {case:52s} max|d|={err:.3e} (tol {tol:.1e})  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bnd[0]:.4f} ms "
            f"({bnd[1]})  library {lib}")
        if not err <= tol:
            raise AssertionError(f"{kernel} {case}: max|d| {err} > {tol}")

    def max_err(self, kernel):
        return max(c[2] for c in self.cases if c[0] == kernel)

    def slowest_vs_library(self, kernel):
        """{"case", "ms", "library_ms"} of the kernel's case with the largest
        ratio of its time to the library call's, or None without a library
        call."""
        cases = [c for c in self.cases if c[0] == kernel and c[8] is not None]
        if not cases:
            return None
        c = max(cases, key=lambda c: c[4] / c[8])
        return {"case": c[1], "ms": c[4], "library_ms": c[8]}


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
        res.add("propagate", f"L{l} V={crows.shape[2]} h1={h1}", 0.0, 0.0, ms, plain,
                bound(nbytes(crows, par, valid, *out)))
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
            # one call of the same function (its output NCHW, channels_last)
            library = cuda_ms(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1))
            res.add("maxpool", f"{tuple(shape)} {str(dt)[6:]}", 0.0, 0.0, ms, plain,
                    bound(nbytes(x, out)), library)


def slot_route(dt, ci, h, k) -> str:
    from mm2d3d_tpu_torch.ops.kernels.bandmm import slot_tensor_cores

    return "tensor cores" if slot_tensor_cores(dt, ci, h, k) else "CUDA cores"


def slot_bound(xm, x_src, tap, other, out, k, dt):
    """K1's and K2's bound at this data: the bytes of the slot rows that
    hold a tap (an empty slot feeds no band and is never read), of xm,
    tap, the weight (K1) or output gradient (K2) and the output, each once;
    and the products of those rows."""
    ci, co = x_src.shape[2], out.shape[-1]
    filled = int(((tap >= 0) & (tap < k)).sum())
    rows = filled + (0 if xm is None else xm.shape[0])
    n_bytes = nbytes(xm, tap, other, out) + filled * ci * x_src.element_size()
    return bound(n_bytes, 2 * rows * ci * co, dt)


def check_k1(res: Results, dev) -> None:
    """K1, bf16 and fp32, for every call form the slice makes at level 0
    (the input conv's adjoint, Ci = 16 -> Co = 3, included), at level 5 for
    the widest ones (the deepest decoder's concat, Ci = 2 x 96, in each of
    its tiers; the strided conv down to L6, the up conv to L4), and at the
    tensor-core kernel's edges (ragged V, two column blocks, H = 20 and 26,
    a tile of misses, duplicate taps and tap 13 beside the centre, split
    shapes).  Each form runs twice and must give the same bits; each case
    names its route."""
    from mm2d3d_tpu_torch.ops.kernels.bandmm import slot_conv_apply, slot_conv_apply_ref
    from mm2d3d_tpu_torch.tools.kernel_cases import edge_forms, k1_forms

    forms = k1_forms(dev) + [(name, args[:4]) for name, args, _ in edge_forms(dev)]
    for dt in (torch.bfloat16, torch.float32):
        for name, (xm, xs, tap, w) in forms:
            args = (None if xm is None else xm.to(dt).contiguous(),
                    xs.to(dt).contiguous(), tap, w.to(dt).contiguous())
            out, again = slot_conv_apply(*args), slot_conv_apply(*args)
            if not torch.equal(out, again):
                raise AssertionError(f"K1 {name} {dt}: two calls differ")
            ref = slot_conv_apply_ref(*args)
            err = float((out - ref).abs().max())
            tol = K1_REL_TOL * float(ref.abs().max())
            ms = cuda_ms(lambda: slot_conv_apply(*args))
            plain = cuda_ms(lambda: slot_conv_apply_ref(*args), reps=10)
            k, ci, _ = w.shape
            route = slot_route(dt, ci, xs.shape[0], k)
            res.add("bandmm", f"{name} {str(dt)[6:]} V={xs.shape[1]} [{route}]", err,
                    tol, ms, plain, slot_bound(*args, out, k, dt))


def check_k2(res: Results, dev) -> None:
    """K2, bf16 and fp32, for every call form the train step makes: at level
    0 the input conv, the encoder's three tiers and the decoder concat; the
    strided conv L0 -> L1; at level 5 the decoder concat in each tier; the
    strided conv L5 -> L6 and the up conv L5 -> L4; and the tensor-core
    kernel's edges.  The mid and heavy tiers take the gradient at their
    compacted rows, as the adjoint does.  Each form runs twice and must give
    the same bits; each case names its route."""
    from mm2d3d_tpu_torch.ops.kernels.bandmm_dw import slot_conv_dw, slot_conv_dw_ref
    from mm2d3d_tpu_torch.tools.kernel_cases import edge_forms, k2_forms

    forms = k2_forms(dev) + [(name, (xm, xs, tap, g), k)
                             for name, (xm, xs, tap, _, g), k in edge_forms(dev)]
    for dt in (torch.bfloat16, torch.float32):
        for name, (xm, xs, tap, g), k in forms:
            args = (None if xm is None else xm.to(dt).contiguous(),
                    xs.to(dt).contiguous(), tap, g.to(dt).contiguous())
            out = slot_conv_dw(*args, k_taps=k)
            again = slot_conv_dw(*args, k_taps=k)
            if not torch.equal(out, again):
                raise AssertionError(f"K2 {name} {dt}: two calls differ")
            ref = slot_conv_dw_ref(*args, k_taps=k)
            err = float((out - ref).abs().max())
            tol = K1_REL_TOL * float(ref.abs().max())
            ms = cuda_ms(lambda: slot_conv_dw(*args, k_taps=k))
            plain = cuda_ms(lambda: slot_conv_dw_ref(*args, k_taps=k), reps=10)
            route = slot_route(dt, xs.shape[2], xs.shape[0], k)
            res.add("bandmm_dw", f"{name} {str(dt)[6:]} V={xs.shape[1]} [{route}]", err,
                    tol, ms, plain, slot_bound(*args, out, k, dt))


def dense_topology(batch):
    """The flagship topology without slot tables: every submanifold conv
    on the dense 27-tap path (K6)."""
    from mm2d3d_tpu_torch.train.batch import build_topology

    with torch.no_grad():
        return build_topology(batch, 4096, 7, slot_caps=None)


def dense_shapes():
    """(name, level, Ci, Co) of the dense path's 28 contractions: the 14
    submanifold convs of the flagship forward (input conv, 7 encoder and 6
    decoder blocks, m = 16) and their input gradients, which contract the
    flipped weights (Ci and Co swapped)."""
    m, n = 16, 7
    fwd = ([("input conv", 0, 3, m)]
           + [(f"enc L{l}", l, m * (l + 1), m * (l + 1)) for l in range(n)]
           + [(f"dec L{l} (concat)", l, 2 * m * (l + 1), m * (l + 1))
              for l in range(n - 1)])
    return ([(f"{name} fwd", l, ci, co) for name, l, ci, co in fwd]
            + [(f"{name} adjoint", l, co, ci) for name, l, ci, co in fwd])


def check_k6(res: Results, dev) -> None:
    """K6, bf16 and fp32, at the 28 shapes of the dense path at batch 8:
    the neighbourhoods of random features gathered by a batch-8 flagship
    topology's own tables (so missing taps are the pad row's zeros).  Two
    calls must give the same bits (the split-K partials are summed in a
    fixed order)."""
    from mm2d3d_tpu_torch.ops.kernels.tapsum import tapsum, tapsum_plan, tapsum_ref

    _, hier = dense_topology(flagship_batch(0, BATCH, dev))
    gen = torch.Generator(device=dev).manual_seed(6)
    for name, l, ci, co in dense_shapes():
        lev = hier.levels[l]
        x = torch.randn((lev.capacity, ci), generator=gen, device=dev)
        x = torch.cat([x, x.new_zeros((1, ci))])[lev.nbr.long()]  # (27, V, Ci)
        w = 0.1 * torch.randn((27, ci, co), generator=gen, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            g, wd = x.to(dt), w.to(dt)
            out, again, ref = tapsum(g, wd), tapsum(g, wd), tapsum_ref(g, wd)
            if not torch.equal(out, again):
                raise AssertionError(f"K6 {name} {dt}: two calls differ")
            err = float((out - ref).abs().max())
            tol = K1_REL_TOL * float(ref.abs().max())
            ms = cuda_ms(lambda: tapsum(g, wd))
            plain = cuda_ms(lambda: tapsum_ref(g, wd), reps=10)
            library = cuda_ms(lambda: torch.einsum("kvi,kio->vo", g, wd), reps=10)
            flops = 2 * g.shape[0] * g.shape[1] * ci * co
            plan = tapsum_plan(*g.shape, co, dt)
            res.add("tapsum", f"{name} Ci={ci} Co={co} {str(dt)[6:]} V={g.shape[1]} "
                    f"S={plan.splits}", err, tol, ms, plain,
                    bound(nbytes(g, wd, out), flops, dt), library)
        del x, g, wd, out, again, ref


def check_k5(res: Results, dev) -> None:
    """K5 at the flagship head, batch 8: three fp32 (8, 240, 400, 64)
    pieces -> (8, 225, 400, 12), computed in bf16 (the pieces rounded as
    they load, as the main path runs it) and in fp32; and at the three
    boundary shapes of tests/test_pallas.py.  The yardstick is the port's
    unfused head: cuDNN's conv of the concatenated pieces, then avg_pool2d
    (two calls; the concat is made beforehand)."""
    from mm2d3d_tpu_torch.ops.kernels.head2d import head_pool, head_pool_ref, launch_passes

    gen = torch.Generator(device=dev).manual_seed(5)
    cases = ((f"({BATCH}, 240, 400, 64)x3", BATCH, 240, 400, 225, 400, (64, 64, 64), 12),
             ("odd crop (1, 48, 32)", 1, 48, 32, 37, 25, (8, 16, 8), 8),
             ("single strip (2, 16, 16)", 2, 16, 16, 16, 16, (8,), 8),
             ("past one strip (1, 32, 24)", 1, 32, 24, 17, 24, (16, 8), 16))
    for name, b, hp, wp, h, w, cins, c2 in cases:
        xs = [torch.relu(torch.randn((b, hp, wp, c), generator=gen, device=dev))
              for c in cins]
        w12 = 0.05 * torch.randn((3, 3, sum(cins), c2), generator=gen, device=dev)
        b12 = torch.randn((c2,), generator=gen, device=dev)
        for cd in (torch.bfloat16, torch.float32):
            out = head_pool(xs, w12, b12, h, w, cd)
            ref = head_pool_ref(xs, w12, b12, h, w, cd)
            err = float((out - ref).abs().max())
            tol = K1_REL_TOL * float(ref.abs().max())
            ms = cuda_ms(lambda: head_pool(xs, w12, b12, h, w, cd), reps=10)
            plain = cuda_ms(lambda: head_pool_ref(xs, w12, b12, h, w, cd), reps=5)
            x_cat = torch.cat([x.permute(0, 3, 1, 2) for x in xs], 1).to(cd)
            w_oihw = w12.to(cd).permute(3, 2, 0, 1).contiguous()

            def unfused():
                y = F.conv2d(x_cat, w_oihw, b12.to(cd), padding=1)
                return F.avg_pool2d(y[:, :, :h, :w].float().contiguous(), 5, 1, 2)

            library = cuda_ms(unfused, reps=10)
            del x_cat
            flops = 2 * b * h * w * 9 * sum(cins) * c2 + 25 * b * h * w * c2
            res.add("head2d", f"{name} {str(cd)[6:]}", err, tol, ms, plain,
                    bound(nbytes(*xs, w12, b12, out), flops, cd), library)
            # the two passes alone: the conv (+ bias, crop) into the fp32
            # scratch, and the 5x5 pool of the scratch
            y, _ = launch_passes(xs, w12, b12, h, w, cd, passes=1)
            conv_ms = cuda_ms(lambda: launch_passes(xs, w12, b12, h, w, cd, passes=1),
                              reps=10)
            pool_ms = cuda_ms(lambda: launch_passes(xs, w12, b12, h, w, cd, passes=2,
                                                    y=y), reps=10)
            log(f"  head2d    {name} {str(cd)[6:]}: pass 1 (conv) {conv_ms:.4f} ms, "
                f"pass 2 (pool) {pool_ms:.4f} ms")
            del y


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
    return {"propagate": n - 1, "maxpool": 2, "bandmm": k1 + 2 * (n - 1),
            "bandmm_dw": 0, "head2d": 0, "tapsum": 0}


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

def compare_topology(batch, dev, slot_caps="default") -> int:
    """Build the topology of a CPU batch on the card and on the CPU; every
    table must be identical.  Returns the number of tables."""
    from mm2d3d_tpu_torch.train.batch import build_topology

    (g_gpu, h_gpu) = build_topology(batch.to(dev), 4096, 7, slot_caps=slot_caps)
    (g_cpu, h_cpu) = build_topology(batch, 4096, 7, slot_caps=slot_caps)
    n_tables = 0
    for a, b in [(g_gpu, g_cpu)] + list(zip(h_gpu.levels, h_cpu.levels)) + \
            list(zip(h_gpu.transitions, h_cpu.transitions)):
        for name, x in vars(a).items():
            if isinstance(x, torch.Tensor):
                if not torch.equal(x.cpu(), getattr(b, name)):
                    raise AssertionError(f"topology table {name} differs")
                n_tables += 1
    return n_tables


def make_task(device, optin: bool, compute_dtype=torch.float32):
    """The flagship task, or its opt-in form (fused head, `optin_task`)."""
    from mm2d3d_tpu_torch.flagship import flagship_task

    if optin:
        return optin_task(device, compute_dtype)
    return flagship_task(compute_dtype=compute_dtype, device=device)


def topo_for(batch, optin: bool):
    """None (the task builds the default topology) or the dense one."""
    return dense_topology(batch) if optin else None


def compare_card_cpu(dev, optin: bool = False) -> None:
    tasks = {}
    for d in (dev, torch.device("cpu")):
        t = make_task(d, optin)
        t.init_params(torch.Generator().manual_seed(1))
        tasks[d.type] = t
    batch = flagship_batch(5, 2, "cpu")

    n_tables = compare_topology(batch, dev, None if optin else "default")
    log(f"card vs CPU: {n_tables} topology tables identical")

    t0 = time.perf_counter()
    b_gpu = batch.to(dev)
    topo_gpu = topo_for(b_gpu, optin)
    out_gpu = tasks["cuda"].forward(b_gpu, topo=topo_gpu)
    m_gpu, logs_gpu = tasks["cuda"].eval_step(b_gpu, topo=topo_gpu)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    topo_cpu = topo_for(batch, optin)
    out_cpu = tasks["cpu"].forward(batch, topo=topo_cpu)
    m_cpu, logs_cpu = tasks["cpu"].eval_step(batch, topo=topo_cpu)
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


# --------------------------------------------------------------------------
# phase 6: the train slice, bf16, batch 8 per domain, through the kernels
# --------------------------------------------------------------------------

TRAIN_STEPS = 3  # counted steps
TRAIN_TIMING = (3, 5)  # samples x steps
TRAJECTORY_STEPS = 12


def expected_train_launches(hiers) -> dict:
    """Kernel launches of one train step, from the two domains' hierarchies:
    per domain, K1 twice per eval-forward launch (forward and input
    gradient), K2 once per eval-forward K1 launch (weight gradient), K3 per
    topology and K4 per encoder as in the forward (the pool's backward is
    PyTorch's)."""
    out = {"bandmm": 0, "bandmm_dw": 0, "propagate": 0, "maxpool": 0, "head2d": 0,
           "tapsum": 0}
    for hier in hiers:
        ev = expected_launches(hier)
        out["bandmm"] += 2 * ev["bandmm"]
        out["bandmm_dw"] += ev["bandmm"]
        out["propagate"] += ev["propagate"]
        out["maxpool"] += ev["maxpool"]
    return out


def check_train_logs(logs) -> None:
    for name, t in logs.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name}: {float(t)}")
    for name in ("train/nbr_slot_overflow", "train/voxel_overflow_levels"):
        if float(logs[name]) != 0:
            raise AssertionError(f"{name} = {float(logs[name])}")


def run_train(dev):
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.train.batch import build_topology

    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    src, trg = flagship_batch(10, BATCH, dev), flagship_batch(11, BATCH, dev)
    for _ in range(2):  # warm-up: first launches, cuDNN plans, optimizer state
        check_train_logs(task.train_step(src, trg, gen))
    torch.cuda.synchronize()

    kernels.reset_counts()
    for _ in range(TRAIN_STEPS):
        logs = task.train_step(src, trg, gen)
    torch.cuda.synchronize()
    launches = kernels.counts()
    check_train_logs(logs)
    hiers = [build_topology(b, 4096, 7)[1] for b in (src, trg)]
    per_step = expected_train_launches(hiers)
    for name, n in per_step.items():
        if launches[name] != TRAIN_STEPS * n:
            raise AssertionError(
                f"{name}: {launches[name]} launches, expected {TRAIN_STEPS} x {n}")
    log(f"launch counts over {TRAIN_STEPS} train steps: {launches} "
        f"(per step {per_step})")

    torch.cuda.reset_peak_memory_stats()
    samples = []
    n_samples, n_steps = TRAIN_TIMING
    for _ in range(n_samples):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logs = task.train_step(src, trg, gen)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / n_steps)
    check_train_logs(logs)
    ms = statistics.median(samples) * 1e3
    scans = 2 * BATCH
    log(f"train step bf16 batch {BATCH} per domain: {ms:.2f} ms/step (median of "
        f"{n_samples} x {n_steps}, band {min(samples) * 1e3:.2f}-"
        f"{max(samples) * 1e3:.2f}), {scans * 1e3 / ms:.1f} scans/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # a fresh task over two fixed pairs, as tools/check_flagship_learning.py
    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(7)
    pairs = [(flagship_batch(0, BATCH, dev), flagship_batch(1, BATCH, dev)),
             (flagship_batch(2, BATCH, dev), flagship_batch(3, BATCH, dev))]
    losses = []
    for i in range(TRAJECTORY_STEPS):
        logs = task.train_step(*pairs[i % 2], gen)
        check_train_logs(logs)
        losses.append(float(logs["train/loss_total"]))
    log("trajectory train/loss_total: " + ", ".join(f"{x:.4f}" for x in losses))
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"loss did not fall: first {losses[0]}, "
                             f"mean of last 3 {statistics.mean(losses[-3:])}")
    return launches, ms, losses


# --------------------------------------------------------------------------
# phase 7: card vs CPU, fp32, one train step at batch 2 per domain
# --------------------------------------------------------------------------

@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (index_add_ and the gathers'
    backward without atomics) for a card-vs-CPU train step: with atomics,
    the card's step at seeds 12/13 put one L0 ReLU input on either side of
    zero from run to run (PERF.md, Findings)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def compare_train_card_cpu(dev, optin: bool = False, seeds=(12, 13)) -> None:
    """One fp32 train step on the card and on the CPU from the same weights
    and batches, dropout off.  Gradients are held per leaf against the
    largest CPU gradient of their branch, not the leaf's own maximum: fp32
    rounding tips a few ReLU and max-pool decisions, and one tipped pixel
    moves a deep leaf (a 2D layer4 weight sums over ~100 positions per
    scan) by a few percent of its own, small, maximum.  The CPU alone does
    the same under a 1e-7 perturbation of its input image (PERF.md).
    The same holds in the 3D branch: at seeds 12/13 one L0 ReLU input lies
    at -2.8e-7 with the CPU's dense sums and +1.4e-6 with its slot sums,
    and that one kink moves a weight gradient by 2.3e-3 of the branch's
    largest; the card's atomics put it on either side from run to run.  So
    the card runs with deterministic algorithms here, and phase 9 (the
    dense sums) takes `seeds` 20/21, where no kink lies within the card's
    reach (PERF.md, Findings)."""
    tasks = {}
    for d in (dev, torch.device("cpu")):
        t = make_task(d, optin)
        t.init_params(torch.Generator().manual_seed(3))
        for enc in (t.model2d.rgb_backbone, t.model2d.depth_backbone):
            enc.dropout_rate = 0.0
        tasks[d.type] = t
    src, trg = (flagship_batch(s, COMPARE_BATCH, "cpu") for s in seeds)
    n_tables = sum(compare_topology(b, dev, None if optin else "default")
                   for b in (src, trg))
    log(f"card vs CPU: {n_tables} topology tables identical (both domains)")

    s_gpu, t_gpu = src.to(dev), trg.to(dev)
    with deterministic():
        logs_gpu = tasks["cuda"].train_step(s_gpu, t_gpu, torch.Generator(device=dev),
                                            topo_for(s_gpu, optin),
                                            topo_for(t_gpu, optin))
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs_cpu = tasks["cpu"].train_step(src, trg, torch.Generator(),
                                       topo_for(src, optin), topo_for(trg, optin))
    log(f"fp32 train step batch {COMPARE_BATCH} per domain on the CPU: "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    for name, b in logs_cpu.items():
        a = float(logs_gpu[name])
        if abs(a - float(b)) > LOGIT_REL_TOL * abs(float(b)):
            raise AssertionError(f"{name}: card {a} vs CPU {float(b)}")
    log("card vs CPU: every train log within 1e-3 relative")

    worst, own = [], []  # (|card - CPU| / scale, branch, leaf, kind)
    for branch in ("model2d", "model3d"):
        ours = dict(getattr(tasks["cuda"], branch).named_parameters())
        grads = dict(getattr(tasks["cpu"], branch).named_parameters())
        top = max(float(p.grad.abs().max()) for p in grads.values())
        for name, p in grads.items():
            err = float((ours[name].grad.cpu() - p.grad).abs().max())
            worst.append((err / top, branch, name, "grad"))
            own.append((err / max(float(p.grad.abs().max()), 1e-30), branch, name,
                        "grad"))
        bufs = dict(getattr(tasks["cuda"], branch).named_buffers())
        for name, ref in getattr(tasks["cpu"], branch).named_buffers():
            err = float((bufs[name].cpu() - ref).abs().max())
            worst.append((err / max(float(ref.abs().max()), 1e-30), branch, name,
                          "stat"))
    worst.sort(reverse=True)
    own.sort(reverse=True)
    log("card vs CPU, worst leaves (gradients: |card - CPU| / max|CPU gradient "
        "of the branch|; statistics: / max|CPU leaf|): " + "; ".join(
            f"{b}.{n} {k} {e:.2e}" for e, b, n, k in worst[:5]))
    log("  for information, gradients against their own leaf's maximum: "
        + "; ".join(f"{b}.{n} {e:.2e}" for e, b, n, _ in own[:3]))
    if worst[0][0] > LOGIT_REL_TOL:
        e, b, n, k = worst[0]
        raise AssertionError(f"{b}.{n} {k}: {e} > {LOGIT_REL_TOL}")
    log(f"card vs CPU: {len(own)} gradient leaves and "
        f"{len(worst) - len(own)} running statistics within 1e-3")


# --------------------------------------------------------------------------
# phase 8: the opt-in path (fused head K5, dense 27-tap convs K6), bf16
# --------------------------------------------------------------------------

def optin_task(dev, compute_dtype=torch.bfloat16):
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.models.net2d import Net2DSeg

    return flagship_task(compute_dtype=compute_dtype, device=dev,
                         model2d=Net2DSeg(6, compute_dtype, fused_head=True))


def expected_optin_launches(hier) -> dict:
    """Kernel launches of one eval forward on the opt-in path, its dense
    topology's build included: K3 at every level but the coarsest (the
    tables only, h1 = 0), K4 once per encoder, K5 once, K6 once per
    submanifold conv (input conv, encoder and decoder blocks), K1 once per
    strided conv."""
    n = len(hier.levels)
    assert all(lvl.slot_src is None for lvl in hier.levels)
    return {"propagate": n - 1, "maxpool": 2, "head2d": 1, "tapsum": 2 * n,
            "bandmm": 2 * (n - 1), "bandmm_dw": 0}


def expected_optin_train_launches(hiers) -> dict:
    """Per train step, per domain: the forward's launches with K6 and K1
    twice (forward and input gradient), K2 once per strided conv (weight
    gradient); the dense convs' weight gradients and K5's backward are
    plain PyTorch, as the JAX package's are XLA's."""
    out = dict.fromkeys(("propagate", "maxpool", "head2d", "tapsum", "bandmm",
                         "bandmm_dw"), 0)
    for hier in hiers:
        ev = expected_optin_launches(hier)
        for k in ("propagate", "maxpool", "head2d"):
            out[k] += ev[k]
        out["tapsum"] += 2 * ev["tapsum"]
        out["bandmm"] += 2 * ev["bandmm"]
        out["bandmm_dw"] += ev["bandmm"]
    return out


def check_counts(launches, expected, what) -> None:
    for name, n in expected.items():
        if launches[name] != n:
            raise AssertionError(f"{what}: {name} {launches[name]} launches, "
                                 f"expected {n}")


def run_optin(dev, default_losses):
    from mm2d3d_tpu_torch.ops import kernels

    task = optin_task(dev)
    task.init_params(torch.Generator().manual_seed(0))
    batches = [flagship_batch(s, BATCH, dev) for s in range(4)]
    task.eval_step(batches[0], topo=dense_topology(batches[0]))  # warm-up
    torch.cuda.synchronize()

    # eval: the dense topology built and handed to eval_step, per batch
    kernels.reset_counts()
    runs = []
    for b in batches:
        topo = dense_topology(b)
        runs.append((task.eval_step(b, topo=topo), topo[1]))
    torch.cuda.synchronize()
    eval_launches = kernels.counts()
    expected = dict.fromkeys(eval_launches, 0)
    for (metrics, logs), hier in runs:
        for name, t in logs.items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"opt-in eval: non-finite {name}")
        if float(logs["nbr_slot_overflow"]) != 0:
            raise AssertionError("opt-in eval: slot overflow")
        if int(metrics.cm_avg.sum()) <= 0:
            raise AssertionError("opt-in eval: empty confusion matrix")
        for l, lev in enumerate(hier.levels):
            if int(lev.num_voxels) >= lev.capacity:
                raise AssertionError(f"level {l} at capacity {lev.capacity}")
        for k, n in expected_optin_launches(hier).items():
            expected[k] += n
    check_counts(eval_launches, expected, "opt-in eval")
    log(f"opt-in eval: launch counts over {len(batches)} forwards {eval_launches} "
        f"(per forward {expected_optin_launches(runs[0][1])})")

    # throughput: the dense topology and the forward, per batch
    torch.cuda.reset_peak_memory_stats()
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(3):
            for b in batches:
                out = task.forward(b, topo=dense_topology(b))
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / 12)
    ms = statistics.median(samples) * 1e3
    log(f"opt-in slice bf16 batch {BATCH}: {ms:.2f} ms/batch (median of 3 x 12, "
        f"band {min(samples) * 1e3:.2f}-{max(samples) * 1e3:.2f}), "
        f"{BATCH * 1e3 / ms:.1f} scans/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out

    # train: both dense topologies built and handed to train_step, per step
    gen = torch.Generator(device=dev).manual_seed(0)
    src, trg = flagship_batch(10, BATCH, dev), flagship_batch(11, BATCH, dev)

    def step(task, s, t, gen):
        return task.train_step(s, t, gen, topo_src=dense_topology(s),
                               topo_trg=dense_topology(t))

    for _ in range(2):
        check_train_logs(step(task, src, trg, gen))
    torch.cuda.synchronize()
    kernels.reset_counts()
    for _ in range(TRAIN_STEPS):
        logs = step(task, src, trg, gen)
    torch.cuda.synchronize()
    train_launches = kernels.counts()
    check_train_logs(logs)
    per_step = expected_optin_train_launches(
        [dense_topology(b)[1] for b in (src, trg)])
    check_counts(train_launches, {k: TRAIN_STEPS * n for k, n in per_step.items()},
                 "opt-in train")
    log(f"opt-in train: launch counts over {TRAIN_STEPS} steps {train_launches} "
        f"(per step {per_step})")
    torch.cuda.reset_peak_memory_stats()
    samples = []
    n_samples, n_steps = TRAIN_TIMING
    for _ in range(n_samples):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logs = step(task, src, trg, gen)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / n_steps)
    check_train_logs(logs)
    train_ms = statistics.median(samples) * 1e3
    log(f"opt-in train step bf16 batch {BATCH} per domain: {train_ms:.2f} ms/step "
        f"(median of {n_samples} x {n_steps}, band {min(samples) * 1e3:.2f}-"
        f"{max(samples) * 1e3:.2f}), {2 * BATCH * 1e3 / train_ms:.1f} scans/s; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # phase 6's 12-step trajectory (same init, pairs and dropout seed)
    task = optin_task(dev)
    task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(7)
    pairs = [(flagship_batch(0, BATCH, dev), flagship_batch(1, BATCH, dev)),
             (flagship_batch(2, BATCH, dev), flagship_batch(3, BATCH, dev))]
    losses = []
    for i in range(TRAJECTORY_STEPS):
        logs = step(task, *pairs[i % 2], gen)
        check_train_logs(logs)
        losses.append(float(logs["train/loss_total"]))
    log("opt-in trajectory train/loss_total: " + ", ".join(f"{x:.4f}" for x in losses))
    log("phase 6 trajectory train/loss_total: "
        + ", ".join(f"{x:.4f}" for x in default_losses))
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"opt-in loss did not fall: first {losses[0]}, "
                             f"mean of last 3 {statistics.mean(losses[-3:])}")

    # fp32 at batch 2: the opt-in path and the default path compute the
    # same function from the same weights
    from mm2d3d_tpu_torch.flagship import flagship_task

    t_def = flagship_task(compute_dtype=torch.float32, device=dev)
    t_opt = optin_task(dev, torch.float32)
    for t in (t_def, t_opt):
        t.init_params(torch.Generator().manual_seed(1))
    batch = flagship_batch(5, 2, dev)
    ref, out = t_def.forward(batch), t_opt.forward(batch, topo=dense_topology(batch))
    for name in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        err = float((out[name] - ref[name]).abs().max())
        tol = LOGIT_REL_TOL * float(ref[name].abs().max())
        log(f"  fp32 batch 2, opt-in vs default path {name}: max|d| = {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"opt-in vs default {name}: {err} > {tol}")
    return eval_launches, ms, train_ms


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
    check_k2(res, dev)
    check_k6(res, dev)
    check_k5(res, dev)

    log("phase 4: slice, bf16, batch 8")
    launches, slice_ms = run_slice(dev)

    log("phase 5: card vs CPU, fp32, batch 2")
    compare_card_cpu(dev)

    log(f"phase 6: train slice, bf16, batch {BATCH} per domain")
    train_launches, train_ms, losses = run_train(dev)

    log(f"phase 7: card vs CPU, fp32, one train step, batch {COMPARE_BATCH} per domain")
    t0 = time.perf_counter()
    compare_train_card_cpu(dev)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    log(f"phase 8: opt-in path (fused head, dense 27-tap convs), bf16, batch {BATCH}")
    optin_launches, optin_ms, optin_train_ms = run_optin(dev, losses)

    log("phase 9: opt-in path, card vs CPU, fp32: the forward at batch 2, one train "
        f"step at batch {COMPARE_BATCH} per domain")
    t0 = time.perf_counter()
    compare_card_cpu(dev, optin=True)
    compare_train_card_cpu(dev, optin=True, seeds=(20, 21))
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    from mm2d3d_tpu_torch.ops import kernels

    main_case = {"propagate": "L0 ", "maxpool": f"({BATCH}, 240, 400, 64) float32",
                 "bandmm": "enc L0 tier1+center H=3 bfloat16",
                 "bandmm_dw": "enc L0 tier1+center H=3 bfloat16",
                 "tapsum": "enc L0 fwd Ci=16 Co=16 bfloat16",
                 "head2d": f"({BATCH}, 240, 400, 64)x3 bfloat16"}
    # each kernel's launches on the path it runs on: the eval forward of
    # phase 4 (K1, K3, K4), the train step of phase 6 (K2), the opt-in eval
    # forward of phase 8 (K5, K6)
    path_launches = {"bandmm_dw": train_launches["bandmm_dw"],
                     "tapsum": optin_launches["tapsum"],
                     "head2d": optin_launches["head2d"]}
    rows = []
    for name, k in kernels.all_kernels().items():
        case = next(c for c in res.cases if c[0] == name and c[1].startswith(main_case[name]))
        n = path_launches.get(name, launches[name])
        if n <= 0:
            raise AssertionError(f"{name}: no launch on its path")
        rows.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": n,
            "max_abs_err": res.max_err(name), "ms": case[4], "plain_ms": case[5],
            "bound_ms": case[6], "bound_by": case[7], "library_ms": case[8],
            "slowest_vs_library": res.slowest_vs_library(name),
        })
    log(f"slice: {slice_ms:.2f} ms/batch of {BATCH}, {BATCH * 1e3 / slice_ms:.1f} scans/s")
    log(f"train: {train_ms:.2f} ms/step of 2 x {BATCH}, "
        f"{2 * BATCH * 1e3 / train_ms:.1f} scans/s")
    log(f"opt-in slice: {optin_ms:.2f} ms/batch, opt-in train: {optin_train_ms:.2f} "
        "ms/step")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
