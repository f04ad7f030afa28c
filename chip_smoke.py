"""Smoke run of the PyTorch port (mm2d3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from mm2d3d_tpu_torch/csrc, holds each
against its plain PyTorch version at the flagship shapes and times it beside
its bound and, where one exists, a single PyTorch call that computes the same
function (phase 3), drives the eval slice (flagship configuration, bf16,
batch 8) through the launch-counted kernels (phase 4), compares the card's
fp32 forward with the CPU's (phase 5), drives the train slice (bf16, batch 8
per domain: two steps from one state bit-identical with PyTorch's
deterministic mode off, launch counts, timing, a 12-step loss trajectory;
phase 6), and compares the card's fp32 train step with the CPU's (phase 7).
Phase 8 drives the opt-in path (the fused 2D head, K5, and the dense 27-tap
sparse convolutions, K6, through topologies built with `slot_caps=None`)
for eval and training at the same sizes, and phase 9 holds it, card
against CPU, in fp32.  Phase 10 runs configs/config.yaml as shipped (batch
16 per domain, bf16, OneCycle) through the port's CLI,
`mm2d3d_tpu_torch.run.main`, over a synthetic nuScenes tree written to a
temporary directory: 3 train steps, validation, test, then `run=test` with
resume.  Phase 11 does the same for configs/vkitti_skitti.yaml and
configs/a2d2.yaml (64-beam scans, the dense slot profile, batch 16 per
domain at 10,240 points, 480x302 crops, SemanticKITTI evaluated on whole
1241x376 frames at batch 8) over synthetic SemanticKITTI, VirtualKITTI and
A2D2 trees, holds K1-K4's launches to the hierarchies' prediction, and
checks the dense profile's tables and fp32 forward card against CPU.
Phase 12 drives the training options: topologies built on the host (C++,
`train.host_topology`) held table by table against the card's and in a
bf16 train step bit for bit, and through the CLI over configs/config.yaml
and configs/vkitti_skitti.yaml; the strided convs over child slots (K1 and
K2 with K = 8) in the eval forward and the train step, their kernel calls
against the plain versions, card against CPU in fp32; and the CLI over
configs/config.yaml with frozen batch norm, residual blocks and gradient
accumulation, 4 steps (2 updates), then a run resumed between two
micro-steps.  Phase 13 drives data parallelism (`parallel/mesh.py`): the
bf16 train step in an NCCL group of one, bit-identical to the plain step;
two ranks sharing the card over gloo (`tools/ddp_check.py`), one fp32 step
held against the same two ranks on the CPU and two bf16 steps with the
ranks bit-identical; and configs/config.yaml through the CLI under torchrun
with two ranks, K1-K4's launches per rank held to the hierarchies'
prediction, the resumed ranks bit-equal to the checkpoint and the
validation's confusion matrices equal to one process's.  The CLI runs of
phases 10-13 write the configs' qualitative figures as shipped (step 0,
each eval loop's first batch), and their launches are held with them.
Phase 14 drives the self-training stage and the training tools over phase
10's tree: the pseudo-label generator from phase 10's `last` checkpoint
(the schema against the scans, K1, K3 and K4 launches per scan as
predicted, the card's fp32 records against the CPU's on two scans), two
CLI steps on the written labels and the doctor's `check_pselab` on them;
the flagship learning check against the committed H100 trajectory (exit
0), then with its fault injected (exit 1); and the CLI writing a figure
every step and eval batch, held pixel by pixel to the palette.  Phase 15
drives batches past the dense neighbour map, where the coarsest level's
table comes from the key search: the topologies of 17, 24 and 32 scans
card against CPU, the bf16 eval forward at batch 32 and a bf16 train step
at 24 per domain (launches as predicted, both monitors equal to the
tables' counts); then the loader's C++ image ops bit-equal to numpy on the
card's host, and `tools/bench_loader.py` (scans/s per image path, the
stage split of a train step at batch 16).  Phase 16 drives the host
self-validation tool: `python -m mm2d3d_tpu_torch.tools.doctor --perf` in
its own session (exit 0, the JAX tool's keys without donation, each
recommendation in its set, no process left), then the tool's probes in
this process (loader pools, no process left; forwards with the card's and
host-built topologies, bit-equal, K3 only in the card's; `Trainer.fit` at
prefetch depths 0, 2 and 4, launches per step as predicted).  Phase 17
holds the probe kernels K7-K10 (ports of the TPU probes'
`pallas_call`s) against their plain versions, K7-K9 bit for bit at the
probes' sizes and edges, K10 in both E builds and tiles within 1e-4 *
max|plain| and bit-stable, then runs the two probe tools once
(`mm2d3d_tpu_torch.tools.exp_dma_gather`, `exp_bandmm_variants`) and
counts the kernels' launches there; every path above launches none of
them.  Phase 18 runs the sustained-fit tool
(`mm2d3d_tpu_torch.tools.bench_e2e`: 32 scans, 2 steps, 0 and 2 loader
workers; the stage split, `Trainer.fit`, both controls, the fit with
host-built topologies; every fit's launches per step as predicted, every
loss finite, no process left) and the topology profile
(`mm2d3d_tpu_torch.tools.profile_topology`: K3 0, 0, 6 and 6 times over
its four phases, the last phase's tables identical to `build_topology`'s).
Prints,
in its last lines, the card (nvidia-smi name and power
limit), one JSON line of kernel results, and one JSON line
{"ok": true, "device": {...}}.  Any failed phase raises, and
the script exits non-zero without the final line; it also refuses to run
without a CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

from mm2d3d_tpu_torch.tools.kernel_cases import (
    BATCH, PROBE_KERNELS, cuda_ms, expected_launches, expected_train_launches,
    flagship_batch, no_launches)

K1_REL_TOL = 1e-4  # max |kernel - plain| <= 1e-4 * max |plain| (K1, K2, K5, K6, K10)
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
    shapes = {f"({BATCH}, 240, 400, 64)": (BATCH, 240, 400, 64),
              "(3, 33, 47, 64)": (3, 33, 47, 64), "(2, 17, 10, 64)": (2, 17, 10, 64),
              # the KITTI configs' stem outputs: 480x302 train crops (padded to
              # 480x304) at batch 16, SemanticKITTI's 1241x376 eval frames
              # (padded to 1248x384) at batch 8
              "KITTI train stem (16, 152, 240, 64)": (16, 152, 240, 64),
              "SemanticKITTI eval stem (8, 192, 624, 64)": (8, 192, 624, 64)}
    for name, shape in shapes.items():
        for dt in (torch.float32, torch.bfloat16):
            x = torch.relu(torch.randn(shape, generator=g, device=dev)).to(dt)
            out, ref = maxpool3x3s2(x), maxpool3x3s2_ref(x)
            if out.shape != ref.shape or not torch.equal(out, ref):
                raise AssertionError(f"K4 {shape} {dt}: kernel != plain version")
            ms = cuda_ms(lambda: maxpool3x3s2(x))
            plain = cuda_ms(lambda: maxpool3x3s2_ref(x))
            # one call of the same function (its output NCHW, channels_last)
            library = cuda_ms(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1))
            res.add("maxpool", f"{name} {str(dt)[6:]}", 0.0, 0.0, ms, plain,
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
    its tiers; the strided conv down to L6, the up conv to L4), at the KITTI
    configs' level-0 tiers (the dense slot profile, batch 16 x 10,240), and
    at the tensor-core kernel's edges (ragged V, two column blocks, H = 20 and 26,
    a tile of misses, duplicate taps and tap 13 beside the centre, split
    shapes).  Each form runs twice and must give the same bits; each case
    names its route."""
    from mm2d3d_tpu_torch.ops.kernels.bandmm import slot_conv_apply, slot_conv_apply_ref
    from mm2d3d_tpu_torch.tools.kernel_cases import edge_forms, k1_forms

    forms = (k1_forms(dev) + k1_forms(dev, kitti=True)
             + [(name, args[:4]) for name, args, _ in edge_forms(dev)])
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
    strided conv L5 -> L6 and the up conv L5 -> L4; the KITTI configs'
    level-0 tiers; and the tensor-core kernel's edges.  The mid and heavy tiers take the gradient at their
    compacted rows, as the adjoint does.  Each form runs twice and must give
    the same bits; each case names its route."""
    from mm2d3d_tpu_torch.ops.kernels.bandmm_dw import slot_conv_dw, slot_conv_dw_ref
    from mm2d3d_tpu_torch.tools.kernel_cases import edge_forms, k2_forms

    forms = k2_forms(dev) + k2_forms(dev, kitti=True) + [
        (name, (xm, xs, tap, g), k) for name, (xm, xs, tap, _, g), k in edge_forms(dev)]
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


def slot_gather_cases(dev):
    """(case, x, ids) of the slot gather at the path's shapes, over real
    tables: the flagship's level-0 tier 1 (batch 8, Ci 16); MinkUNet34C's
    5^3 stem over the KITTI step's level 0 (16 x 10,240 points), its
    forward (Ci 3) and its input gradient (Co 32); its level-3 tier 1 at Ci
    384 (block5.0's conv1); an fp32 child gather (Co 64, the parity dtype)."""
    from mm2d3d_tpu_torch.tools.kernel_cases import KITTI_BATCH, kitti_batch
    from mm2d3d_tpu_torch.train.batch import build_topology

    gen = torch.Generator(device=dev).manual_seed(41)

    def feats(v, c, dt=torch.bfloat16):
        return torch.randn((v, c), generator=gen, device=dev).to(dt)

    _, flag = build_topology(flagship_batch(0, BATCH, dev), 4096, 7)
    _, mink = build_topology(kitti_batch(0, KITTI_BATCH, dev), 4096, 5,
                             slot_profile="dense", stem_kernel=5)
    l0, l3 = mink.levels[0], mink.levels[3]
    return [
        ("flagship L0 tier1 Ci=16 bfloat16", feats(flag.levels[0].capacity, 16),
         flag.levels[0].slot_src),
        ("mink stem grad (125, V0) C=32 bfloat16", feats(l0.capacity, 32), l0.nbr5),
        ("mink stem fwd (125, V0) C=3 bfloat16", feats(l0.capacity, 3), l0.nbr5),
        ("mink L3 tier1 Ci=384 bfloat16", feats(l3.capacity, 384), l3.slot_src),
        ("flagship L0->L1 child Co=64 float32",
         feats(flag.levels[0].capacity, 64, torch.float32), flag.transitions[0].child),
    ]


def check_slot_gather(res: Results, dev) -> None:
    """The slot gather bit-equal to its plain version at the path's shapes
    (`slot_gather_cases`), two calls bit-identical; its bound: the output
    written, the ids and the distinct rows they reach read once
    (`gathered_bytes`); the library call: the gather it replaced,
    `padded[ids64]` over the map with its zero row and int64 ids made
    beforehand (the pad and the cast besides are logged)."""
    from mm2d3d_tpu_torch.ops.kernels.slot_gather import slot_gather, slot_gather_ref

    for case, x, ids in slot_gather_cases(dev):
        out, again, ref = slot_gather(x, ids), slot_gather(x, ids), slot_gather_ref(x, ids)
        if not (torch.equal(out.view(torch.uint8), ref.view(torch.uint8))
                and torch.equal(out.view(torch.uint8), again.view(torch.uint8))):
            raise AssertionError(f"slot_gather {case}: not bit-equal")
        padded = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        ids64 = torch.clamp(ids, max=x.shape[0]).long()
        ms = cuda_ms(lambda: slot_gather(x, ids))
        plain = cuda_ms(lambda: slot_gather_ref(x, ids), reps=5)
        library = cuda_ms(lambda: padded[ids64], reps=5)
        whole = cuda_ms(lambda: torch.cat([x, x.new_zeros((1, x.shape[1]))])[ids.long()],
                        reps=5)
        pad_share = float((ids >= x.shape[0]).float().mean())
        res.add("slot_gather", f"{case} ids {tuple(ids.shape)} pad {pad_share:.2f}",
                0.0, 0.0, ms, plain, bound(nbytes(ids, out) + gathered_bytes(x, ids)),
                library)
        log(f"  slot_gather {case}: the replaced path (pad, int64 ids, gather) "
            f"{whole:.4f} ms")
        del out, again, ref, padded, ids64


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


def check_bn(res: Results, dev) -> None:
    """The train-form BatchNorm kernels (forward and backward, four
    launches) against their plain versions at every call form of
    `kernel_cases.BN_CASES`: the flagship's at its train batch (stride 1
    and 2 at 64 channels, stride 16 at 512; each epilogue; the stems' halves
    read in place) and the KITTI configs' largest, by `kernel_cases.bn_check`
    (two calls the same bits, the ReLU bits as the plain mask outside the
    rounding band); the error is the worst output's share of its tolerance.
    Timed: the four passes without autograd.  The yardstick is cuDNN's
    train-form `F.batch_norm`, forward and backward, without the epilogue,
    on a contiguous copy of x (the port never calls it).  Then the masked
    form at the 3D branches' level shapes (`kernel_cases.MASKED_BN_CASES`):
    checked and timed alike, its plain version the eager masked form's ops
    (no single PyTorch call takes a row mask)."""
    from mm2d3d_tpu_torch.tools.kernel_cases import (
        BN_CASES, MASKED_BN_CASES, bn_bytes, bn_check, bn_inputs, bn_passes,
        masked_bn_bytes, masked_bn_inputs)

    for name, case in BN_CASES.items():
        epi, y_dtype = case[2], case[4]
        inputs = bn_inputs(case, dev, seed=7)
        errs = bn_check(inputs, epi, y_dtype)
        # timed: the four passes alone, without autograd's bookkeeping
        x, weight, bias, ident, rm, rv, dy, _ = inputs
        timed = (x, weight, bias, ident, rm.clone(), rv.clone(), dy, None)
        ms = cuda_ms(lambda: bn_passes(timed, epi, y_dtype), reps=10)
        plain = cuda_ms(lambda: bn_passes(timed, epi, y_dtype, plain=True), reps=5)
        xl = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
        wl, bl = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        rm, rv = rm.clone(), rv.clone()

        def library():
            y = F.batch_norm(xl, rm, rv, wl, bl, training=True, momentum=0.1, eps=1e-5)
            return torch.autograd.grad(y, (xl, wl, bl), dy.to(y.dtype))

        lib_ms = cuda_ms(library, reps=10)
        worst = max(errs, key=errs.get)
        res.add("batchnorm2d", f"{name} {epi} {str(case[3])[6:]}->{str(y_dtype)[6:]} "
                f"(worst: {worst})", errs[worst], 1.0, ms, plain, bound(bn_bytes(case)),
                lib_ms)
        del inputs, timed, x, xl, ident, dy

    for name, case in MASKED_BN_CASES.items():
        (v, c), share, epi, y_dtype, eps = case
        inputs = masked_bn_inputs(case, dev, seed=7)
        errs = bn_check(inputs, epi, y_dtype, eps)
        x, weight, bias, ident, rm, rv, dy, valid = inputs
        timed = (x, weight, bias, ident, rm.clone(), rv.clone(), dy, valid)
        ms = cuda_ms(lambda: bn_passes(timed, epi, y_dtype, eps=eps), reps=10)
        plain = cuda_ms(lambda: bn_passes(timed, epi, y_dtype, plain=True, eps=eps), reps=5)
        worst = max(errs, key=errs.get)
        res.add("batchnorm2d", f"masked {name} {share:.0%} valid {epi} float32->"
                f"{str(y_dtype)[6:]} (worst: {worst})", errs[worst], 1.0, ms, plain,
                bound(masked_bn_bytes(case)))
        del inputs, timed, x, ident, dy, valid


# --------------------------------------------------------------------------
# phase 4: the slice, bf16, batch 8, through the counted kernels
# --------------------------------------------------------------------------

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

def same_tables(a, b, what: str) -> int:
    """Two topologies' tables identical (compared on the CPU) -> how many."""
    (g_a, h_a), (g_b, h_b) = a, b
    n_tables = 0
    for x, y in [(g_a, g_b)] + list(zip(h_a.levels, h_b.levels)) + \
            list(zip(h_a.transitions, h_b.transitions)):
        for name, t in vars(x).items():
            u = getattr(y, name)
            if (t is None) != (u is None):
                raise AssertionError(f"{what}: topology table {name} in one only")
            if isinstance(t, torch.Tensor):
                if not torch.equal(t.cpu(), u.cpu()):
                    raise AssertionError(f"{what}: topology table {name} differs")
                n_tables += 1
    return n_tables


def compare_topology(batch, dev, slot_caps="default", slot_profile="default",
                     child_slot_caps=None) -> int:
    """Build the topology of a CPU batch on the card and on the CPU; every
    table must be identical.  Returns the number of tables."""
    from mm2d3d_tpu_torch.train.batch import build_topology

    kw = dict(slot_caps=slot_caps, slot_profile=slot_profile,
              child_slot_caps=child_slot_caps)
    return same_tables(build_topology(batch.to(dev), 4096, 7, **kw),
                       build_topology(batch, 4096, 7, **kw), "card vs CPU")


def make_task(device, optin: bool, compute_dtype=torch.float32):
    """The flagship task, or its opt-in form (fused head, `optin_task`)."""
    from mm2d3d_tpu_torch.flagship import flagship_task

    if optin:
        return optin_task(device, compute_dtype)
    return flagship_task(compute_dtype=compute_dtype, device=device)


def topo_for(batch, optin: bool):
    """None (the task builds the default topology) or the dense one."""
    return dense_topology(batch) if optin else None


def child_slot_topology(batch):
    """The default flagship topology with the strided convs over child
    slots (`child_slot_caps="default"`)."""
    from mm2d3d_tpu_torch.train.batch import build_topology

    with torch.no_grad():
        return build_topology(batch, 4096, 7, child_slot_caps="default")


def compare_card_cpu(dev, optin: bool = False, child_slots: bool = False) -> None:
    tasks = {}
    for d in (dev, torch.device("cpu")):
        t = make_task(d, optin)
        t.init_params(torch.Generator().manual_seed(1))
        tasks[d.type] = t
    batch = flagship_batch(5, 2, "cpu")
    topo = child_slot_topology if child_slots else (lambda b: topo_for(b, optin))

    n_tables = compare_topology(batch, dev, None if optin else "default",
                                child_slot_caps="default" if child_slots else None)
    log(f"card vs CPU: {n_tables} topology tables identical")

    t0 = time.perf_counter()
    b_gpu = batch.to(dev)
    topo_gpu = topo(b_gpu)
    out_gpu = tasks["cuda"].forward(b_gpu, topo=topo_gpu)
    m_gpu, logs_gpu = tasks["cuda"].eval_step(b_gpu, topo=topo_gpu)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    topo_cpu = topo(batch)
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
    from mm2d3d_tpu_torch.tools.train_repro import check_reproducible
    from mm2d3d_tpu_torch.train.batch import build_topology

    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    src, trg = flagship_batch(10, BATCH, dev), flagship_batch(11, BATCH, dev)
    for _ in range(2):  # warm-up: first launches, cuDNN plans, optimizer state
        check_train_logs(task.train_step(src, trg, gen))
    torch.cuda.synchronize()

    # reproducibility: from one saved state (moments and all), two steps,
    # deterministic mode off, give the same bits everywhere
    n_tensors, differ = check_reproducible(task, src, trg, gen)
    if differ:
        raise AssertionError(f"two train steps from one state differ in "
                             f"{len(differ)} of {n_tensors} tensors: {differ[:10]}")
    log(f"two bf16 train steps from one state, deterministic mode off: all "
        f"{n_tensors} tensors (weights, running statistics, optimizer moments, "
        "dropout generator, logs) and the schedules bit-identical")

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

def compare_train_card_cpu(dev, optin: bool = False, seeds=(20, 21),
                           child_slots: bool = False) -> None:
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
    largest.  The card's step sums in a fixed order, so it lands on one
    side of the kink in every run, which side set by the last bits of the
    masked BatchNorm's statistics: the CPU's side until that BatchNorm ran
    on the card's kernels; since, the other (`out_bn`'s input at 8.7e-7,
    and one of `dec_4_0.bn` at 4.8e-6, the only ReLU decisions card and
    CPU take apart).  Every phase takes `seeds` 20/21, where no ReLU
    decision differs (PERF.md, Findings)."""
    tasks = {}
    for d in (dev, torch.device("cpu")):
        t = make_task(d, optin)
        t.init_params(torch.Generator().manual_seed(3))
        for enc in (t.model2d.rgb_backbone, t.model2d.depth_backbone):
            enc.dropout_rate = 0.0
        tasks[d.type] = t
    src, trg = (flagship_batch(s, COMPARE_BATCH, "cpu") for s in seeds)
    topo = child_slot_topology if child_slots else (lambda b: topo_for(b, optin))
    n_tables = sum(compare_topology(b, dev, None if optin else "default",
                                    child_slot_caps="default" if child_slots else None)
                   for b in (src, trg))
    log(f"card vs CPU: {n_tables} topology tables identical (both domains)")

    s_gpu, t_gpu = src.to(dev), trg.to(dev)
    logs_gpu = tasks["cuda"].train_step(s_gpu, t_gpu, torch.Generator(device=dev),
                                        topo(s_gpu), topo(t_gpu))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs_cpu = tasks["cpu"].train_step(src, trg, torch.Generator(), topo(src), topo(trg))
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
    topology's build included: `expected_launches` with K5 once, K6 once
    per submanifold conv (no level has a slot plan)."""
    assert not any(lvl.slot_tiers() for lvl in hier.levels)
    return expected_launches(hier, fused_head=True)


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
    per_step = expected_train_launches([dense_topology(b)[1] for b in (src, trg)],
                                       fused_head=True)
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


# --------------------------------------------------------------------------
# phase 10: configs/config.yaml through the port's CLI, at full width
# --------------------------------------------------------------------------

CLI_SPLITS = {"train_usa": 48, "train_singapore": 48, "val_singapore": 32,
              "test_singapore": 32}  # scans: 3 train pairs and 2 eval batches of 16
CLI_FRAMES = 16  # distinct camera frames, shared by the scans
CLI_ORIG, CLI_RESIZE = (1600, 900), (400, 225)  # (W, H): original, cached
CLI_WORKERS = 4


def synthetic_scan(rng, frame: str) -> dict:
    """One nuScenes-like preprocessed scan (the keys `NuScenesLidarSeg`
    reads): 32 beam rings (elevation -0.42 to 0.08 rad, 1.6 m up) over the
    front camera's field of view (+-0.56 rad: fx 1266 px at 1600x900), a
    ground plane and six walls at 5-55 m; rays with no return within 50 m
    give no point, and 4000-8000 of the rest are kept, so the points spread
    over +-50 m, all in view."""
    import numpy as np

    n = rng.randint(4000, 8001)
    elev, az = np.meshgrid(np.linspace(-0.42, 0.08, 32),
                           np.linspace(-0.56, 0.56, 2 * -(-n // 32)), indexing="ij")
    elev, az = elev.ravel(), az.ravel()
    with np.errstate(divide="ignore"):
        r = np.where(elev < -1e-3, 1.6 / np.tan(-elev), np.inf)
    for _ in range(6):
        hit = np.abs(az - (rng.rand() - 0.5) * 1.0) < rng.rand() * 0.1 + 0.02
        r = np.where(hit, np.minimum(r, rng.rand() * 50 + 5), r)
    keep = np.flatnonzero((r >= 2.0) & (r <= 50.0))
    keep = np.sort(rng.choice(keep, size=min(n, keep.size), replace=False))
    elev, az = elev[keep], az[keep]
    r = r[keep] + rng.randn(keep.size) * 0.02
    # camera frame: x right, y down, z forward
    pts_cam = np.stack([r * np.cos(elev) * np.sin(az), -r * np.sin(elev),
                        r * np.cos(elev) * np.cos(az)], 1).astype(np.float32)
    f, (w, h) = 1266.0, CLI_ORIG
    u = np.clip(f * pts_cam[:, 0] / pts_cam[:, 2] + w / 2, 0, w - 1)
    v = np.clip(f * pts_cam[:, 1] / pts_cam[:, 2] + h / 2, 0, h - 1)
    return {
        "points": pts_cam[:, [2, 0, 1]].copy(),  # lidar frame: x forward
        "seg_labels": rng.randint(0, 17, keep.size).astype(np.uint8),
        "points_img": np.stack([v, u], 1).astype(np.float64),  # (row, col)
        "camera_path": frame, "lidar_path": "lidar.bin", "sample_token": "t",
        "scene_name": "scene", "pts_cam_coord": pts_cam,
        "calib": {"cam_intrinsic": np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])},
    }


def write_nuscenes_tree(root: str, seed: int = 0, splits=None):
    """The preprocess pickles (`splits`: scans per split, CLI_SPLITS by
    default) and a decoded-image cache (`data.image_cache` format: 400x225
    uint8 frames of 1600x900 originals) under `root` -> (preprocess dir,
    cache dir)."""
    import pickle

    import numpy as np

    rng = np.random.RandomState(seed)
    pre, cache = os.path.join(root, "preprocess"), os.path.join(root, "image_cache")
    os.makedirs(os.path.join(cache, "samples"), exist_ok=True)
    os.makedirs(pre)
    frames = [f"samples/CAM_FRONT_{i:02d}.jpg" for i in range(CLI_FRAMES)]
    for rel in frames:
        np.save(os.path.join(cache, rel + ".npy"),
                rng.randint(0, 256, (CLI_RESIZE[1], CLI_RESIZE[0], 3), dtype=np.uint8))
    with open(os.path.join(cache, "meta.json"), "w") as f:
        json.dump({"resize": list(CLI_RESIZE),
                   "orig_sizes": {rel: list(CLI_ORIG) for rel in frames}}, f)
    k = 0
    for split, n in (splits or CLI_SPLITS).items():
        scans = []
        for _ in range(n):
            scans.append(synthetic_scan(rng, frames[k % CLI_FRAMES]))
            k += 1
        with open(os.path.join(pre, split + ".pkl"), "wb") as f:
            pickle.dump(scans, f)
    return pre, cache


def assert_same_state(a: dict, b: dict, what: str) -> int:
    """Two snapshots or checkpoints bit-equal -> their tensor count."""
    from mm2d3d_tpu_torch.tools.train_repro import differing, tensor_leaves

    differ = differing(a, b)
    if differ:
        raise AssertionError(f"{what}: differ at {differ[:10]}")
    return len(dict(tensor_leaves(a)))


def cli_overrides(root: str, pre: str, cache: str, out: str) -> list:
    """Phase 10's overrides of configs/config.yaml: the synthetic tree's
    paths, `out` for the run, 1 epoch, 3 train and 2 eval batches, the
    loader workers."""
    return [f"dataset.{d}.{k}={v}" for d in ("source", "target")
            for k, v in (("preprocess_dir", pre), ("nuscenes_dir", root),
                         ("image_cache_dir", cache))] + [
        f"train.out_dir={out}", "run.max_epochs=1", "run.limit_train_batches=3",
        "run.limit_val_batches=2", f"train.num_workers={CLI_WORKERS}"]


def run_cli(dev, extra=(), what="phase 10", root=None):
    """configs/config.yaml as shipped (batch 16 per domain, n_points 8192,
    m=16, 7 planes, full_scale 4096, bf16, AdamW + OneCycle) through
    `mm2d3d_tpu_torch.run.main`, with the `extra` overrides: fit (3 train
    steps, validation and test on 2 batches each), then `run=test` with
    resume.  The synthetic tree and the run (``<root>/run``) are written
    under `root`, a temporary directory unless given."""
    import tempfile

    if root is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_cli(dev, extra, what, tmp)

    from mm2d3d_tpu_torch import run as cli
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools.train_repro import snapshot
    from mm2d3d_tpu_torch.train.step import MM2D3DTask

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "config.yaml")
    t0 = time.perf_counter()
    pre, cache = write_nuscenes_tree(root)
    out = os.path.join(root, "run")
    overrides = cli_overrides(root, pre, cache, out) + list(extra)
    log(f"synthetic nuScenes tree: {sum(CLI_SPLITS.values())} scans "
        f"{CLI_SPLITS}, {CLI_FRAMES} cached frames, "
        f"{time.perf_counter() - t0:.1f} s")

    # the end of each train step, after the device finished it: the
    # wall time per step of the trainer's own loop, loader included
    ends = []
    step = MM2D3DTask.train_step

    def timed_step(self, *a, **kw):
        logs = step(self, *a, **kw)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return logs

    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    MM2D3DTask.train_step = timed_step
    t_fit = time.perf_counter()
    try:
        fit, fit_results = cli.main(["--config", config, *overrides])
    finally:
        MM2D3DTask.train_step = step
    fit_s = time.perf_counter() - t_fit
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in ("bandmm", "bandmm_dw", "propagate", "maxpool"):
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no launch in the CLI run {launches}")
    if len(ends) != 3 or fit.global_step != 3:
        raise AssertionError(f"{len(ends)} train steps, global_step {fit.global_step}")

    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    train = [ln for ln in lines if "train/loss_total" in ln]
    evals = [ln for ln in lines if "val/target/iou" in ln]
    if len(train) != 3 or len(evals) != 1:
        raise AssertionError(f"{len(train)} train and {len(evals)} eval log lines")
    for ln in train:
        bad = {k: v for k, v in ln.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"step {ln['step']}: non-finite {bad}")
        for name in ("train/nbr_slot_overflow", "train/voxel_overflow_levels"):
            if ln[name] != 0:
                raise AssertionError(f"step {ln['step']}: {name} = {ln[name]}")
    for stage in ("val/target", "test/target"):
        for head in ("", "_3d", "_avg"):
            key = f"{stage}/iou{head}"
            if not 0 <= evals[0].get(key, -1) <= 1:
                raise AssertionError(f"{key}: {evals[0].get(key)}")
    ckpts = os.path.join(out, "ckpts")
    for name in ("last", "best_2d", "best_3d"):
        for ext in (".pt", ".meta.json"):
            if not os.path.exists(os.path.join(ckpts, name + ext)):
                raise AssertionError(f"no checkpoint {name}{ext}")
    # the figures as shipped: step 0 (train_log_images_step 2000) and
    # each eval loop's first batch (val_log_images_step 50)
    figures = sorted(os.listdir(os.path.join(out, "figures")))
    if figures != ["test_target_step3.png", "train_source_step0.png",
                   "train_target_step0.png", "val_target_step3.png"]:
        raise AssertionError(f"figures {figures}")
    log("fit: losses " + ", ".join(f"{ln['train/loss_total']:.4f}" for ln in train)
        + "; val IoU 2D/3D/avg " + "/".join(
            f"{evals[0][f'val/target/iou{h}']:.4f}" for h in ("", "_3d", "_avg"))
        + f"; checkpoints last, best_2d, best_3d; figures {figures}; launches "
        f"{launches}")

    kernels.reset_counts()
    tester, test_results = cli.main(["--config", config, *overrides, "run=test",
                                     "run.resume=true"])
    if tester.global_step != 3 or tester.start_epoch != 1:
        raise AssertionError(f"resumed at step {tester.global_step}, "
                             f"epoch {tester.start_epoch}")
    saved = torch.load(os.path.join(ckpts, "last.pt"), map_location=dev,
                       weights_only=True)
    resumed = snapshot(tester.task, tester.generator)
    n = assert_same_state(saved, resumed, "resumed vs saved")
    assert_same_state(snapshot(fit.task, fit.generator), resumed,
                      "resumed vs fitted")
    for head in ("", "_3d", "_avg"):
        key = f"test/target/iou{head}"
        if not 0 <= test_results.get(key, -1) <= 1:
            raise AssertionError(f"{key}: {test_results.get(key)}")
    log(f"run=test, resumed: all {n} tensors of `last` bit-equal to the fitted "
        "task's; test IoU 2D/3D/avg " + "/".join(
            f"{test_results[f'test/target/iou{h}']:.4f}" for h in ("", "_3d", "_avg"))
        + f"; launches {kernels.counts()}")

    ms = statistics.median([b - a for a, b in zip(ends, ends[1:])]) * 1e3
    scans = 2 * 16
    seconds = time.perf_counter() - t0
    log(f"CLI train step, bf16, batch 16 per domain: {ms:.2f} ms/step (median of "
        f"steps 2-3, trainer loop wall), {scans * 1e3 / ms:.1f} scans/s; from "
        f"main() to the end of step 1 {ends[0] - t_fit:.1f} s (set-up: task, "
        f"loader workers, first batches); fit + validation + test {fit_s:.1f} s; "
        f"peak memory {peak:.2f} GiB; {what} {seconds:.1f} s")
    return launches, ms, peak, seconds


# --------------------------------------------------------------------------
# phase 11: the KITTI-family configs through the port's CLI, at full width
# --------------------------------------------------------------------------

KITTI_CONFIGS = {  # config: (source tree, class count)
    "vkitti_skitti.yaml": ("virtual_kitti", 6),
    "a2d2.yaml": ("a2d2", 10),
}
# scans: 3 train steps at batch 16 per domain; 2 val and 2 test batches of 8
SKITTI_SPLITS = {"train": 48, "val": 16, "test": 16}
SOURCE_SCANS = 48
KITTI_FRAMES = 8  # distinct camera frames per tree, shared by the scans
SKITTI_HW, VKITTI_HW, A2D2_HW = (376, 1241), (375, 1242), (1208, 1920)
# camera (fx, fy, cx, cy) of each tree: KITTI's P2, vKITTI's fixed matrix,
# A2D2's front camera (the datasets' own constants for the last two)
SKITTI_CAM = (718.856, 718.856, 607.1928, 185.2157)
VKITTI_CAM = (725.0, 725.0, 620.5, 187.0)
A2D2_CAM = (1687.3369140625, 1783.428466796875, 965.43414055823814, 684.4193604186803)


def beam_scan(rng, cam, hw, n_range, height=1.73, max_r=80.0):
    """A 64-beam front-camera scan (camera frame: x right, y down, z
    forward): the HDL-64E's 64 rings from -0.43 to 0.035 rad, 1024 azimuths
    over the camera's view, a ground plane `height` below the sensor and
    eight walls at 4-60 m; rays with no return within `max_r`, and returns
    outside the `hw` frame, give no point; of the rest, `n_range` (lo, hi)
    are kept -> (pts_cam float32 (N, 3), points_img (row, col) float64)."""
    import numpy as np

    fx, fy, cx, cy = cam
    half = math.atan(max(cx, hw[1] - cx) / fx)
    elev, az = np.meshgrid(np.linspace(-0.43, 0.035, 64), np.linspace(-half, half, 1024),
                           indexing="ij")
    elev, az = elev.ravel(), az.ravel()
    with np.errstate(divide="ignore"):
        r = np.where(elev < -1e-3, height / np.tan(-elev), np.inf)
    for _ in range(8):
        hit = np.abs(az - (rng.rand() - 0.5) * 2 * half) < rng.rand() * 0.12 + 0.03
        r = np.where(hit, np.minimum(r, rng.rand() * 56 + 4), r)
    r = r + rng.randn(r.size) * 0.02
    pts = np.stack([r * np.cos(elev) * np.sin(az), -r * np.sin(elev),
                    r * np.cos(elev) * np.cos(az)], 1)
    with np.errstate(invalid="ignore"):
        col = fx * pts[:, 0] / pts[:, 2] + cx
        row = fy * pts[:, 1] / pts[:, 2] + cy
        ok = ((r >= 2.0) & (r <= max_r) & (row >= 0) & (row < hw[0] - 1)
              & (col >= 0) & (col < hw[1] - 1))
    keep = np.flatnonzero(ok)
    n = rng.randint(*n_range)
    if keep.size < n:
        raise AssertionError(f"a synthetic scan holds {keep.size} points in view, "
                             f"fewer than {n}")
    keep = np.sort(rng.choice(keep, size=n, replace=False))
    return pts[keep].astype(np.float32), np.stack([row[keep], col[keep]], 1)


def write_png(path: str, hw, rng) -> None:
    import numpy as np
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(
        path, compress_level=1)


def write_kitti_trees(root: str, seed: int = 0) -> dict:
    """The preprocessed trees the KITTI-family datasets read, under `root`:
    SemanticKITTI (`preprocess/{train,val,test}.pkl`, 1241x376 frames; raw
    label ids), VirtualKITTI (`preprocess/train.pkl` of world-frame points
    that project into its 1242x375 frames, every weather variant) and A2D2
    (`preprocess/train.pkl`, 1920x1208 frames) -> {tree: its root}."""
    import pickle

    import numpy as np

    from mm2d3d_tpu_torch.data.semantic_kitti import SemanticKITTI
    from mm2d3d_tpu_torch.data.virtual_kitti import WEATHERS

    rng = np.random.RandomState(seed)
    roots = {name: os.path.join(root, name)
             for name in ("semantic_kitti", "virtual_kitti", "a2d2")}
    for r in roots.values():
        os.makedirs(os.path.join(r, "preprocess"))

    def lidar(pts_cam):  # x forward, y left, z up
        return np.stack([pts_cam[:, 2], -pts_cam[:, 0], -pts_cam[:, 1]], 1)

    fx, fy, cx, cy = SKITTI_CAM
    ids = np.array(sorted(SemanticKITTI.id_to_class_name))
    frames = [f"sequences/08/image_2/{i:06d}.png" for i in range(KITTI_FRAMES)]
    for f in frames:
        write_png(os.path.join(roots["semantic_kitti"], f), SKITTI_HW, rng)
    k = 0
    for split, n in SKITTI_SPLITS.items():
        recs = []
        for _ in range(n):
            # 12,000-16,000 in view: the eval budget of 16,384 holds them
            pts_cam, points_img = beam_scan(rng, SKITTI_CAM, SKITTI_HW, (12000, 16001))
            recs.append({
                "points": lidar(pts_cam), "pts_cam_coord": pts_cam,
                "seg_labels": ids[rng.randint(0, ids.size, len(pts_cam))].astype(np.int32),
                "points_img": points_img, "camera_path": frames[k % KITTI_FRAMES],
                "lidar_path": f"sequences/08/velodyne/{k:06d}.bin",
                "intrinsics": np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]),
            })
            k += 1
        with open(os.path.join(roots["semantic_kitti"], "preprocess", split + ".pkl"),
                  "wb") as f:
            pickle.dump(recs, f)

    for w in WEATHERS:
        for i in range(KITTI_FRAMES):
            write_png(os.path.join(roots["virtual_kitti"], "vkitti_1.3.1_rgb", "0001", w,
                                   f"{i:05d}.png"), VKITTI_HW, rng)
    recs = []
    for i in range(SOURCE_SCANS):
        # more than the 10,000 points that `downsample: [10000]` draws
        pts_cam, _ = beam_scan(rng, VKITTI_CAM, VKITTI_HW, (10500, 14001))
        labels = rng.randint(0, 13, len(pts_cam))
        labels[rng.rand(len(pts_cam)) < 0.05] = 99  # the raw "Don't care" id
        recs.append({"points": lidar(pts_cam), "seg_labels": labels.astype(np.uint8),
                     "lidar_path": f"vkitti_npy/0001/{i:05d}.npy", "scene_id": "0001",
                     "frame_id": f"{i % KITTI_FRAMES:05d}"})
    with open(os.path.join(roots["virtual_kitti"], "preprocess", "train.pkl"), "wb") as f:
        pickle.dump(recs, f)

    for i in range(KITTI_FRAMES):
        write_png(os.path.join(roots["a2d2"], "camera", f"{i:06d}.png"), A2D2_HW, rng)
    recs = []
    for i in range(SOURCE_SCANS):
        # 4,000-7,500 in view: the SemanticKITTI train crops' density
        pts_cam, points_img = beam_scan(rng, A2D2_CAM, A2D2_HW, (4000, 7501))
        recs.append({"points": lidar(pts_cam), "pts_cam_coord": pts_cam,
                     "seg_labels": rng.randint(0, 55, len(pts_cam)).astype(np.uint8),
                     "points_img": points_img,
                     "camera_path": f"camera/{i % KITTI_FRAMES:06d}.png"})
    with open(os.path.join(roots["a2d2"], "preprocess", "train.pkl"), "wb") as f:
        pickle.dump(recs, f)
    return roots


def kitti_overrides(roots: dict, source: str, out: str) -> list:
    """Paths, and nothing cut but the number of steps and batches."""
    sk = roots["semantic_kitti"]
    src = roots[source]
    paths = [f"dataset.target.preprocess_dir={sk}/preprocess",
             f"dataset.target.semantic_kitti_dir={sk}"]
    if source == "virtual_kitti":
        paths += [f"dataset.source.preprocess_dir={src}/preprocess",
                  f"dataset.source.virtual_kitti_dir={src}"]
    else:
        paths += [f"dataset.source.preprocess_dir={src}"]
    return paths + [f"train.out_dir={out}", "run.max_epochs=1",
                    "run.limit_train_batches=3", "run.limit_val_batches=2"]


def check_hierarchy(hier, what: str) -> None:
    """Both overflow monitors of one topology: no level at capacity, no hit
    dropped by a slot table."""
    for l, lev in enumerate(hier.levels):
        if int(lev.num_voxels) >= lev.capacity:
            raise AssertionError(f"{what}: level {l} at capacity {lev.capacity}")
        if lev.slot_overflow is not None and int(lev.slot_overflow) != 0:
            raise AssertionError(f"{what}: level {l} dropped {int(lev.slot_overflow)} hits")


def run_kitti_config(dev, config: str, roots: dict, root: str, extra=()):
    """One KITTI-family config as shipped through `mm2d3d_tpu_torch.run.main`,
    with the `extra` overrides: fit (3 train steps, validation and test on 2
    batches each), then `run=test` with resume.  Every topology the task
    builds, and every one built on the host (`train.host_topology`) that a
    train step is handed, is kept, so the launches of K1-K4 are held
    against the hierarchies' prediction and both overflow monitors are read
    on every train step and eval batch."""
    from mm2d3d_tpu_torch import run as cli
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools.train_repro import snapshot
    from mm2d3d_tpu_torch.utils.config import load_config
    from mm2d3d_tpu_torch.train.step import MM2D3DTask

    source, n_classes = KITTI_CONFIGS[config]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", config)
    out = os.path.join(root, "run_" + os.path.splitext(config)[0]
                       + ("_extra" if extra else ""))
    overrides = kitti_overrides(roots, source, out) + list(extra)
    classes = load_config(path, overrides)["train"]["params"]["class_names"]

    # train-step ends; (kind, hierarchy) per topology: "train", "eval" and
    # "viz" (a figure's forward) built by the task, "host" built on the host
    # for a train step
    ends, builds, in_viz = [], [], []
    step, build, viz = (MM2D3DTask.train_step, MM2D3DTask.build_topology,
                        MM2D3DTask.viz_forward)

    def timed_step(self, src, trg, gen, *topos):
        builds.extend(("host", t[1]) for t in topos if t is not None)
        logs = step(self, src, trg, gen, *topos)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return logs

    def kept_build(self, batch):
        topo = build(self, batch)
        builds.append(("viz" if in_viz else "eval" if torch.is_inference_mode_enabled()
                       else "train", topo[1]))
        return topo

    def kept_viz(self, *a, **kw):
        in_viz.append(True)
        try:
            return viz(self, *a, **kw)
        finally:
            in_viz.pop()

    def expected(kept):
        exp = no_launches()
        for kind, hier in kept:
            one = (expected_launches(hier) if kind in ("eval", "viz") else
                   expected_train_launches([hier], host_built=kind == "host"))
            for name, n in one.items():
                exp[name] += n
        return exp

    MM2D3DTask.train_step, MM2D3DTask.build_topology = timed_step, kept_build
    MM2D3DTask.viz_forward = kept_viz
    try:
        kernels.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t_fit = time.perf_counter()
        fit, _ = cli.main(["--config", path, *overrides])
        fit_s = time.perf_counter() - t_fit
        launches = kernels.counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        fit_builds = builds[:]
        builds.clear()
        kernels.reset_counts()
        tester, test_results = cli.main(["--config", path, *overrides, "run=test",
                                         "run.resume=true"])
        test_launches = kernels.counts()
    finally:
        MM2D3DTask.train_step, MM2D3DTask.build_topology = step, build
        MM2D3DTask.viz_forward = viz
    test_builds = builds

    if fit.task.slot_profile != "dense":
        raise AssertionError(f"{config}: slot profile {fit.task.slot_profile}")
    kinds = [k for k, _ in fit_builds]
    n_train = kinds.count("train") + kinds.count("host")
    n_host = kinds.count("host")
    if len(ends) != 3 or fit.global_step != 3 or n_train != 6 or \
            n_host != (6 if fit.host_topology else 0):
        raise AssertionError(f"{config}: {len(ends)} train steps, global_step "
                             f"{fit.global_step}, {n_train} train topologies, "
                             f"{n_host} of them built on the host")
    # the figures: step 0's two batches (train_log_images_step 2000) and the
    # first batch of each eval loop (val_log_images_step 50)
    test_kinds = sorted(k for k, _ in test_builds)
    if kinds.count("eval") != 6 or kinds.count("viz") != 5 or \
            test_kinds != ["eval", "eval", "viz"]:
        raise AssertionError(f"{config}: {kinds.count('eval')} eval batches in the "
                             f"fit (2 val, 2 + 2 test), {kinds.count('viz')} figures "
                             f"(2 train, 3 eval); the resumed test {test_kinds}")
    figures = sorted(os.listdir(os.path.join(out, "figures")))
    if figures != ["test_target_step3.png", "train_source_step0.png",
                   "train_target_step0.png", "val_target_step3.png"]:
        raise AssertionError(f"{config}: figures {figures}")
    for i, (kind, hier) in enumerate(fit_builds + test_builds):
        check_hierarchy(hier, f"{config} {kind} topology {i}")
    check_counts(launches, expected(fit_builds), f"{config} fit")
    check_counts(test_launches, expected(test_builds), f"{config} resumed test")

    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    train = [ln for ln in lines if "train/loss_total" in ln]
    evals = [ln for ln in lines if "val/target/iou" in ln]
    if len(train) != 3 or len(evals) != 1:
        raise AssertionError(f"{config}: {len(train)} train and {len(evals)} eval "
                             "log lines")
    for ln in train:
        bad = {k: v for k, v in ln.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"{config} step {ln['step']}: non-finite {bad}")
        for name in ("train/nbr_slot_overflow", "train/voxel_overflow_levels"):
            if ln[name] != 0:
                raise AssertionError(f"{config} step {ln['step']}: {name} = {ln[name]}")
    for stage in ("val/target", "test/target"):
        if evals[0][f"{stage}/nbr_slot_overflow"] != 0:
            raise AssertionError(f"{config}: {stage} dropped slot hits")
        if evals[0][f"{stage}/points_dropped"] != 0:
            raise AssertionError(f"{config}: {stage} cut points at the eval budget")
        for head in ("", "_3d", "_avg"):
            key = f"{stage}/iou{head}"
            if not 0 <= evals[0].get(key, -1) <= 1:
                raise AssertionError(f"{config} {key}: {evals[0].get(key)}")
    if fit.class_names != classes or len(classes) != n_classes or \
            tester.class_names != classes:
        raise AssertionError(f"{config}: class names {fit.class_names}, config "
                             f"{classes}")
    ckpts = os.path.join(out, "ckpts")
    for name in ("last", "best_2d", "best_3d"):
        for ext in (".pt", ".meta.json"):
            if not os.path.exists(os.path.join(ckpts, name + ext)):
                raise AssertionError(f"{config}: no checkpoint {name}{ext}")
    if tester.global_step != 3 or tester.start_epoch != 1:
        raise AssertionError(f"{config}: resumed at step {tester.global_step}, "
                             f"epoch {tester.start_epoch}")
    saved = torch.load(os.path.join(ckpts, "last.pt"), map_location=dev,
                       weights_only=True)
    resumed = snapshot(tester.task, tester.generator)
    n = assert_same_state(saved, resumed, f"{config} resumed vs saved")
    assert_same_state(snapshot(fit.task, fit.generator), resumed,
                      f"{config} resumed vs fitted")
    for head in ("", "_3d", "_avg"):
        key = f"test/target/iou{head}"
        if not 0 <= test_results.get(key, -1) <= 1:
            raise AssertionError(f"{config} {key}: {test_results.get(key)}")

    ms = statistics.median([b - a for a, b in zip(ends, ends[1:])]) * 1e3
    log(f"{config}: losses " + ", ".join(f"{ln['train/loss_total']:.4f}" for ln in train)
        + f"; {n_classes} classes {classes}; val IoU 2D/3D/avg " + "/".join(
            f"{evals[0][f'val/target/iou{h}']:.4f}" for h in ("", "_3d", "_avg"))
        + f"; both monitors 0 on {n_train} train and {kinds.count('eval') + 2} "
        f"eval topologies; figures {figures}; checkpoints last, best_2d, best_3d; "
        f"resumed: all {n} "
        f"tensors of `last` bit-equal; fit launches {launches} (as predicted), "
        f"resumed test {test_launches}")
    log(f"{config}{' ' + ' '.join(extra) if extra else ''} train step, bf16, batch "
        f"16 per domain: {ms:.2f} ms/step (median "
        f"of steps 2-3, trainer loop wall), {32 * 1e3 / ms:.1f} scans/s; from main() "
        f"to the end of step 1 {ends[0] - t_fit:.1f} s; fit + validation + test "
        f"{fit_s:.1f} s; peak memory {peak:.2f} GiB")
    return launches, ms, peak


def check_kitti_topology_and_forward(dev) -> None:
    """On 64-beam scans (`make_batch(variant="kitti")`): at the train step's
    16 x 10,240 points the dense profile's tables identical on the card and
    on the CPU, with no hit dropped, where the default profile drops hits;
    the card's fp32 forward under the dense profile at batch 2 within
    1e-3 * max|CPU| of the CPU's."""
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.tools.kernel_cases import KITTI_BATCH, kitti_batch
    from mm2d3d_tpu_torch.train.batch import build_topology

    batch = kitti_batch(0, KITTI_BATCH, "cpu")
    n_tables = compare_topology(batch, dev, slot_profile="dense")
    dropped = {}
    for profile in ("dense", "default"):
        _, hier = build_topology(batch.to(dev), 4096, 7, slot_profile=profile)
        dropped[profile] = sum(int(l.slot_overflow) for l in hier.levels
                               if l.slot_overflow is not None)
    if dropped["dense"] != 0 or dropped["default"] <= 0:
        raise AssertionError(f"hits dropped at batch {KITTI_BATCH}: {dropped}")
    log(f"64-beam batch {KITTI_BATCH} x 10240: {n_tables} dense-profile tables "
        f"identical card vs CPU; hits dropped: dense 0, default {dropped['default']}")

    outs = []  # card, CPU
    batch = kitti_batch(1, 2, "cpu")
    for d in (dev, torch.device("cpu")):
        task = flagship_task(compute_dtype=torch.float32, device=d, slot_profile="dense")
        task.init_params(torch.Generator().manual_seed(3))
        outs.append(task.forward(batch.to(d)))
    for name in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        a, b = outs[0][name].cpu(), outs[1][name]
        err = float((a - b).abs().max())
        tol = LOGIT_REL_TOL * float(b.abs().max())
        log(f"  dense profile, fp32, batch 2: {name} max|card - CPU| = {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name}: card vs CPU {err} > {tol}")


def run_kitti(dev):
    """Phase 11 -> ({config: launches}, {config: ms per step}, {config: peak
    GiB}, seconds)."""
    import tempfile

    t0 = time.perf_counter()
    check_kitti_topology_and_forward(dev)
    launches, ms, peak = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        roots = write_kitti_trees(root)
        log(f"synthetic trees: SemanticKITTI {SKITTI_SPLITS}, VirtualKITTI and A2D2 "
            f"{SOURCE_SCANS} scans each, {KITTI_FRAMES} frames per tree, "
            f"{time.perf_counter() - t1:.1f} s")
        for config in KITTI_CONFIGS:
            launches[config], ms[config], peak[config] = run_kitti_config(
                dev, config, roots, root)
    return launches, ms, peak, time.perf_counter() - t0


# --------------------------------------------------------------------------
# phase 12: the training options: host topologies, child slots, frozen batch
# norm, residual blocks, gradient accumulation
# --------------------------------------------------------------------------

def check_host_topologies(dev) -> dict:
    """(a) Host-built topologies (`data.host_topology`, C++) copied to the
    card equal the card's `build_topology`, table by table: the flagship
    batch (default profile) and a 64-beam batch of 16 x 10,240 points
    (dense profile).  Times the host build alone, three at once (the
    loader's thread pool; each call's OpenMP loops use every core) and the
    card's build (host wall after a synchronise).  -> {case: ms}"""
    from concurrent.futures import ThreadPoolExecutor

    from mm2d3d_tpu_torch import native
    from mm2d3d_tpu_torch.data.host_topology import to_device, topology_for_batch
    from mm2d3d_tpu_torch.tools.kernel_cases import KITTI_BATCH, kitti_batch
    from mm2d3d_tpu_torch.train.batch import build_topology

    t0 = time.perf_counter()
    native.lib()
    log(f"host topology library: {os.path.basename(native.library_path())}, built or "
        f"loaded in {time.perf_counter() - t0:.1f} s; {os.cpu_count()} host cores")
    out = {}
    for name, batch, profile in (
            (f"flagship batch {BATCH}", flagship_batch(0, BATCH, "cpu"), "default"),
            (f"64-beam batch {KITTI_BATCH} x 10240", kitti_batch(0, KITTI_BATCH, "cpu"),
             "dense")):
        def host():
            return topology_for_batch(batch, 4096, 7, slot_profile=profile)

        on_card = to_device(host(), dev)
        with torch.no_grad():
            card = build_topology(batch.to(dev), 4096, 7, slot_profile=profile)
        n = same_tables(on_card, card, f"host vs card, {name}")
        check_hierarchy(on_card[1], f"host topology, {name}")
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            host()
            samples.append(time.perf_counter() - t0)
        alone = statistics.median(samples) * 1e3
        with ThreadPoolExecutor(3) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda _: host(), range(6)))
            pooled = (time.perf_counter() - t0) / 6 * 1e3
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                build_topology(batch.to(dev), 4096, 7, slot_profile=profile)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        card_ms = statistics.median(samples) * 1e3
        built = host()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device(built, dev)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        log(f"{name} ({profile} profile): {n} host-built tables identical to the "
            f"card's; host build {alone:.2f} ms alone (median of 3), {pooled:.2f} ms "
            f"per topology with 3 at once; pack and copy to the card {copy_ms:.2f} ms; "
            f"the card's build {card_ms:.2f} ms (host wall, batch on the card)")
        out[profile] = {"host_ms": alone, "host_ms_3_threads": pooled,
                        "card_build_ms": card_ms}
    return out


def check_host_train_step(dev) -> dict:
    """(b) One bf16 train step at batch 8 per domain from one state, with the
    card's topologies and with host-built ones copied to the card: the same
    bits in every tensor phase 6 counts.  Then the step's time with each
    (the host-built topologies ready before the step, as the loader's
    prefetch has them), in turns."""
    from mm2d3d_tpu_torch.data.host_topology import to_device, topology_for_batch
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.tools.train_repro import (
        differing, restore, snapshot, tensor_leaves)

    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    cpu = [flagship_batch(s, BATCH, "cpu") for s in (10, 11)]
    src, trg = (b.to(dev) for b in cpu)

    def host_topos():
        return [to_device(topology_for_batch(b, 4096, 7), dev) for b in cpu]

    check_train_logs(task.train_step(src, trg, gen))  # warm-up
    saved = snapshot(task, gen)
    outs = []
    for topos in ([None, None], host_topos()):
        restore(task, gen, saved)
        logs = task.train_step(src, trg, gen, *topos)
        torch.cuda.synchronize()
        check_train_logs(logs)
        outs.append({**snapshot(task, gen),
                     "logs": {k: v.detach().clone() for k, v in logs.items()}})
    differ = differing(*outs)
    n = len(dict(tensor_leaves(outs[0])))
    if differ:
        raise AssertionError(f"host vs card topologies: {len(differ)} of {n} tensors "
                             f"differ: {differ[:10]}")
    log(f"bf16 train step batch {BATCH} per domain from one state, card-built vs "
        f"host-built topologies: all {n} tensors bit-identical")
    topos = host_topos()
    ms = {"card topologies": [], "host topologies": []}
    for name in ("card topologies", "host topologies") * 2:
        args = [None, None] if name == "card topologies" else topos
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            task.train_step(src, trg, gen, *args)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / 5 * 1e3)
    log("train step ms (2 samples of 5 steps each, in turns): " + "; ".join(
        f"{k} {', '.join(f'{x:.2f}' for x in v)}" for k, v in ms.items()))
    return {k: statistics.mean(v) for k, v in ms.items()}


def run_child_slots(res: Results, dev) -> dict:
    """(d) The strided convs over child slots at the flagship: K1 and K2 with
    K = 8 against their plain versions (two calls bit-identical), launch
    counts of two eval forwards and two train steps equal to the
    hierarchies' prediction, both monitors 0; then the card's fp32 forward
    and train step against the CPU's at phase 5's and 7's tolerances.
    -> launches of the train steps."""
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.ops.kernels.bandmm import slot_conv_apply, slot_conv_apply_ref
    from mm2d3d_tpu_torch.ops.kernels.bandmm_dw import slot_conv_dw, slot_conv_dw_ref
    from mm2d3d_tpu_torch.tools.kernel_cases import child_slot_forms

    for dt in (torch.bfloat16, torch.float32):
        for name, (xs, tap, w, g), k in child_slot_forms(dev):
            xs, w, g = (t.to(dt).contiguous() for t in (xs, w, g))
            for kernel, fn, ref_fn, other in (
                    ("bandmm", lambda: slot_conv_apply(None, xs, tap, w),
                     lambda: slot_conv_apply_ref(None, xs, tap, w), w),
                    ("bandmm_dw", lambda: slot_conv_dw(None, xs, tap, g, k_taps=k),
                     lambda: slot_conv_dw_ref(None, xs, tap, g, k_taps=k), g)):
                out, again = fn(), fn()
                if not torch.equal(out, again):
                    raise AssertionError(f"{kernel} {name} {dt}: two calls differ")
                ref = ref_fn()
                err = float((out - ref).abs().max())
                route = slot_route(dt, xs.shape[2], xs.shape[0], k)
                res.add(kernel, f"{name} {str(dt)[6:]} V={xs.shape[1]} [{route}]", err,
                        K1_REL_TOL * float(ref.abs().max()), cuda_ms(fn),
                        cuda_ms(ref_fn, reps=10),
                        slot_bound(None, xs, tap, other, out, k, dt))

    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    batches = [flagship_batch(s, BATCH, dev) for s in range(2)]
    task.eval_step(batches[0], topo=child_slot_topology(batches[0]))  # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    runs = []
    for b in batches:
        topo = child_slot_topology(b)
        runs.append((task.eval_step(b, topo=topo)[1], topo[1]))
    torch.cuda.synchronize()
    launches = kernels.counts()
    expected = dict.fromkeys(launches, 0)
    for logs, hier in runs:
        if float(logs["nbr_slot_overflow"]) != 0:
            raise AssertionError("child slots: eval dropped hits")
        check_hierarchy(hier, "child slots, eval")
        for k, n in expected_launches(hier).items():
            expected[k] += n
    check_counts(launches, expected, "child slots eval")
    log(f"child slots, eval: launch counts over {len(batches)} forwards {launches} "
        "(as predicted)")

    gen = torch.Generator(device=dev).manual_seed(0)
    src, trg = flagship_batch(10, BATCH, dev), flagship_batch(11, BATCH, dev)

    def step():
        ts, tt = child_slot_topology(src), child_slot_topology(trg)
        return task.train_step(src, trg, gen, ts, tt), (ts[1], tt[1])

    check_train_logs(step()[0])
    torch.cuda.synchronize()
    kernels.reset_counts()
    hiers = []
    for _ in range(2):
        logs, hs = step()
        check_train_logs(logs)
        hiers += hs
    torch.cuda.synchronize()
    train_launches = kernels.counts()
    for h in hiers:
        check_hierarchy(h, "child slots, train")
        for t in h.transitions:
            if int(t.cslot_overflow) != 0:
                raise AssertionError(f"child slots dropped {int(t.cslot_overflow)}")
    check_counts(train_launches, expected_train_launches(hiers), "child slots train")
    log(f"child slots, train: launch counts over 2 steps {train_launches} (as "
        "predicted); both monitors 0")
    samples = {"plain child tables": [], "child slots": []}
    for name in list(samples) * 2:
        topo = (lambda b: None) if name == "plain child tables" else child_slot_topology
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            for b in batches:
                task.forward(b, topo=topo(b))
        torch.cuda.synchronize()
        samples[name].append((time.perf_counter() - t0) / 6 * 1e3)
    log(f"eval forward ms per batch of {BATCH} (2 samples of 6, in turns), topology "
        "included: " + "; ".join(f"{k} {', '.join(f'{x:.2f}' for x in v)}"
                                 for k, v in samples.items()))
    compare_card_cpu(dev, child_slots=True)
    # phase 9's seeds: at phase 7's, one L0 ReLU input lies within rounding
    # of its kink, and the CPU's child-slot sums put it on the other side
    # from the card's (as the CPU's dense sums do; compare_train_card_cpu)
    compare_train_card_cpu(dev, seeds=(20, 21), child_slots=True)
    return train_launches


OPTION_SPLITS = {"train_usa": 64, "train_singapore": 64, "val_singapore": 32,
                 "test_singapore": 32}  # 4 train pairs of 16
OPTIONS = ["models.net2d.frozen_batch_norm=true",
           "models.net3d.backbone_3d.residual_blocks=true",
           "models.net2d.optimizer.accumulate_steps=2",
           "models.net3d.optimizer.accumulate_steps=2"]


def run_options_cli(dev) -> dict:
    """(e) configs/config.yaml with frozen batch norm, residual blocks and
    accumulate_steps=2 on both branches through the CLI: 4 train steps (2
    updates) with finite losses, K1-K4's launches equal to the prediction
    with the residual blocks' second conv, no level at capacity, and each
    step's slot monitor equal to the hits its two topologies' tables
    dropped (the default slot plan drops some at level 4 on one of these
    synthetic batches: reported, not hidden); then a fit of 3 steps, whose
    `last` lies between two micro-steps, and `run=test` resumed from it:
    bit-equal.  -> the 4-step fit's launches and the hits dropped per
    step."""
    import tempfile

    from mm2d3d_tpu_torch import run as cli
    from mm2d3d_tpu_torch.models.resnet2d import ConvBN
    from mm2d3d_tpu_torch.models.sparse_unet import ResidualBlock
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools.train_repro import snapshot
    from mm2d3d_tpu_torch.train.optim import MultiSteps
    from mm2d3d_tpu_torch.train.step import MM2D3DTask

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "config.yaml")
    builds = []
    build = MM2D3DTask.build_topology

    def kept_build(self, batch):
        topo = build(self, batch)
        builds.append((not torch.is_inference_mode_enabled(), topo[1]))
        return topo

    with tempfile.TemporaryDirectory() as root:
        pre, cache = write_nuscenes_tree(root, seed=1, splits=OPTION_SPLITS)
        paths = [f"dataset.{d}.{k}={v}" for d in ("source", "target")
                 for k, v in (("preprocess_dir", pre), ("nuscenes_dir", root),
                              ("image_cache_dir", cache))]
        common = paths + OPTIONS + ["run.max_epochs=1", "run.limit_val_batches=2",
                                    f"train.num_workers={CLI_WORKERS}"]
        out4, out3 = os.path.join(root, "run4"), os.path.join(root, "run3")
        MM2D3DTask.build_topology = kept_build
        try:
            kernels.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fit, _ = cli.main(["--config", config, *common, f"train.out_dir={out4}",
                               "run.limit_train_batches=4"])
            fit_s = time.perf_counter() - t0
            launches = kernels.counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            MM2D3DTask.build_topology = build
        task = fit.task
        if fit.global_step != 4 or task.step != 4:
            raise AssertionError(f"options fit: global_step {fit.global_step}")
        if not (isinstance(task.opt2d, MultiSteps) and isinstance(task.opt3d, MultiSteps)
                and task.opt2d.k == task.opt3d.k == 2 and task.opt2d.mini_step == 0):
            raise AssertionError("options fit: no gradient accumulation")
        if not all(m.frozen for m in task.model2d.rgb_backbone.modules()
                   if isinstance(m, ConvBN)) or not any(
                isinstance(m, ResidualBlock) for m in task.model3d.modules()):
            raise AssertionError("options fit: frozen batch norm or residual blocks off")
        exp = dict.fromkeys(launches, 0)
        for train, hier in builds:
            for l, lev in enumerate(hier.levels):
                if int(lev.num_voxels) >= lev.capacity:
                    raise AssertionError(f"options fit: level {l} at capacity")
            one = (expected_train_launches([hier], residual=True, frozen_bn=True)
                   if train else expected_launches(hier, residual=True))
            for name, n in one.items():
                exp[name] += n
        if sum(t for t, _ in builds) != 8:
            raise AssertionError(f"options fit: {len(builds)} topologies")
        check_counts(launches, exp, "options fit")
        with open(os.path.join(out4, "metrics.jsonl")) as f:
            train = [ln for ln in map(json.loads, f) if "train/loss_total" in ln]
        if len(train) != 4:
            raise AssertionError(f"options fit: {len(train)} train log lines")
        drops = [sum(int(t) for t in [lev.slot_overflow for lev in h.levels]
                     + [tr.cslot_overflow for tr in h.transitions] if t is not None)
                 for t_, h in builds if t_]
        per_step = [drops[2 * i] + drops[2 * i + 1] for i in range(4)]
        for ln, dropped in zip(train, per_step):
            bad = {k: v for k, v in ln.items() if not math.isfinite(v)}
            if bad:
                raise AssertionError(f"options step {ln['step']}: non-finite {bad}")
            if ln["train/voxel_overflow_levels"] != 0 or \
                    ln["train/nbr_slot_overflow"] != dropped:
                raise AssertionError(f"options step {ln['step']}: monitors "
                                     f"{ln['train/voxel_overflow_levels']}, "
                                     f"{ln['train/nbr_slot_overflow']} vs {dropped}")
        log(f"options fit (frozen batch norm, residual blocks, accumulate_steps=2): "
            f"4 steps, 2 updates, losses " + ", ".join(
                f"{ln['train/loss_total']:.4f}" for ln in train)
            + f"; launches {launches} (as predicted, the residual blocks' second "
            f"conv included); hits dropped by the slot tables per step {per_step} "
            f"(= train/nbr_slot_overflow), no level at capacity; fit + validation + "
            f"test {fit_s:.1f} s; peak memory {peak:.2f} GiB")

        odd, _ = cli.main(["--config", config, *common, f"train.out_dir={out3}",
                           "run.limit_train_batches=3"])
        if odd.global_step != 3 or odd.task.opt3d.mini_step != 1:
            raise AssertionError(f"3-step fit: step {odd.global_step}, micro-step "
                                 f"{odd.task.opt3d.mini_step}")
        tester, results = cli.main(["--config", config, *common, f"train.out_dir={out3}",
                                    "run=test", "run.resume=true"])
        saved = torch.load(os.path.join(out3, "ckpts", "last.pt"), map_location=dev,
                           weights_only=True)
        resumed = snapshot(tester.task, tester.generator)
        n = assert_same_state(saved, resumed, "options resumed vs saved")
        assert_same_state(snapshot(odd.task, odd.generator), resumed,
                          "options resumed vs fitted")
        if tester.task.opt3d.mini_step != 1:
            raise AssertionError("resumed at another micro-step")
        log(f"options, `last` after step 3 (between two micro-steps): run=test resumed "
            f"from it, all {n} tensors (the accumulated gradients and micro-step "
            f"counts included) bit-equal; test IoU 2D/3D/avg " + "/".join(
                f"{results[f'test/target/iou{h}']:.4f}" for h in ("", "_3d", "_avg")))
    return {"launches": launches, "peak": peak, "dropped_per_step": per_step}


def run_options(res: Results, dev, cli_ms: float, kitti_ms: dict) -> dict:
    """Phase 12 -> what the JSON line and the summary report."""
    import tempfile

    t0 = time.perf_counter()
    log("phase 12a: host-built topologies vs the card's")
    host = check_host_topologies(dev)
    log("phase 12b: bf16 train step with host-built topologies")
    step_ms = check_host_train_step(dev)
    log("phase 12c: the CLI with train.host_topology=true")
    _, host_cli_ms, host_cli_peak, _ = run_cli(dev, ["train.host_topology=true"],
                                               "phase 12c")
    with tempfile.TemporaryDirectory() as root:
        roots = write_kitti_trees(root)
        _, host_kitti_ms, host_kitti_peak = run_kitti_config(
            dev, "vkitti_skitti.yaml", roots, root, ["train.host_topology=true"])
    log(f"CLI ms/step with host topologies vs the card's (phases 10, 11 in this "
        f"call): config.yaml {host_cli_ms:.2f} vs {cli_ms:.2f}; vkitti_skitti.yaml "
        f"{host_kitti_ms:.2f} vs {kitti_ms['vkitti_skitti.yaml']:.2f}; peak memory "
        f"{host_cli_peak:.2f} and {host_kitti_peak:.2f} GiB")
    log("phase 12d: the strided convs over child slots")
    child_launches = run_child_slots(res, dev)
    log("phase 12e: frozen batch norm, residual blocks, accumulate_steps=2 "
        "through the CLI")
    options = run_options_cli(dev)
    seconds = time.perf_counter() - t0
    log(f"phase 12: {seconds:.1f} s")
    return {"host": host, "step_ms": step_ms, "host_cli_ms": host_cli_ms,
            "host_kitti_ms": host_kitti_ms, "child_launches": child_launches,
            "options": options, "seconds": seconds}


# --------------------------------------------------------------------------
# phase 13: data parallelism, one process per rank (parallel/mesh.py)
# --------------------------------------------------------------------------

DP_RANKS = 2
DP_TIMEOUT_S = 300  # each launch of the ranks
DP_SEEDS = (20, 21)  # 13b's fp32 pair: phase 9's seeds (phase 7's hold a ReLU kink)
DP_CLI_BATCH = 16  # 13c's global batch per domain, config.yaml's


def check_nccl_world_of_one(dev) -> int:
    """13a: the bf16 train step at batch 8 per domain in an NCCL group of
    one, in this process, against the plain step from the same state: every
    tensor bit-identical.  -> the tensors compared."""
    import torch.distributed as dist

    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.parallel import mesh
    from mm2d3d_tpu_torch.tools.ddp_check import free_port
    from mm2d3d_tpu_torch.tools.train_repro import (
        differing, restore, snapshot, tensor_leaves)

    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    src, trg = flagship_batch(10, BATCH, dev), flagship_batch(11, BATCH, dev)
    check_train_logs(task.train_step(src, trg, gen))  # optimizer moments
    start = snapshot(task, gen)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    outs = []
    try:
        for group in (False, True):
            restore(task, gen, start)
            if group:
                if mesh.init_process_group("cuda") != dev or dist.get_backend() != "nccl":
                    raise AssertionError(f"backend {dist.get_backend()}, not NCCL on {dev}")
                task.group = dist.group.WORLD
            logs = task.train_step(src, trg, gen)
            torch.cuda.synchronize()
            check_train_logs(logs)
            outs.append({**snapshot(task, gen),
                         "logs": {k: v.detach().clone() for k, v in logs.items()}})
    finally:
        task.group = None
        mesh.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    differ = differing(*outs)
    n = len(dict(tensor_leaves(outs[0])))
    if differ:
        raise AssertionError(f"NCCL world of one vs the plain step: {len(differ)} of {n} "
                             f"tensors differ: {differ[:10]}")
    log(f"13a: bf16 train step batch {BATCH} per domain, NCCL group of one vs no group: "
        f"all {n} tensors (weights, running statistics, optimizer moments, dropout "
        "generator, logs) bit-identical; group destroyed")
    return n


def check_two_ranks(dev) -> dict:
    """13b: two ranks sharing the card over gloo (`tools/ddp_check.py step`).
    One fp32 step at phase 7's size (COMPARE_BATCH scans per domain over
    the two ranks, dropout off), held against the same two ranks on the
    CPU with phase 7's tolerances; then two bf16 steps at batch 4 per rank
    per domain, the ranks bit-identical to each other."""
    import tempfile

    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.tools import ddp_check

    def ranks_identical(ranks, what):
        r0 = ranks[0]
        for r in ranks[1:]:
            differ = sorted(k for k in set(r0) | set(r)
                            if k not in r or k not in r0 or not (r[k] == r0[k]).all())
            if differ:
                raise AssertionError(f"{what}: ranks differ at {differ[:10]}")
        return len(r0)

    out = {}
    with tempfile.TemporaryDirectory() as root:
        task = flagship_task(compute_dtype=torch.float32, device="cpu")
        task.init_params(torch.Generator().manual_seed(3))
        src, trg = (flagship_batch(s, COMPARE_BATCH, "cpu") for s in DP_SEEDS)
        inputs = os.path.join(root, "fp32.npz")
        ddp_check.write_inputs(inputs, task.model2d.state_dict(), task.model3d.state_dict(),
                               [src, trg], {"task": {"compute_dtype": "float32"},
                                            "pairs": [[0, 1]], "dropout": False,
                                            "seed": 0})
        def run(d):
            t0 = time.perf_counter()
            ddp_check.launch(["step", inputs, os.path.join(root, d), "--device", d],
                             nproc=DP_RANKS, timeout_s=DP_TIMEOUT_S,
                             env={"OMP_NUM_THREADS": "3"})
            return time.perf_counter() - t0

        # the card's ranks and the CPU's at once: both launches wait mostly
        # on start-up and the host
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            seconds = dict(zip(("cuda", "cpu"), pool.map(run, ("cuda", "cpu"))))
        ranks = {}
        for d in ("cuda", "cpu"):
            ranks[d] = ddp_check.read_ranks(os.path.join(root, d, "rank*.npz"))
            n = ranks_identical(ranks[d], f"fp32 {d}")
            log(f"13b: fp32 step, {COMPARE_BATCH} scans per domain over {DP_RANKS} ranks "
                f"on the {d} (gloo): ranks bit-identical ({n} arrays), "
                f"{seconds[d]:.1f} s with start-up (both launches at once)")
        gpu, cpu = ranks["cuda"][0], ranks["cpu"][0]
        for k in sorted(k for k in cpu if k.startswith("log0/")):
            a, b = float(gpu[k]), float(cpu[k])
            if abs(a - b) > LOGIT_REL_TOL * abs(b):
                raise AssertionError(f"13b {k}: card {a} vs CPU {b}")
        worst = []
        for branch in ("model2d", "model3d"):
            keys = [k for k in cpu if k.startswith(f"grad/{branch}/")]
            top = max(float(abs(cpu[k]).max()) for k in keys)
            worst += [(float(abs(gpu[k] - cpu[k]).max()) / top, k) for k in keys]
        worst.sort(reverse=True)
        log("13b: card vs CPU, both over 2 ranks: every log within 1e-3 relative; worst "
            "averaged gradients (/ max|CPU gradient of the branch|): "
            + "; ".join(f"{k[5:]} {e:.2e}" for e, k in worst[:3]))
        if worst[0][0] > LOGIT_REL_TOL:
            raise AssertionError(f"13b {worst[0][1]}: {worst[0][0]} > {LOGIT_REL_TOL}")
        out["fp32_worst_grad"] = worst[0][0]

        task = flagship_task(device="cpu")
        task.init_params(torch.Generator().manual_seed(0))
        inputs = os.path.join(root, "bf16.npz")
        ddp_check.write_inputs(
            inputs, task.model2d.state_dict(), task.model3d.state_dict(),
            [flagship_batch(s, DP_RANKS * 4, "cpu") for s in (10, 11)],
            {"task": {"compute_dtype": "bfloat16"}, "pairs": [[0, 1], [0, 1]],
             "dropout": True, "seed": 0})
        t0 = time.perf_counter()
        ddp_check.launch(["step", inputs, os.path.join(root, "bf16"), "--device", "cuda"],
                         nproc=DP_RANKS, timeout_s=DP_TIMEOUT_S)
        ranks = ddp_check.read_ranks(os.path.join(root, "bf16", "rank*.npz"))
        n = ranks_identical(ranks, "bf16")
        losses = [float(ranks[0][f"log{s}/train/loss_total"]) for s in range(2)]
        for k, v in ranks[0].items():
            if k.startswith("log") and not math.isfinite(float(v)):
                raise AssertionError(f"13b bf16 {k}: {float(v)}")
            if k.endswith(("nbr_slot_overflow", "voxel_overflow_levels")) and float(v):
                raise AssertionError(f"13b bf16 {k}: {float(v)}")
        log(f"13b: two bf16 steps at batch 4 per rank per domain, {DP_RANKS} ranks on the "
            f"card (gloo): ranks bit-identical ({n} arrays), loss_total "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f", monitors 0; {time.perf_counter() - t0:.1f} s with start-up")
    return out


def run_cli_data_parallel(dev) -> dict:
    """13c: configs/config.yaml through the CLI under torchrun with two
    ranks sharing the card (gloo), global batch 16 per domain, over phase
    10's synthetic tree: fit (3 steps, validation and test on 2 global
    batches), then `run=test` with resume.  Each rank runs through
    `tools/ddp_check.py cli`, which keeps the topologies its task builds."""
    import tempfile

    from mm2d3d_tpu_torch.tools import ddp_check

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                          "config.yaml")
    with tempfile.TemporaryDirectory() as root:
        pre, cache = write_nuscenes_tree(root)
        out = os.path.join(root, "run")
        argv = ["--config", config, *cli_overrides(root, pre, cache, out),
                f"run.batch_size={DP_CLI_BATCH}"]

        def launch(name, *extra):
            t0 = time.perf_counter()
            ddp_check.launch(["cli", os.path.join(root, name), "--", *argv, *extra],
                             nproc=DP_RANKS, timeout_s=DP_TIMEOUT_S)
            ranks = ddp_check.read_ranks(os.path.join(root, name + ".rank*.pt"))
            if [r["rank"] for r in ranks] != list(range(DP_RANKS)):
                raise AssertionError(f"13c {name}: rank files {[r['rank'] for r in ranks]}")
            return ranks, time.perf_counter() - t0

        def expected(r):
            exp = no_launches()
            for t in r["topologies"]:
                for k, n in t["expected"].items():
                    exp[k] += n
            return exp

        def monitor(ranks, kind, field, batches):
            """A monitor's log as the ranks' tables give it: the mean over
            the ranks of the sum over the `batches` (indices among this
            kind's topologies) of each table's count."""
            return sum(sum([t[field] for t in r["topologies"] if t["kind"] == kind][i]
                           for i in batches) for r in ranks) / len(ranks)

        def check_monitor(logged, want, what):
            if abs(logged - want) > 1e-6 * max(1.0, abs(want)):
                raise AssertionError(f"13c {what}: logged {logged}, the tables' {want}")

        fit, fit_s = launch("fit")
        launches = []
        for r in fit:
            kinds = [t["kind"] for t in r["topologies"]]
            # rank 0 alone runs the figures' forwards: step 0's two batches
            # and the first batch of each of the 3 eval loops
            if r["global_step"] != 3 or len(r["ends"]) != 3 or \
                    kinds.count("train") != 6 or kinds.count("eval") != 6 or \
                    kinds.count("viz") != (5 if r["rank"] == 0 else 0):
                raise AssertionError(f"13c rank {r['rank']}: step {r['global_step']}, "
                                     f"{len(r['ends'])} steps, topologies {kinds}")
            check_counts(r["launches"], expected(r), f"13c fit rank {r['rank']}")
            launches.append(r["launches"])
            if r["state"] != fit[0]["state"] or r["results"] != fit[0]["results"]:
                raise AssertionError(f"13c: rank {r['rank']} ends unlike rank 0")
        with open(os.path.join(out, "metrics.jsonl")) as f:
            lines = [json.loads(ln) for ln in f]
        train = [ln for ln in lines if "train/loss_total" in ln]
        evals = [ln for ln in lines if "val/target/iou" in ln]
        if [ln["step"] for ln in train] != [1, 2, 3] or len(evals) != 1:
            raise AssertionError(f"13c: train log steps {[ln['step'] for ln in train]}, "
                                 f"{len(evals)} eval lines")
        # both monitors as the ranks' tables give them (a dropped hit or a
        # full level counts; the default slot plan is the reference's
        # calibration, ROADMAP.md Queue 3)
        dropped = []
        for s, ln in enumerate(train):
            if not all(math.isfinite(v) for v in ln.values()):
                raise AssertionError(f"13c step {ln['step']}: non-finite log")
            for name, field in (("train/nbr_slot_overflow", "slot_overflow"),
                                ("train/voxel_overflow_levels", "levels_at_capacity")):
                check_monitor(ln[name], monitor(fit, "train", field, (2 * s, 2 * s + 1)),
                              f"step {ln['step']} {name}")
            dropped.append(ln["train/nbr_slot_overflow"])
        for stage, batches, logs in (("val/target", (0, 1), evals[0]),
                                     ("test/target", (2, 3), evals[0]),
                                     ("test/target", (4, 5), fit[0]["results"])):
            check_monitor(logs[f"{stage}/nbr_slot_overflow"],
                          monitor(fit, "eval", "slot_overflow", batches) / 2,
                          f"{stage} nbr_slot_overflow")
            dropped.append(logs[f"{stage}/nbr_slot_overflow"])
        if any(t["levels_at_capacity"] for r in fit for t in r["topologies"]):
            raise AssertionError("13c: a level at its voxel capacity")
        ckpts = sorted(os.listdir(os.path.join(out, "ckpts")))
        if "last.pt" not in ckpts or any(c.endswith(".tmp") for c in ckpts):
            raise AssertionError(f"13c checkpoints: {ckpts}")
        saved = torch.load(os.path.join(out, "ckpts", "last.pt"), map_location="cpu",
                           weights_only=True)
        if ddp_check.digest(saved) != fit[0]["state"]:
            raise AssertionError("13c: last.pt differs from the ranks' state")

        # the ranks' validation against one process over the same scans in
        # the same batches of 8
        t0 = time.perf_counter()
        ref = ddp_check.reference_eval(argv, batch_size=DP_CLI_BATCH // DP_RANKS,
                                       limit=2 * DP_RANKS, device="cuda")
        if int(ref["cm_2d"].sum()) <= 0:
            raise AssertionError("13c: the validation counted no point")
        for k, cm in ref.items():
            if not torch.equal(fit[0]["evals"][0][k], cm):
                d = int((fit[0]["evals"][0][k] - cm).abs().sum())
                raise AssertionError(f"13c val {k}: {d} counts differ from one process")
        ref_s = time.perf_counter() - t0

        test, test_s = launch("test", "run=test", f"run.batch_size={DP_CLI_BATCH}",
                              "run.resume=true")
        for r in test:
            if r["global_step"] != 3 or r["start_epoch"] != 1 or r["state"] != fit[0]["state"]:
                raise AssertionError(f"13c resumed rank {r['rank']}: step {r['global_step']}, "
                                     "state unlike the checkpoint's")

    ms = [statistics.median([b - a for a, b in zip(r["ends"], r["ends"][1:])]) * 1e3
          for r in fit]
    log(f"13c fit: losses " + ", ".join(f"{ln['train/loss_total']:.4f}" for ln in train)
        + "; val IoU 2D/3D/avg " + "/".join(
            f"{evals[0][f'val/target/iou{h}']:.4f}" for h in ("", "_3d", "_avg"))
        + f"; hits dropped per step and eval batch, mean over the ranks (the "
        f"monitors, equal to the tables' counts): train {dropped[:3]}, val "
        f"{dropped[3]}, test {dropped[4]}, {dropped[5]}; no level at capacity"
        + f"; {len(ckpts)} checkpoint files, written once; both ranks' state bit-equal "
        f"to last.pt; launches per rank {launches} (as the hierarchies predict); "
        f"validation confusion matrices equal to one process's over the same scans "
        f"({int(ref['cm_2d'].sum())} points, {ref_s:.1f} s); resumed run=test: both "
        f"ranks bit-equal to last.pt; test IoU 2D {test[0]['results']['test/target/iou']:.4f} "
        f"(fit's {fit[0]['results']['test/target/iou']:.4f})")
    log(f"13c: {DP_RANKS} ranks sharing one card over gloo, not a scaling number: "
        + ", ".join(f"rank {r['rank']} {m:.2f} ms/step (median of steps 2-3, trainer loop "
                    f"wall), peak {r['peak_gib']:.2f} GiB" for r, m in zip(fit, ms))
        + f"; fit launch {fit_s:.1f} s, resumed test launch {test_s:.1f} s")
    return {"launches": launches, "ms": ms, "peak": [r["peak_gib"] for r in fit]}


def run_data_parallel(dev) -> dict:
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    log(f"phase 13a: NCCL group of one, bf16 train step at batch {BATCH} per domain")
    n = check_nccl_world_of_one(dev)
    torch.cuda.empty_cache()
    log(f"phase 13b: {DP_RANKS} ranks sharing the card over gloo (tools/ddp_check.py)")
    two = check_two_ranks(dev)
    log(f"phase 13c: configs/config.yaml through the CLI, {DP_RANKS} ranks under torchrun")
    cli = run_cli_data_parallel(dev)
    seconds = time.perf_counter() - t0
    log(f"phase 13: {seconds:.1f} s")
    return {"world_of_one_tensors": n, **two, **cli, "seconds": seconds}


# --------------------------------------------------------------------------
# phase 14: the self-training stage and the training tools
# --------------------------------------------------------------------------

# launches per generated scan: one eval forward at batch 1 (PERF.md, Findings)
GEN_PER_SCAN = {**no_launches(), "bandmm": 51, "propagate": 6, "maxpool": 2,
                "slot_gather": 62}
PSELAB_MARGIN, PSELAB_PROB_TOL = 1e-3, 1e-4  # card vs CPU records, fp32
FIG_STEPS = 2
FIG_MIN_POINTS = 100  # points alone under their markers in 14c's figure


def config_path(name: str = "config.yaml") -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", name)


def generate_pselab(dev, root: str) -> dict:
    """14a: the pseudo-label generator on the card over phase 10's tree from
    its `last` checkpoint: the schema against the scans, K1, K3 and K4
    launches per scan as predicted; the card's records against the CPU's
    in fp32 on two scans; two train steps of the CLI on the written file
    (every target batch carrying pseudo labels) and the doctor's
    `check_pselab` on it, which finds no problem."""
    import pickle

    import numpy as np

    from mm2d3d_tpu_torch import run as cli
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools import doctor
    from mm2d3d_tpu_torch.tools import generate_pseudo_labels as gen
    from mm2d3d_tpu_torch.train.step import MM2D3DTask

    pre, cache = os.path.join(root, "preprocess"), os.path.join(root, "image_cache")
    paths = cli_overrides(root, pre, cache, os.path.join(root, "run"))
    cfg = cli.parse_config(config_path(), paths)
    out = os.path.join(root, "pselab", "train_singapore.npy")

    hiers, build = [], MM2D3DTask.build_topology

    def kept_build(self, batch):
        topo = build(self, batch)
        hiers.append(topo[1])
        return topo

    MM2D3DTask.build_topology = kept_build
    try:
        kernels.reset_counts()
        t0 = time.perf_counter()
        records = gen.generate(cfg, "last", out, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = kernels.counts()
    finally:
        MM2D3DTask.build_topology = build
    with open(os.path.join(pre, "train_singapore.pkl"), "rb") as f:
        scans = pickle.load(f)
    n = len(scans)
    if len(records) != n or len(hiers) != n:
        raise AssertionError(f"14a: {len(records)} records, {len(hiers)} forwards, "
                             f"{n} scans")
    for i, (rec, scan) in enumerate(zip(records, scans)):
        if sorted(rec) != sorted(f"{p}_{k}" for p in ("probs", "pseudo_label")
                                 for k in gen.KEYS):
            raise AssertionError(f"14a scan {i}: keys {sorted(rec)}")
        kept = rec["probs_2d"] > 0
        for k in gen.KEYS:
            probs, labels = rec[f"probs_{k}"], rec[f"pseudo_label_{k}"]
            if len(probs) != len(scan["points"]) or len(labels) != len(probs) or \
                    probs.dtype != np.float32 or labels.dtype != np.int64 or \
                    not np.array_equal(probs > 0, kept) or probs.max() > 1 or \
                    labels.min() < 0 or labels.max() >= 6 or labels[~kept].any():
                raise AssertionError(f"14a scan {i} {k}: schema")
        if kept.sum() < 0.9 * len(kept):
            raise AssertionError(f"14a scan {i}: {kept.sum()} of {len(kept)} points kept")
    per_scan = [expected_launches(h) for h in hiers]
    for name, k in GEN_PER_SCAN.items():
        if any(e[name] != k for e in per_scan) or launches[name] != k * n:
            raise AssertionError(f"14a: {name} {launches[name]} launches over {n} "
                                 f"scans, predicted {k} per scan")
    dropped = sum(int(lvl.slot_overflow) for h in hiers for lvl in h.levels
                  if lvl.slot_overflow is not None)
    log(f"14a generator, bf16, {n} scans of phase 10's train_singapore from `last`: "
        f"{gen_s:.1f} s, {gen_s * 1e3 / n:.2f} ms per scan (dataset, collate, "
        f"topology, forward, copies); launches {launches} = per scan "
        f"{ {k: v for k, v in GEN_PER_SCAN.items() if v} } as predicted; slot hits "
        f"dropped over all scans {dropped}; schema of every record against its scan")

    # the card's records against the CPU's, fp32, on the split's first two scans
    with open(os.path.join(pre, "train_two.pkl"), "wb") as f:
        pickle.dump(scans[:2], f)
    cfg32 = cli.parse_config(config_path(), paths + [
        "train.compute_dtype=float32", "dataset.target.TRAIN=[train_two]"])
    t0 = time.perf_counter()
    card = gen.generate(cfg32, "last", os.path.join(root, "pselab", "card32.npy"),
                        device=dev)
    cpu = gen.generate(cfg32, "last", os.path.join(root, "pselab", "cpu32.npy"),
                       device="cpu")
    dataset, dm = gen.target_train_dataset(cfg32)
    task = gen.restore_task(cfg32, dm, "last", "cpu")
    worst, compared = 0.0, 0
    for i, (a, b) in enumerate(zip(card, cpu)):
        gaps = gen.margins(task, dataset, i)
        for k in gen.KEYS:
            err = float(np.abs(a[f"probs_{k}"] - b[f"probs_{k}"]).max())
            worst = max(worst, err)
            clear = gaps[k] > PSELAB_MARGIN
            diff = int((a[f"pseudo_label_{k}"] != b[f"pseudo_label_{k}"])[clear].sum())
            if err > PSELAB_PROB_TOL or diff:
                raise AssertionError(f"14a card vs CPU scan {i} {k}: probs max|d| "
                                     f"{err:.3e}, {diff} labels differ of "
                                     f"{int(clear.sum())} clear points")
            compared += int(clear.sum())
    if compared < 1000:
        raise AssertionError(f"14a card vs CPU: {compared} clear points")
    log(f"14a card vs CPU, fp32, 2 scans: probs max|d| {worst:.3e} (tol "
        f"{PSELAB_PROB_TOL:.0e}); labels equal at all {compared} points whose top-two "
        f"margin exceeds {PSELAB_MARGIN:.0e}; {time.perf_counter() - t0:.1f} s")

    # the self-training run: two steps on the written labels, then the doctor
    carried, step = [], MM2D3DTask.train_step

    def recording(self, src, trg, *a, **kw):
        carried.append(trg.pseudo_label_2d is not None
                       and bool((trg.pseudo_label_2d >= 0).any()))
        return step(self, src, trg, *a, **kw)

    MM2D3DTask.train_step = recording
    t0 = time.perf_counter()
    try:
        fit, _ = cli.main(["--config", config_path(), *cli_overrides(
            root, pre, cache, os.path.join(root, "retrain")),
            f"dataset.target.pselab_paths={out}", "run.limit_train_batches=2",
            "run.limit_val_batches=1"])
    finally:
        MM2D3DTask.train_step = step
    if fit.global_step != 2 or carried != [True, True]:
        raise AssertionError(f"14a retrain: step {fit.global_step}, pseudo labels "
                             f"in the target batches {carried}")
    doc = doctor.Doctor()
    doctor.check_pselab(doc, out, pre, "train_singapore")
    if doc.problems or not doc.checked:
        raise AssertionError(f"14a doctor: {doc.problems}")
    log(f"14a self-training: 2 CLI steps on the written labels (each target batch "
        f"carries them), {time.perf_counter() - t0:.1f} s; doctor check_pselab: "
        f"{doc.checked} checks passed, no problem")
    return {"launches": launches, "scans": n, "ms_per_scan": gen_s * 1e3 / n,
            "dropped": dropped, "card_cpu_prob_err": worst}


def run_learning_check(dev) -> dict:
    """14b: `tools/check_flagship_learning.py` against the committed H100
    trajectory (exit 0), then with `--mutate` (exit 1); launches per step
    against the pairs' hierarchies."""
    import numpy as np

    from mm2d3d_tpu_torch.data.synthetic import make_batch
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools import check_flagship_learning as check
    from mm2d3d_tpu_torch.train.batch import build_topology

    # the check's own batches (seeds 0-3) and the flagship's topology
    fs, planes = check.TASK.get("full_scale", 4096), check.TASK.get("num_planes", 7)
    hiers = [build_topology(make_batch(np.random.RandomState(s), batch_size=check.BATCH,
                                       **check.SCAN).to(dev), fs, planes)[1]
             for s in range(4)]
    pairs = [expected_train_launches(hiers[:2]), expected_train_launches(hiers[2:])]
    steps = check.STEPS
    want = {k: sum(pairs[i % 2][k] for i in range(steps)) for k in pairs[0]}
    out = {}
    for mutate, rc_want in ((False, 0), (True, 1)):
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = check.main(["--mutate"] if mutate else [])
        seconds = time.perf_counter() - t0
        launches = kernels.counts()
        if rc != rc_want:
            raise AssertionError(f"14b: check{' --mutate' if mutate else ''} exited "
                                 f"{rc}, expected {rc_want}")
        if mutate:
            for name in ("bandmm", "bandmm_dw", "slot_gather"):
                if not 0 < launches[name] < want[name]:
                    raise AssertionError(f"14b --mutate: {name} {launches[name]} "
                                         f"launches vs {want[name]} unmutated")
        else:
            check_counts(launches, want, "14b learning check")
        per_step = {k: v / steps for k, v in launches.items()}
        out["mutated" if mutate else "check"] = {"per_step": per_step, "s": seconds}
        log(f"14b check{' --mutate' if mutate else ''}: exit {rc} as required; "
            f"launches per step {per_step}; {seconds:.1f} s with set-up")
    return out


def check_figure_pixels(path: str, batch, palette) -> int:
    """The figure of `batch`'s first scan at `path`: panel by panel, the
    colour at the pixel of every point no other point's marker reaches
    (the ground truth's palette colour; a palette colour in the prediction
    panels; a turbo colour in the confidence panel) -> the points checked."""
    import numpy as np
    from PIL import Image

    from mm2d3d_tpu_torch.utils import visualize as V

    fig = np.asarray(Image.open(path).convert("RGB"))
    mask = batch.point_mask[0].cpu().numpy()
    idx = batch.img_indices[0].cpu().numpy()[mask].astype(np.int64)
    gt = batch.seg_label[0].cpu().numpy()[mask]
    h, w = batch.img.shape[1:3]
    if fig.shape != (5 * (h + V.TITLE_HEIGHT), w, 3):
        raise AssertionError(f"14c figure {fig.shape}, image {h}x{w}")
    occ = np.zeros((h + 2, w + 2), np.int64)
    np.add.at(occ, (idx[:, 0] + 1, idx[:, 1] + 1), 1)
    near = sum(occ[1 + dr:h + 1 + dr, 1 + dc:w + 1 + dc]
               for dr in (-1, 0, 1) for dc in (-1, 0, 1))
    alone = near[idx[:, 0], idx[:, 1]] == 1
    pts, gt = idx[alone], gt[alone]
    panels = [fig[r:r + h, c:c + w] for r, c in V.panel_origins(h, 5)]
    want = V.colorize_labels(gt, palette)
    got = panels[1][pts[:, 0], pts[:, 1]]
    if not np.array_equal(got, want):
        raise AssertionError(f"14c: {int((got != want).any(1).sum())} ground-truth "
                             "pixels not in their palette colour")
    colours = {tuple(c) for c in palette}
    turbo = {tuple(c) for c in V._TURBO}
    for i, allowed in ((2, colours), (3, colours), (4, turbo)):
        bad = [tuple(c) for c in panels[i][pts[:, 0], pts[:, 1]] if tuple(c) not in allowed]
        if bad:
            raise AssertionError(f"14c panel {i}: {len(bad)} point pixels off palette")
    return len(pts)


def run_figures(dev, root: str) -> dict:
    """14c: the CLI over phase 10's tree with train_log_images_step and
    val_log_images_step 1: the PNGs under figures/, their count, the JSONL
    image lines, and the palette colours at the pixels of points no other
    marker reaches."""
    from mm2d3d_tpu_torch import run as cli
    from mm2d3d_tpu_torch.train.trainer import Trainer
    from mm2d3d_tpu_torch.utils.visualize import PALETTES

    pre, cache = os.path.join(root, "preprocess"), os.path.join(root, "image_cache")
    out = os.path.join(root, "figures_run")
    drawn, log_images = [], Trainer._log_images

    def kept(self, batch, stage):
        drawn.append((stage, self.global_step, batch))
        return log_images(self, batch, stage)

    Trainer._log_images = kept
    t0 = time.perf_counter()
    try:
        cli.main(["--config", config_path(), *cli_overrides(root, pre, cache, out),
                  "train.params.train_log_images_step=1",
                  "train.params.val_log_images_step=1",
                  f"run.limit_train_batches={FIG_STEPS}", "run.limit_val_batches=2"])
    finally:
        Trainer._log_images = log_images
    seconds = time.perf_counter() - t0
    names = ([f"train_{d}_step{s}" for s in range(FIG_STEPS) for d in ("source", "target")]
             + [f"val_target_step{FIG_STEPS}"] * 2 + [f"test_target_step{FIG_STEPS}"] * 4)
    if [f"{st}_step{g}" for st, g, _ in drawn] != names:
        raise AssertionError(f"14c drawn {[(st, g) for st, g, _ in drawn]}")
    fig_dir = os.path.join(out, "figures")
    files = sorted(os.listdir(fig_dir))
    if files != sorted({n + ".png" for n in names}):
        raise AssertionError(f"14c files {files}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        images = [ln["image"] for ln in map(json.loads, f) if "image" in ln]
    want = [{n.rsplit("_step", 1)[0] + "/figure": os.path.join(fig_dir, n + ".png")}
            for n in names]
    if images != want:
        raise AssertionError(f"14c image lines {images}")
    palette = PALETTES["nuscenes"]
    # configs/config.yaml's own palette is nuScenes'
    if not (cli.parse_config(config_path())["train"]["params"]["class_palette"]
            == palette.tolist()):
        raise AssertionError("14c: config.yaml's palette is not nuScenes'")
    stage, step, batch = drawn[0]
    n = check_figure_pixels(os.path.join(fig_dir, f"{stage}_step{step}.png"), batch,
                            palette)
    if n < FIG_MIN_POINTS:
        raise AssertionError(f"14c: {n} points alone under their markers")
    log(f"14c figures: {len(files)} PNGs {files}, {len(images)} image lines in "
        f"metrics.jsonl; {n} isolated points of {stage}_step{step}.png in their "
        f"colours in all four point panels; CLI run {seconds:.1f} s")
    return {"files": len(files), "lines": len(images), "points": n, "s": seconds}


def run_self_training(dev, root: str) -> dict:
    t0 = time.perf_counter()
    log("phase 14a: the pseudo-label generator, then self-training on its labels")
    gen = generate_pselab(dev, root)
    log("phase 14b: the flagship learning check, then with --mutate")
    learn = run_learning_check(dev)
    log("phase 14c: figures every step and eval batch through the CLI")
    figs = run_figures(dev, root)
    seconds = time.perf_counter() - t0
    log(f"phase 14: {seconds:.1f} s")
    return {"gen": gen, "learn": learn, "figs": figs, "seconds": seconds}


# --------------------------------------------------------------------------
# phase 15: batches past the dense neighbour map; the loader's C++ image ops
# --------------------------------------------------------------------------

SEARCH_BATCHES = (17, 24, 32)  # scans per topology: 64^3 * B > 4M cells
SEARCH_EVAL_BATCH = 32
SEARCH_TRAIN_BATCH = 24
# (in_w, in_h) -> (out_w, out_h): the shipped configs' resizes, a SemanticKITTI
# frame to A2D2's size, VirtualKITTI halved, an upscale
RESIZES = [((1600, 900), (400, 225)), ((1920, 1208), (480, 302)),
           ((1241, 376), (480, 302)), ((1242, 375), (621, 188)),
           ((300, 200), (480, 302))]
LOADER_BENCH = dict(scans=32, points=12000, batch=16, workers=0, epochs=1)


def monitors(hier) -> tuple:
    """The tables' own counts behind both overflow monitors: (levels at
    capacity, slot hits dropped)."""
    from mm2d3d_tpu_torch.train.step import slot_overflow

    at_cap = sum(int(lev.num_voxels) >= lev.capacity for lev in hier.levels)
    return at_cap, int(slot_overflow(hier))


def check_search_topologies(dev) -> dict:
    """15a, first half: the flagship topology of 17, 24 and 32 scans, where
    the coarsest level (fs 64) is past the dense map's 4M cells and its
    table comes from the key search, built on the card and on the CPU:
    every table identical.  -> {B: card build ms}."""
    from mm2d3d_tpu_torch.ops import hierarchy as H
    from mm2d3d_tpu_torch.train.batch import build_topology

    out = {}
    for b in SEARCH_BATCHES:
        if 64 ** 3 * b <= H._DENSE_NBR_MAX_ENTRIES:
            raise AssertionError(f"batch {b} would take the dense map")
        batch = flagship_batch(100 + b, b, "cpu")
        n = compare_topology(batch, dev)
        on_card = batch.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hier = build_topology(on_card, 4096, 7)
        torch.cuda.synchronize()
        out[b] = (time.perf_counter() - t0) * 1e3
        at_cap, dropped = monitors(hier)
        log(f"15a topology of {b} scans: {n} tables identical card vs CPU; card build "
            f"{out[b]:.2f} ms; levels at capacity {at_cap}, slot hits dropped {dropped}")
    return out


def check_finite(logs: dict, what: str) -> None:
    """Finite logs; the monitors are held to the tables, not to 0 (the
    default slot plan drops hits at some batch sizes)."""
    for name, t in logs.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"{what}: non-finite {name}")


def check_monitor_logs(logged: dict, hiers, prefix: str, what: str) -> tuple:
    """The logged monitors equal to the tables' counts -> (at_cap, dropped)."""
    at_cap = sum(monitors(h)[0] for h in hiers)
    dropped = sum(monitors(h)[1] for h in hiers)
    got = float(logged[f"{prefix}nbr_slot_overflow"])
    if got != dropped:
        raise AssertionError(f"{what}: nbr_slot_overflow {got}, tables {dropped}")
    key = f"{prefix}voxel_overflow_levels"
    if key in logged and float(logged[key]) != at_cap:
        raise AssertionError(f"{what}: voxel_overflow_levels {float(logged[key])}, "
                             f"tables {at_cap}")
    return at_cap, dropped


def run_search_eval(dev) -> dict:
    """15a, second half: the bf16 eval forward at batch 32 through
    `eval_step` and `forward`: launches as the hierarchies predict, both
    monitors equal to the tables' counts, ms per batch, peak memory."""
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.train.batch import build_topology

    from mm2d3d_tpu_torch.tools.kernel_cases import FLAGSHIP_BATCH

    b, n_points = SEARCH_EVAL_BATCH, FLAGSHIP_BATCH["n_points"]
    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    batches = [flagship_batch(s, b, dev) for s in (40, 41)]
    task.eval_step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    results = [(task.eval_step(x), task.forward(x)) for x in batches]
    torch.cuda.synchronize()
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    hiers = [build_topology(x, 4096, 7)[1] for x in batches]
    expected = {k: 0 for k in launches}
    mons = []
    for ((metrics, logs), fwd), hier in zip(results, hiers):
        for k, n in expected_launches(hier).items():
            expected[k] += 2 * n  # eval_step + forward
        check_finite({**logs, **fwd}, "15a")
        if fwd["seg_logit_2d"].shape != (b, n_points, 6) or \
                fwd["seg_logit_3d"].shape != (b * n_points, 6):
            raise AssertionError("15a: unexpected output shapes")
        if float((fwd["ensemble"].sum(-1) - 1).abs().max()) > 1e-3:
            raise AssertionError("15a: ensemble rows do not sum to 1")
        if int(metrics.cm_avg.sum()) <= 0:
            raise AssertionError("15a: empty confusion matrix")
        mons.append(check_monitor_logs(logs, [hier], "", "15a eval"))
    check_counts(launches, expected, "15a eval forwards")
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(2):
            for x in batches:
                out = task.forward(x)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) / 4)
    del out
    ms = statistics.median(samples) * 1e3
    per_forward = {k: v // 4 for k, v in launches.items()}
    log(f"15a eval forward bf16 batch {b}: {ms:.2f} ms/batch (median of 3 x 4, band "
        f"{min(samples) * 1e3:.2f}-{max(samples) * 1e3:.2f}), {b * 1e3 / ms:.1f} "
        f"scans/s; peak {peak:.2f} GiB; launches over 4 forwards {launches} (= "
        f"expected_launches); monitors (levels at capacity, hits dropped) per batch "
        f"{mons}, equal to the tables")
    return {"ms": ms, "peak": peak, "launches": launches, "per_forward": per_forward,
            "monitors": mons}


def run_search_train(dev) -> dict:
    """15b: one bf16 flagship train step at 24 scans per domain: launches as
    the two hierarchies predict, both monitors equal to the tables' counts,
    ms per step, peak memory."""
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.train.batch import build_topology

    b = SEARCH_TRAIN_BATCH
    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    src, trg = flagship_batch(50, b, dev), flagship_batch(51, b, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    check_finite(task.train_step(src, trg, gen), "15b warm-up")
    torch.cuda.synchronize()
    kernels.reset_counts()
    logs = task.train_step(src, trg, gen)
    torch.cuda.synchronize()
    launches = kernels.counts()
    check_finite(logs, "15b")
    hiers = [build_topology(x, 4096, 7)[1] for x in (src, trg)]
    check_counts(launches, expected_train_launches(hiers), "15b train step")
    mon = check_monitor_logs({k: float(v) for k, v in logs.items()}, hiers, "train/",
                             "15b train step")
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        logs = task.train_step(src, trg, gen)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    check_finite(logs, "15b")
    ms = statistics.median(samples) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"15b train step bf16 batch {b} per domain: {ms:.2f} ms/step (median of 3, "
        f"band {min(samples) * 1e3:.2f}-{max(samples) * 1e3:.2f}), "
        f"{2 * b * 1e3 / ms:.1f} scans/s; peak {peak:.2f} GiB; launches {launches} "
        f"(= expected_train_launches); monitors (levels at capacity, hits dropped) "
        f"{mon}, equal to the tables; loss {float(logs['train/loss_total']):.4f}")
    return {"ms": ms, "peak": peak, "launches": launches, "monitors": mon}


def check_host_image_ops() -> int:
    """15c, first half: the C++ resize and maps bit-equal to the numpy path
    on this host (its own `-march=native` build), in numpy's memory order.
    -> the number of cases."""
    import numpy as np

    from mm2d3d_tpu_torch import native
    from mm2d3d_tpu_torch.data import augment as A

    def numpy_path(fn, *args):
        os.environ["MM2D3D_HOST_NATIVE"] = "0"
        try:
            return fn(*args)
        finally:
            os.environ["MM2D3D_HOST_NATIVE"] = "1"

    native.lib()  # this host's build, before the timed calls
    r = np.random.RandomState(15)
    t_native = t_numpy = 0.0
    for (iw, ih), (ow, oh) in RESIZES:
        img = r.randint(0, 256, size=(ih, iw, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        out = native.bilinear_resize_u8(img, (oh, ow))
        t1 = time.perf_counter()
        ref = numpy_path(A.bilinear_resize, img, (oh, ow))
        t_native, t_numpy = t_native + t1 - t0, t_numpy + time.perf_counter() - t1
        if not (np.array_equal(out, ref) and out.strides == ref.strides):
            raise AssertionError(f"15c: resize {(iw, ih)} -> {(ow, oh)} differs from "
                                 "numpy")
    for (h, w), n in (((225, 400), 6000), ((302, 480), 9000)):
        idx = np.stack([r.randint(0, h, n), r.randint(0, w, n)], 1)
        idx[: n // 3] = idx[n // 3: 2 * (n // 3)]  # pixels hit twice
        depths, labels = r.uniform(1, 80, n), r.randint(0, 17, n)
        got = native.depth_label_maps(idx, depths, labels, (h, w))
        want = numpy_path(A.build_depth_and_label_maps, idx, depths, labels, (h, w))
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"15c: maps {(h, w)} differ from numpy")
    log(f"15c native image ops bit-equal to numpy on this host: {len(RESIZES)} "
        f"resizes (native {t_native * 1e3:.2f} ms, numpy {t_numpy * 1e3:.2f} ms in "
        "all) and 2 map pairs with pixels hit twice")
    return len(RESIZES) + 2


def run_phase15(dev) -> dict:
    from mm2d3d_tpu_torch.tools import bench_loader

    t0 = time.perf_counter()
    log(f"phase 15a: topologies of {SEARCH_BATCHES} scans (key search at the coarsest "
        f"level), card vs CPU; the eval forward at batch {SEARCH_EVAL_BATCH}")
    builds = check_search_topologies(dev)
    ev = run_search_eval(dev)
    log(f"phase 15b: train step at batch {SEARCH_TRAIN_BATCH} per domain")
    tr = run_search_train(dev)
    log("phase 15c: the loader's C++ image ops; tools/bench_loader.py "
        + ", ".join(f"{k}={v}" for k, v in LOADER_BENCH.items()))
    cases = check_host_image_ops()
    bench = bench_loader.run(**LOADER_BENCH, device=str(dev))
    log("15c bench_loader: " + json.dumps(bench))
    seconds = time.perf_counter() - t0
    log(f"phase 15: {seconds:.1f} s")
    return {"builds": builds, "eval": ev, "train": tr, "image_cases": cases,
            "bench": bench, "seconds": seconds}


# --------------------------------------------------------------------------
# phase 16: the host self-validation tool (tools/autotune.py, doctor --perf)
# --------------------------------------------------------------------------

AUTOTUNE_ITERS = 4
AUTOTUNE_TIMEOUT_S = 300
AUTOTUNE_KEYS = {  # the JAX tool's keys, without donation
    "loader_scans_per_sec_by_workers": ({"0", "2", "4"}, "num_workers", {0, 2, 4}),
    "fwd_ms_by_topology": ({"host-topo", "device-topo"}, "host_topology", {True, False}),
    "fit_step_ms_by_prefetch": ({"0", "2", "4"}, "prefetch_batches", {0, 2, 4}),
}


def session_processes(sid: int) -> list:
    """Live processes of session `sid`, from /proc."""
    return [pid for pid, _, s in live_processes() if s == sid]


def check_autotune_result(result: dict, what: str) -> None:
    """The JSON line: the JAX tool's measured and recommended keys (no
    donation), finite positive times and rates, each recommendation in its
    allowed set."""
    measured, recommended = result["measured"], result["recommended"]
    if set(measured) != set(AUTOTUNE_KEYS):
        raise AssertionError(f"{what}: measured keys {sorted(measured)}")
    if set(recommended) != {v[1] for v in AUTOTUNE_KEYS.values()}:
        raise AssertionError(f"{what}: recommended keys {sorted(recommended)}")
    for key, (inner, rec, allowed) in AUTOTUNE_KEYS.items():
        values = measured[key]
        if set(values) != inner or not all(
                isinstance(v, (int, float)) and math.isfinite(v) and v > 0
                for v in values.values()):
            raise AssertionError(f"{what}: {key} {values}")
        if recommended[rec] not in allowed or type(recommended[rec]) is not (
                bool if rec == "host_topology" else int):
            raise AssertionError(f"{what}: {rec} {recommended[rec]!r}")


def run_doctor_perf() -> dict:
    """16a: `python -m mm2d3d_tpu_torch.tools.doctor --perf` as users run it,
    in its own session: exit 0, the JSON line held by
    `check_autotune_result`, and no process of its session left."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the memory the earlier phases cached, for the tool
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mm2d3d_tpu_torch.tools.doctor", "--perf", "--iters",
         str(AUTOTUNE_ITERS)], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=AUTOTUNE_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        deadline = time.monotonic() + 5  # what exits with the tool has ended by then
        while session_processes(proc.pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        left = session_processes(proc.pid)
    finally:
        for pid in session_processes(proc.pid):
            os.kill(pid, signal.SIGKILL)
        proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"16a: doctor --perf exit {proc.returncode}: {err[-3000:]}")
    if left:
        raise AssertionError(f"16a: processes of doctor --perf still running: {left}")
    lines = out.strip().splitlines()
    result = json.loads(lines[-1])
    check_autotune_result(result, "16a doctor --perf")
    probes = [ln for ln in lines[:-1] if ln.startswith(
        ("workers:", "autotune:", "donation:", "host_topology:", "prefetch:"))]
    if not any(ln.startswith("donation: not probed") for ln in probes):
        raise AssertionError("16a: no donation line")
    log(f"16a doctor --perf --iters {AUTOTUNE_ITERS}: exit 0 in {seconds:.1f} s, no "
        "process of its session left; " + " | ".join(probes))
    return {"result": result, "seconds": seconds}


def run_autotune_probes(dev) -> dict:
    """16b-d: the tool's probes in this process at the flagship size, each
    with the launch counts set to 0 just before it: (b) the loader pools,
    no process left; (c) the forward with the card's topology (K1, K3, K4 as
    `expected_launches`) and with host-built ones (K3 none), whose warm
    outputs the probe holds bit-equal; (d) `Trainer.fit` at depths 0, 2, 4,
    each step's launches as `expected_train_launches`."""
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools import autotune
    from mm2d3d_tpu_torch.train.batch import build_topology

    iters = AUTOTUNE_ITERS
    before = set(descendants())
    rates, rec_w = autotune.probe_workers(iters)
    left = set(descendants()) - before
    if left:
        raise AssertionError(f"16b: processes of the loader pools still running: {left}")
    log(f"16b workers: {rates} -> {rec_w}; no process left")

    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    hosts = autotune.host_batches()
    devs = [b.to(dev) for b in hosts]
    with torch.no_grad():
        hiers = [build_topology(b, 4096, 7)[1] for b in devs]
    per_fwd = [expected_launches(h) for h in hiers]

    kernels.reset_counts()
    topo_ms, rec_t = autotune.probe_host_topology(task, hosts, devs, iters)
    torch.cuda.synchronize()
    topo_launches = kernels.counts()
    used = [0] + [i % 2 for i in range(iters)]  # the warm forward, then the timed
    expected = {k: 0 for k in topo_launches}
    for i in used:
        for k, n in per_fwd[i].items():
            expected[k] += n if k == "propagate" else 2 * n  # host forwards: no K3
    check_counts(topo_launches, expected, "16c forwards, card and host topologies")
    log(f"16c host_topology: {topo_ms} -> {rec_t}; warm forwards bit-equal (the probe "
        f"raises otherwise); launches over {len(used)} card-topology and {len(used)} "
        f"host-topology forwards {topo_launches} (= expected_launches, K3 only in "
        "the card's)")

    depths = (0, 2, 4)
    kernels.reset_counts()
    fit_ms, rec_p = autotune.probe_prefetch(task, hosts, iters, depths=depths)
    torch.cuda.synchronize()
    fit_launches = kernels.counts()
    expected = {k: 0 for k in fit_launches}
    steps = 0
    for _ in range(2 * len(depths)):  # a warm and a timed epoch per depth
        for i in range(iters):
            for k, n in expected_train_launches([hiers[i % 2], hiers[::-1][i % 2]]).items():
                expected[k] += n
            steps += 1
    check_counts(fit_launches, expected, "16d Trainer.fit steps")
    per_step = {k: v // steps for k, v in fit_launches.items()}
    log(f"16d prefetch: {fit_ms} -> {rec_p}; {steps} train steps, launches "
        f"{fit_launches} (= expected_train_launches; per step {per_step})")
    result = {"measured": {
        "loader_scans_per_sec_by_workers": rates,
        "fwd_ms_by_topology": {k: round(v, 1) for k, v in topo_ms.items()},
        "fit_step_ms_by_prefetch": {k: round(v, 1) for k, v in fit_ms.items()}},
        "recommended": {**rec_w, **rec_t, **rec_p}}
    check_autotune_result(result, "16b-d probes")
    del task
    return {"result": result, "topology_launches": topo_launches,
            "topology_forwards": 2 * len(used), "fit_launches": fit_launches,
            "per_step": per_step}


def run_phase16(dev) -> dict:
    t0 = time.perf_counter()
    log(f"phase 16a: python -m mm2d3d_tpu_torch.tools.doctor --perf --iters "
        f"{AUTOTUNE_ITERS}")
    cli = run_doctor_perf()
    log(f"phase 16b-d: the autotune probes in process, --iters {AUTOTUNE_ITERS}")
    probes = run_autotune_probes(dev)
    seconds = time.perf_counter() - t0
    log(f"phase 16: {seconds:.1f} s")
    return {"cli": cli, "probes": probes, "seconds": seconds}


# --------------------------------------------------------------------------
# phase 17: the probe kernels K7-K10 and the two probe tools
# --------------------------------------------------------------------------

def gathered_bytes(src, ids, rows_per_id: int = 1) -> int:
    """Bytes of the rows of src that the ids reach, each once (an id outside
    the rows reads nothing): what a gather must read at this data."""
    u = torch.unique(ids)
    n = int(((u >= 0) & (u < src.shape[0] // rows_per_id)).sum())
    return n * rows_per_id * src.shape[1] * src.element_size()


def check_k7(res: Results, dev) -> None:
    """K7 at the probe tool's three cases, G = 8 (the TPU's grain) and G = 1
    at equal bytes, and G = 1 on the slot-width rows of the tool's reading
    A (the same function as `torch.index_select`), bit-equal to the plain
    version; ids outside the groups give zeros; `torch.index_select` of the
    same rows beside it."""
    import numpy as np

    from mm2d3d_tpu_torch.ops.kernels.exp_gather import (
        group_gather, group_gather_ref, group_order)
    from mm2d3d_tpu_torch.tools import exp_dma_gather as D

    def add(case, x, ids, g, tile, rows):
        out = group_gather(x, ids, g, tile)
        D.check_equal(out, torch.index_select(x, 0, rows), f"K7 {case} vs index_select")
        ms = cuda_ms(lambda: group_gather(x, ids, g, tile))
        plain = cuda_ms(lambda: group_gather_ref(x, ids, g, tile), reps=5)
        library = cuda_ms(lambda: torch.index_select(x, 0, rows))
        res.add("exp_group_gather", case, 0.0, 0.0, ms, plain,
                bound(nbytes(ids, out) + gathered_bytes(x, ids, g)), library)

    for h, v, ci in D.CASES:
        rng = np.random.RandomState(17)
        gi = D.group_inputs(rng, h, v, dev)
        x = gi["x"]
        for g in D.GROUPS:
            tile = D.T * 8 // g
            ids = gi[g].clone()
            ids[0, :3] = torch.tensor([-1, x.shape[0] // g, 2**31 - 1])  # misses
            D.check_equal(group_gather(x, ids, g, tile), group_gather_ref(x, ids, g, tile),
                          f"K7 G={g} with misses")
            ids = gi[g]
            rows = (group_order(ids, tile).long()[:, None] * g
                    + torch.arange(g, device=dev)).reshape(-1)
            add(f"H={h} V={v} Ci={ci} G={g} ({ids.numel()} ids, 128 lanes)", x, ids, g,
                tile, rows)
        xs = D.bf16(rng, v, ci, dev=dev)
        idx = D.ints(rng.randint(0, v, (h, v)), dev)
        add(f"H={h} V={v} Ci={ci} G=1 on A's rows", xs, idx, 1, v, idx.reshape(-1))


def check_k8(res: Results, dev) -> None:
    """K8 at the three cases (Ci 16, 32, 48), w = 1024 and 2048, bit-equal;
    windows outside x give zeros; a window split into chunks; a misaligned
    x refused."""
    import numpy as np

    from mm2d3d_tpu_torch.ops.kernels.exp_gather import window_copy, window_copy_ref
    from mm2d3d_tpu_torch.tools import exp_dma_gather as D

    for h, v, ci in D.CASES:
        rng = np.random.RandomState(18)
        x = D.bf16(rng, v, ci, dev=dev)
        for w in D.WINDOWS:
            n = max(h * v // w, 1)
            offs = D.ints(rng.randint(0, (v - w) // 8, (n,)) * 8, dev)
            edge = offs.clone()
            edge[:3] = torch.tensor([-8, v - w + 8, v - w])  # outside, outside, last
            for chunk in (None, 20_000):  # one copy per window; chunks of 20 KB
                kw = {} if chunk is None else {"max_chunk_bytes": chunk}
                D.check_equal(window_copy(x, edge, w, **kw), window_copy_ref(x, edge, w),
                              f"K8 Ci={ci} w={w} chunk {chunk}")
            out = window_copy(x, offs, w)
            rows = (offs.long()[:, None] + torch.arange(w, device=dev)).reshape(-1)
            ms = cuda_ms(lambda: window_copy(x, offs, w))
            plain = cuda_ms(lambda: window_copy_ref(x, offs, w), reps=5)
            library = cuda_ms(lambda: torch.index_select(x, 0, rows))
            res.add("exp_window_copy", f"H={h} V={v} Ci={ci} w={w} ({n} windows)",
                    0.0, 0.0, ms, plain,
                    bound(nbytes(offs, out) + gathered_bytes(x, rows)), library)
    skew = x.reshape(-1)[8:8 + (v - 1) * ci].reshape(v - 1, ci)  # 16 B off
    try:
        window_copy(x.reshape(-1)[1:1 + (v - 1) * ci].reshape(v - 1, ci), offs, 8)
    except ValueError as e:
        log(f"  K8 refuses a misaligned x: {e}")
    else:
        raise AssertionError("K8 accepted a misaligned x")
    D.check_equal(window_copy(skew, offs[:4], 8), window_copy_ref(skew, offs[:4], 8),
                  "K8 at a 16-byte offset")


# the first design of K9 and K10 at the same cases, measured by this script's
# phase 17 on an NVIDIA H100 80GB HBM3 at 700.00 W: K9 staged the whole
# window in every block, K10 built E in shared memory one element per
# thread; printed beside the redesigned kernels' times
FIRST_DESIGN_MS = {
    "exp_window_gather": {"H=3 V=65536 Ci=16 w=1024": 0.0050,
                          "H=4 V=24576 Ci=48 w=2048": 0.0087},
    "exp_bandmm": {"real-table E=full 64 voxels/block V=65536": 0.0893,
                   "real-table E=compact 64 voxels/block V=65536": 0.1011},
}


def log_against_first_design(kernel: str, case: str, ms: float, bnd) -> None:
    first = FIRST_DESIGN_MS[kernel].get(case)
    was = "not recorded" if first is None else f"{first:.4f} ms"
    log(f"  {kernel} {case}: {ms:.4f} ms (first design {was}), bound {bnd[0]:.4f} ms "
        f"({bnd[0] / ms:.0%} of it, {bnd[1]})")


def check_k9(res: Results, dev) -> None:
    """K9 at the three cases, windows of 1024 and 2048 rows, bit-equal at
    both cluster sizes; ids outside the window (below 0, at w, at the int32
    extremes) give zeros; rows that are not whole clusters' worth (fewer
    than one cluster's CTAs, a short last range) at both cluster sizes."""
    import numpy as np

    from mm2d3d_tpu_torch.ops.kernels.exp_gather import (
        GATHER_CLUSTERS, window_gather, window_gather_ref)
    from mm2d3d_tpu_torch.tools import exp_dma_gather as D

    for h, v, ci in D.CASES:
        rng = np.random.RandomState(19)
        x = D.bf16(rng, v, ci, dev=dev)
        for w in D.WINDOWS:
            xw = x[:w]
            idx = D.ints(rng.randint(0, w, (h, v)), dev)
            edge = idx.clone()
            edge[0, :5] = torch.tensor([-1, w, w + 7, 2**31 - 1, -2**31])
            for cluster in GATHER_CLUSTERS:
                D.check_equal(window_gather(xw, edge, cluster), window_gather_ref(xw, edge),
                              f"K9 Ci={ci} w={w} cluster {cluster} with misses")
            out = window_gather(xw, idx)
            flat = idx.reshape(-1)
            ms = cuda_ms(lambda: window_gather(xw, idx))
            plain = cuda_ms(lambda: window_gather_ref(xw, idx), reps=5)
            library = cuda_ms(lambda: torch.index_select(xw, 0, flat))
            case = f"H={h} V={v} Ci={ci} w={w}"
            bnd = bound(nbytes(out, idx) + gathered_bytes(xw, idx))
            res.add("exp_window_gather", case, 0.0, 0.0, ms, plain, bnd, library)
            log_against_first_design("exp_window_gather", case, ms, bnd)
    rng = np.random.RandomState(21)
    xw = D.bf16(rng, 1000, 48, dev=dev)
    for rows in (1, 7, 131 * 256 + 3):
        idx = D.ints(rng.randint(-3, 1003, (rows,)), dev)
        for cluster in GATHER_CLUSTERS:
            D.check_equal(window_gather(xw, idx, cluster), window_gather_ref(xw, idx),
                          f"K9 {rows} rows cluster {cluster}")
    log("  K9 edges: ids outside the window, rows not whole clusters' worth, both "
        "cluster sizes: bit-equal")


def check_k10(res: Results, dev) -> None:
    """K10 at the probe's size (V = 65,536, H = 3, Ci = Co = 16, K = 27,
    real-table taps), both E builds and both tiles, within 1e-4 *
    max|plain| and bit-stable over two calls; then V not a multiple of the
    tile (65,496), over more tiles than the persistent grid has blocks, not
    a multiple of 8 (1,001 and 4,093: rows not 16-byte aligned), under one
    tile (40), the flagship's L0 table, tiles whose rows all miss (compact E
    with the centre's band only, or none without xm), the TPU probe's own
    tap recipe (duplicates, tap 13) with and without the centre, and shapes
    off the probe's (H = 5, Ci = 32, Co = 64)."""
    import numpy as np

    from mm2d3d_tpu_torch.ops.kernels.exp_bandmm import (
        E_BUILDS, VOXELS_PER_BLOCK, band_apply, band_apply_ref, band_plan)
    from mm2d3d_tpu_torch.tools import exp_bandmm_variants as BV
    from mm2d3d_tpu_torch.tools.kernel_cases import band_inputs

    def check(xm, x, tap, w, what, time_it=False):
        ref = band_apply_ref(xm, x, tap, w)
        tol = K1_REL_TOL * float(ref.abs().max())
        plain = cuda_ms(lambda: band_apply_ref(xm, x, tap, w), reps=5) if time_it else 0.0
        for e_build in E_BUILDS:
            for voxels in VOXELS_PER_BLOCK:
                out = band_apply(xm, x, tap, w, e_build, voxels)
                err = float((out - ref).abs().max())
                if not torch.equal(out, band_apply(xm, x, tap, w, e_build, voxels)):
                    raise AssertionError(f"K10 {what} {e_build} {voxels}: two calls differ")
                case = f"{what} E={e_build} {voxels} voxels/block V={x.shape[2]}"
                if not time_it:
                    if not err <= tol:
                        raise AssertionError(f"K10 {case}: max|d| {err} > {tol}")
                    continue
                ms = cuda_ms(lambda: band_apply(xm, x, tap, w, e_build, voxels))
                hits = int(((tap >= 0) & (tap < BV.K)).sum())
                n_bytes = nbytes(xm, tap, w, out) + hits * x.shape[1] * x.element_size()
                bnd = bound(n_bytes, 2 * w.shape[0] * x.shape[1] * (hits + x.shape[2]),
                            torch.bfloat16)
                res.add("exp_bandmm", case, err, tol, ms, plain, bnd)
                log_against_first_design("exp_bandmm", case, ms, bnd)

    xm, x, tap, w = band_inputs(dev, seed=17)
    check(xm, x, tap, w, "real-table", time_it=True)
    # V over more tiles than the persistent grid has blocks, under one tile,
    # not a multiple of 8 (no tensor maps: elements copied)
    many = 3 * band_plan(BV.V, BV.H, BV.CI, BV.CO, BV.K, 64)["blocks"] * 64 + 40
    for v in (65496, many, 1001, 4093, 40):
        check(*band_inputs(dev, seed=v, v=v), "real-table")
    check(*band_inputs(dev, taps="flagship L0"), "flagship L0")
    tap_miss = tap.clone()
    tap_miss[:, 128:1024] = BV.K  # whole tiles of 64 and 128 voxels miss
    check(xm, x, tap_miss, w, "tiles all missing")
    check(None, x, tap_miss, w, "tiles all missing, no centre")
    rng = np.random.RandomState(20)
    taps = np.sort(rng.randint(0, 27, size=(3, x.shape[2])), axis=0).astype(np.int32)
    taps[rng.rand(3, x.shape[2]) > 0.8] = 27
    check(xm, x, torch.from_numpy(taps).to(dev), w, "TPU probe taps")
    check(None, x, torch.from_numpy(taps).to(dev), w, "TPU probe taps, no centre")
    def bf16(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)

    for h, ci, co, v in ((5, 16, 16, 3000), (2, 32, 16, 1500), (2, 16, 64, 1003)):
        t = np.sort(rng.randint(0, 28, size=(h, v)), axis=0).astype(np.int32)
        check(bf16(ci, v), bf16(h, ci, v), torch.from_numpy(t).to(dev), bf16(co, 27 * ci),
              f"H={h} Ci={ci} Co={co}")
    log(f"  K10 edges: V 65,496, {many:,} (more tiles than blocks), 1,001 and 4,093 "
        "(not multiples of 8), 40 (under one tile), the flagship's L0 table, tiles "
        "all missing and the TPU probe's tap recipe (with and without the centre), "
        "H = 5, Ci = 32, Co = 64: within tolerance, bit-stable")


def run_phase17(res: Results, dev) -> dict:
    """K7-K10 against their plain versions, then the two probe tools once at
    the TPU probes' sizes, with the kernels' launches counted over the
    tools' runs only."""
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools import exp_bandmm_variants, exp_dma_gather

    t0 = time.perf_counter()
    check_k7(res, dev)
    check_k8(res, dev)
    check_k9(res, dev)
    check_k10(res, dev)
    torch.cuda.synchronize()
    checks_s = time.perf_counter() - t0
    log("phase 17b: python -m mm2d3d_tpu_torch.tools.exp_dma_gather, "
        "python -m mm2d3d_tpu_torch.tools.exp_bandmm_variants (in process)")
    kernels.reset_counts()
    dma = exp_dma_gather.run(dev)
    band = exp_bandmm_variants.run(dev)
    torch.cuda.synchronize()
    launches = kernels.counts()
    for name in PROBE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no launch in the probe tools' run")
    seconds = time.perf_counter() - t0
    log(f"phase 17: launches over the tools' runs {launches}; checks "
        f"{checks_s:.1f} s, phase 17 {seconds:.1f} s")
    return {"launches": launches, "dma": dma, "band": band, "seconds": seconds}


# --------------------------------------------------------------------------
# phase 18: the sustained fit (tools/bench_e2e.py) and the topology's phases
# (tools/profile_topology.py)
# --------------------------------------------------------------------------

E2E_SCANS, E2E_STEPS = 32, 2  # 2 of an epoch's 4 steps: the phase in its minute
E2E_ARGS = ["--scans", str(E2E_SCANS), "--steps", str(E2E_STEPS), "--workers", "0", "2"]
E2E_KEYS = {"wire_format", "cache", "stage_loader_ms_per_batch", "batch_wire_bytes",
            "stage_transfer_ms_per_batch", "stage_device_step_ms",
            "loader_scans_per_sec_by_workers", "e2e_steps_measured",
            "e2e_train_scans_per_sec", "e2e_ms_per_step",
            "ctrl_host_batches_ms_per_step", "ctrl_device_batches_ms_per_step",
            "e2e_ms_per_step_host_topology"}
# host_topology of each fit: warm and timed, for the fit, both controls, then
# the fit with host-built topologies
E2E_FITS = [False] * 6 + [True] * 2
K3_PER_PHASE = [0, 0, 6, 6]  # profile_topology: voxelize, coarsen, nbr, full


def run_bench_e2e(dev) -> dict:
    """18a: `python -m mm2d3d_tpu_torch.tools.bench_e2e` in this process at
    32 scans, 2 steps, 0 and 2 workers.  Every `Trainer.fit` call's
    launches (counters read before and after, not reset) held to
    `expected_train_launches` per step, with and without host-built
    topologies; every train step's loss finite; the JSON keys; no process
    left."""
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools import bench_e2e
    from mm2d3d_tpu_torch.train import step as S
    from mm2d3d_tpu_torch.train import trainer as T
    from mm2d3d_tpu_torch.train.batch import build_topology

    with torch.no_grad():
        hier = build_topology(flagship_batch(0, BATCH, dev), 4096, 7)[1]
    per_step = {host: expected_train_launches([hier, hier], host_built=host)
                for host in (False, True)}
    fits, losses = [], []
    fit, train_step = T.Trainer.fit, S.MM2D3DTask.train_step

    def counted_fit(self, *args, **kwargs):
        before, g0 = kernels.counts(), self.global_step
        out = fit(self, *args, **kwargs)
        fits.append((self.host_topology, self.global_step - g0,
                     {k: n - before[k] for k, n in kernels.counts().items()}))
        return out

    def kept_loss(self, *args, **kwargs):
        logs = train_step(self, *args, **kwargs)
        losses.append(logs["train/loss_total"])  # read after the run: no sync here
        return logs

    before = set(descendants())
    T.Trainer.fit, S.MM2D3DTask.train_step = counted_fit, kept_loss
    t0 = time.perf_counter()
    try:
        kernels.reset_counts()
        result = bench_e2e.main(E2E_ARGS)
        torch.cuda.synchronize()
        total = kernels.counts()
    finally:
        T.Trainer.fit, S.MM2D3DTask.train_step = fit, train_step
    seconds = time.perf_counter() - t0
    left = set(descendants()) - before
    if left:
        raise AssertionError(f"18a: processes of bench_e2e still running: {left}")
    if set(result) != E2E_KEYS:
        raise AssertionError(f"18a: keys {sorted(result)}")
    times = [v for k, v in result.items() if k not in (
        "wire_format", "cache", "batch_wire_bytes", "e2e_steps_measured",
        "loader_scans_per_sec_by_workers")]
    times += list(result["loader_scans_per_sec_by_workers"].values())
    if not all(math.isfinite(v) and v > 0 for v in times) or \
            set(result["loader_scans_per_sec_by_workers"]) != {"0", "2"}:
        raise AssertionError(f"18a: {result}")
    if result["e2e_steps_measured"] != min(E2E_STEPS, E2E_SCANS // BATCH):
        raise AssertionError(f"18a: {result['e2e_steps_measured']} steps timed")
    if [h for h, _, _ in fits] != E2E_FITS:
        raise AssertionError(f"18a: fits {[(h, n) for h, n, _ in fits]}")
    for i, (host, steps, launches) in enumerate(fits):
        check_counts(launches, {k: n * steps for k, n in per_step[host].items()},
                     f"18a fit {i} ({steps} steps, host topology {host})")
    loss = torch.stack([x.float() for x in losses]).cpu()
    if not torch.isfinite(loss).all():
        raise AssertionError(f"18a: non-finite losses {loss.tolist()}")
    for name in ("bandmm", "bandmm_dw", "propagate", "maxpool"):
        if total[name] <= 0:
            raise AssertionError(f"18a: {name} not launched")
    log(f"18a bench_e2e {' '.join(E2E_ARGS)}: {seconds:.1f} s; {len(fits)} fits, "
        f"launches per step = expected_train_launches (card topologies "
        f"{per_step[False]}, host topologies K3 {per_step[True]['propagate']}); "
        f"{len(losses)} train steps, losses finite ({loss.min():.4f}..{loss.max():.4f}); "
        "no process left")
    return {"result": result, "per_step": per_step, "launches": total,
            "seconds": seconds}


def run_profile_topology(dev) -> dict:
    """18b: `python -m mm2d3d_tpu_torch.tools.profile_topology` in this
    process, as shipped: K3's launches per phase call 0/0/6/6 and no other
    kernel's, finite positive times, and the `full` phase's tables
    identical to `build_topology`'s on the same batch."""
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools import profile_topology as P
    from mm2d3d_tpu_torch.train.batch import build_topology

    t0 = time.perf_counter()
    kernels.reset_counts()
    out = P.main([])
    torch.cuda.synchronize()
    total = kernels.counts()
    seconds = time.perf_counter() - t0
    table = out["phases"]
    if list(table) != list(P.PHASES):
        raise AssertionError(f"18b: phases {list(table)}")
    k3 = [table[p]["launches"]["propagate"] for p in P.PHASES]
    others = {k: n for p in P.PHASES for k, n in table[p]["launches"].items()
              if k != "propagate" and n}
    if k3 != K3_PER_PHASE or others or total["propagate"] <= 0:
        raise AssertionError(f"18b: K3 per phase {k3}, others {others}")
    for p in P.PHASES:
        t = table[p]
        if not all(math.isfinite(t[k]) and t[k] > 0
                   for k in ("host_ms", "wall_ms", "device_busy_ms", "kernels")):
            raise AssertionError(f"18b: {p} {t}")
    batch = P.flagship_batch(dev)
    with torch.no_grad():
        n_tables = same_tables(P.phases(batch)[P.PHASES[3]](),
                               build_topology(batch, 4096, 7),
                               "18b full phase vs build_topology")
    log(f"18b profile_topology: {seconds:.1f} s; K3 per phase call {k3}, no other "
        f"kernel; the full phase's {n_tables} tables identical to build_topology's")
    return {"result": out, "k3": k3, "seconds": seconds}


def run_phase18(dev) -> dict:
    t0 = time.perf_counter()
    log("phase 18a: python -m mm2d3d_tpu_torch.tools.bench_e2e " + " ".join(E2E_ARGS))
    e2e = run_bench_e2e(dev)
    log("phase 18b: python -m mm2d3d_tpu_torch.tools.profile_topology")
    topo = run_profile_topology(dev)
    seconds = time.perf_counter() - t0
    log(f"phase 18: {seconds:.1f} s")
    return {"e2e": e2e, "topo": topo, "seconds": seconds}


def live_processes():
    """(pid, parent pid, session id) of every live process, read from
    /proc; zombies are left out, they end with their parent."""
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue  # ended meanwhile
        fields = stat[stat.rfind(")") + 2:].split()
        if fields[0] != "Z":
            yield int(d), int(fields[1]), int(fields[3])


def descendants() -> list:
    """Live processes below this one (children, their children, ...)."""
    parent = {pid: ppid for pid, ppid, _ in live_processes()}
    out, frontier = [], [os.getpid()]
    while frontier:
        pid = frontier.pop()
        kids = [c for c, pp in parent.items() if pp == pid]
        out += kids
        frontier += kids
    return out


def stop_processes() -> list:
    """Stop the loader pools' server processes (phase 10), then kill every
    process this script started that is still alive; returns the killed."""
    from mm2d3d_tpu_torch.data.loader import stop_worker_server

    stop_worker_server()
    left = descendants()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in left:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass  # a grandchild: its own parent reaps it
    return left


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    try:
        return run_phases(dev)
    finally:
        stop_processes()


def run_phases(dev) -> int:
    # phase 10's synthetic tree and run stay for phase 14
    cli_root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        return run_all(dev, cli_root)
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)


def run_all(dev, cli_root: str) -> int:
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
    check_bn(res, dev)
    check_slot_gather(res, dev)

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

    log("phase 10: configs/config.yaml through mm2d3d_tpu_torch.run, full width")
    cli_launches, cli_ms, cli_peak, cli_s = run_cli(dev, root=cli_root)
    running = descendants()  # the pools' forkserver and resource tracker
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 10: {left}")
    log(f"phase 10: {len(running)} server processes of the loader pools stopped; "
        "no process of this script left running")

    log("phase 11: configs/vkitti_skitti.yaml and configs/a2d2.yaml through "
        "mm2d3d_tpu_torch.run, full width")
    kitti_launches, kitti_ms, kitti_peak, kitti_s = run_kitti(dev)
    running = descendants()
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 11: {left}")
    log(f"phase 11: {len(running)} server processes of the loader pools stopped; "
        f"no process of this script left running; phase 11 {kitti_s:.1f} s")

    log("phase 12: the training options (host topologies, child slots, frozen "
        "batch norm, residual blocks, gradient accumulation), full width")
    opts = run_options(res, dev, cli_ms, kitti_ms)
    running = descendants()
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 12: {left}")
    log(f"phase 12: {len(running)} server processes of the loader pools stopped; "
        "no process of this script left running")

    log("phase 13: data parallelism, one process per rank")
    dp = run_data_parallel(dev)
    running = descendants()
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 13: {left}")
    log(f"phase 13: {len(running)} server processes of the loader pools stopped; "
        "no process of this script left running")

    log("phase 14: the self-training stage and the training tools")
    st = run_self_training(dev, cli_root)
    running = descendants()
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 14: {left}")
    log(f"phase 14: {len(running)} server processes of the loader pools stopped; "
        "no process of this script left running")

    log("phase 15: batches past the dense neighbour map (key search), the "
        "loader's C++ image ops")
    p15 = run_phase15(dev)
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 15: {left}")

    log("phase 16: the host self-validation tool (tools/autotune.py, doctor --perf)")
    p16 = run_phase16(dev)
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 16: {left}")

    log("phase 17: the probe kernels K7-K10 vs their plain versions, then the "
        "probe tools (tools/exp_dma_gather.py, tools/exp_bandmm_variants.py)")
    p17 = run_phase17(res, dev)
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 17: {left}")

    log("phase 18: the sustained fit and its controls (tools/bench_e2e.py), the "
        "topology build by phase (tools/profile_topology.py)")
    p18 = run_phase18(dev)
    left = stop_processes()
    if left:
        raise AssertionError(f"processes still running after phase 18: {left}")

    from mm2d3d_tpu_torch.ops import kernels

    main_case = {"propagate": "L0 ", "maxpool": f"({BATCH}, 240, 400, 64) float32",
                 "bandmm": "enc L0 tier1+center H=3 bfloat16",
                 "bandmm_dw": "enc L0 tier1+center H=3 bfloat16",
                 "tapsum": "enc L0 fwd Ci=16 Co=16 bfloat16",
                 "head2d": f"({BATCH}, 240, 400, 64)x3 bfloat16",
                 "exp_group_gather": "H=3 V=65536 Ci=16 G=8",
                 "exp_window_copy": "H=3 V=65536 Ci=16 w=1024",
                 "exp_window_gather": "H=3 V=65536 Ci=16 w=1024",
                 "exp_bandmm": "real-table E=full 64 voxels/block V=65536",
                 "batchnorm2d": "flagship stem rgb",
                 "slot_gather": "mink stem grad (125, V0) C=32"}
    # each kernel's launches on the path it runs on: the eval forward of
    # phase 4 (K1, K3, K4), the train step of phase 6 (K2), the opt-in eval
    # forward of phase 8 (K5, K6); "cli_launches": phase 10's fit through
    # the CLI (K1-K4); "kitti_launches": phase 11's fit of each KITTI config;
    # "kitti_case": the kernel at the KITTI configs' shapes (phase 3);
    # "child_slot_launches": phase 12d's two train steps over child slots;
    # "options_launches": phase 12e's 4-step fit with residual blocks;
    # "child_slot_case": K1 / K2 over the child slots, down L0 -> L1, tier 1
    # (phase 12d); "dp_cli_launches_per_rank": phase 13c's fit through the
    # CLI, each of the two ranks; the probe kernels K7-K10: phase 17's run
    # of the probe tools (0 on every path above);
    # "bench_e2e_launches_per_step": a train step of phase 18a's fits, which
    # every fit's launches were held to, with the card's and host-built
    # topologies; "profile_topology_launches": one call of each of phase
    # 18b's four phases
    path_launches = {"bandmm_dw": train_launches["bandmm_dw"],
                     "batchnorm2d": train_launches["batchnorm2d"],
                     "tapsum": optin_launches["tapsum"],
                     "head2d": optin_launches["head2d"],
                     **{k: p17["launches"][k] for k in PROBE_KERNELS}}
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
            "cli_launches": cli_launches[name],
            "kitti_launches": {c: n[name] for c, n in kitti_launches.items()},
            "kitti_case": next(({"case": c[1], "ms": c[4], "plain_ms": c[5],
                                 "bound_ms": c[6], "bound_by": c[7]}
                                for c in res.cases if c[0] == name and "KITTI" in c[1]),
                               None),
            "child_slot_launches": opts["child_launches"][name],
            "options_launches": opts["options"]["launches"][name],
            "child_slot_case": next(({"case": c[1], "ms": c[4], "plain_ms": c[5],
                                      "bound_ms": c[6], "bound_by": c[7]}
                                     for c in res.cases if c[0] == name and
                                     c[1].startswith("child slots down L0->L1 tier1")),
                                    None),
            "dp_cli_launches_per_rank": [n[name] for n in dp["launches"]],
            "generator_launches_per_scan": st["gen"]["launches"][name] / st["gen"]["scans"],
            "learning_check_launches_per_step": st["learn"]["check"]["per_step"][name],
            "b32_eval_launches_per_forward": p15["eval"]["per_forward"][name],
            "b24_train_launches_per_step": p15["train"]["launches"][name],
            "autotune_topology_launches": p16["probes"]["topology_launches"][name],
            "autotune_fit_launches_per_step": p16["probes"]["per_step"][name],
            "bench_e2e_launches_per_step": {
                "device_topology": p18["e2e"]["per_step"][False][name],
                "host_topology": p18["e2e"]["per_step"][True][name]},
            "profile_topology_launches": [
                p18["topo"]["result"]["phases"][p]["launches"][name]
                for p in p18["topo"]["result"]["phases"]],
        })
    log(f"slice: {slice_ms:.2f} ms/batch of {BATCH}, {BATCH * 1e3 / slice_ms:.1f} scans/s")
    log(f"train: {train_ms:.2f} ms/step of 2 x {BATCH}, "
        f"{2 * BATCH * 1e3 / train_ms:.1f} scans/s")
    log(f"opt-in slice: {optin_ms:.2f} ms/batch, opt-in train: {optin_train_ms:.2f} "
        "ms/step")
    log(f"CLI: {cli_ms:.2f} ms/step of 2 x 16, {32 * 1e3 / cli_ms:.1f} scans/s, peak "
        f"{cli_peak:.2f} GiB, {cli_s:.1f} s")
    for config, ms in kitti_ms.items():
        log(f"CLI {config}: {ms:.2f} ms/step of 2 x 16, {32 * 1e3 / ms:.1f} scans/s, "
            f"peak {kitti_peak[config]:.2f} GiB")
    log(f"CLI with train.host_topology=true: config.yaml {opts['host_cli_ms']:.2f}, "
        f"vkitti_skitti.yaml {opts['host_kitti_ms']:.2f} ms/step; train step batch "
        f"{BATCH}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in opts["step_ms"].items())
        + "; host build per topology: " + ", ".join(
            f"{p} {v['host_ms']:.2f} ms alone, {v['host_ms_3_threads']:.2f} with 3 "
            f"threads, card {v['card_build_ms']:.2f}" for p, v in opts["host"].items())
        + f"; options fit, hits dropped per step {opts['options']['dropped_per_step']}"
        + f"; phase 12 {opts['seconds']:.1f} s")
    log(f"self-training: generator {st['gen']['ms_per_scan']:.2f} ms per scan over "
        f"{st['gen']['scans']} scans (bf16), card vs CPU fp32 probs max|d| "
        f"{st['gen']['card_cpu_prob_err']:.3e}; learning check {st['learn']['check']['s']:.1f}"
        f" s, --mutate {st['learn']['mutated']['s']:.1f} s; {st['figs']['files']} "
        f"figures; phase 14 {st['seconds']:.1f} s")
    log(f"data parallel CLI, 2 ranks sharing the card (gloo; not a scaling number): "
        + ", ".join(f"{m:.2f} ms/step, peak {g:.2f} GiB" for m, g in zip(dp["ms"], dp["peak"]))
        + f"; phase 13 {dp['seconds']:.1f} s")
    ev, tr, bench = p15["eval"], p15["train"], p15["bench"]
    log(f"key-search batches: eval forward batch {SEARCH_EVAL_BATCH} {ev['ms']:.2f} "
        f"ms/batch, peak {ev['peak']:.2f} GiB; train step batch {SEARCH_TRAIN_BATCH} "
        f"per domain {tr['ms']:.2f} ms/step, peak {tr['peak']:.2f} GiB; card topology "
        "builds " + ", ".join(f"B={b} {v:.2f} ms" for b, v in p15["builds"].items()))
    log("loader scans/s (" + ", ".join(f"{k} {v:.2f}" for k, v in bench["results"].items())
        + f"), stages at batch {bench['batch']}: loader "
        f"{bench['stage_loader_ms_per_batch']:.2f} ms, copy "
        f"{bench['stage_transfer_ms_per_batch']:.2f} ms, train step "
        f"{bench['stage_device_step_ms']:.2f} ms; the CLI step (phase 10) "
        f"{cli_ms:.2f} ms; phase 15 {p15['seconds']:.1f} s")
    log("autotune (phase 16): doctor --perf " + json.dumps(p16["cli"]["result"])
        + "; in process " + json.dumps(p16["probes"]["result"])
        + f"; phase 16 {p16['seconds']:.1f} s")
    log("probe tools (phase 17): " + json.dumps({"exp_dma_gather": p17["dma"],
                                                 "exp_bandmm_variants": p17["band"]})
        + f"; phase 17 {p17['seconds']:.1f} s")
    e2e = p18["e2e"]["result"]
    log(f"sustained fit (phase 18a, batch {BATCH} per domain, workers "
        f"{e2e['loader_scans_per_sec_by_workers']} scans/s): "
        f"{e2e['e2e_ms_per_step']:.2f} ms/step, {e2e['e2e_train_scans_per_sec']:.2f} "
        f"scans/s over {e2e['e2e_steps_measured']} steps; controls: host batches "
        f"{e2e['ctrl_host_batches_ms_per_step']:.2f}, device batches "
        f"{e2e['ctrl_device_batches_ms_per_step']:.2f} ms/step; stages: loader "
        f"{e2e['stage_loader_ms_per_batch']:.2f} ms, copy "
        f"{e2e['stage_transfer_ms_per_batch']:.2f} ms of {e2e['batch_wire_bytes']} "
        f"bytes, step {e2e['stage_device_step_ms']:.2f} ms; host topologies "
        f"{e2e['e2e_ms_per_step_host_topology']:.2f} ms/step")
    log("topology by phase (phase 18b, " + p18["topo"]["result"]["smi"] + "): " + "; ".join(
        f"{p} host {t['host_ms']:.2f} wall {t['wall_ms']:.2f} device "
        f"{t['device_busy_ms']:.3f} ms, {t['kernels']:.0f} kernels"
        for p, t in p18["topo"]["result"]["phases"].items())
        + f"; phase 18 {p18['seconds']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
