"""K1's and K2's tensor-core tiles, measured: the bf16 slot convolutions at
the flagship's call shapes (`tools/kernel_cases.py`'s forms) under several
launch plans, on one NVIDIA GPU.

    python -m mm2d3d_tpu_torch.tools.slotconv_tiles

K1 (`csrc/bandmm.cu`) takes K6's tiles, so its variants are plans alone:
voxels per block (64 or 128) and the number of band groups (splits),
passed to the built library through its C interface.  K2's variants are
`csrc/bandmm_dw.cu` built for another stage (voxels per stage and ring
depth, set by -D macros; nvcc into a temporary directory), each under
`dw_plan`'s chunk plans aimed at 132, 264 or 528 blocks.  Every variant
is held to the plain version (1e-4 * max|plain|), then timed by CUDA
events in turns (the list, then the list reversed); both readings are
printed, the wrapper's own plan marked.  `apply_plan` and `dw_plan` pick
what these numbers favour; rerun this after a change to either kernel.
Refuses to run without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from ..ops.kernels import CSRC_DIR, NVCC_FLAGS, _nvcc, ptr, stream
from ..ops.kernels import bandmm as B
from ..ops.kernels import bandmm_dw as D
from ..ops.kernels.tapsum import scratch_shape
from .kernel_cases import cuda_ms, k1_forms, k2_forms

K1_PLANS = ((128, 1), (64, 1), (64, 2), (64, 3), (64, 5), (64, 9))  # (bm, splits)
K2_STAGES = ((64, 3), (32, 4), (64, 4), (128, 3))  # (voxels per stage, ring depth)
K2_TARGETS = (132, 264, 528)  # blocks a chunk plan aims at


def build_k2(stage, tmp: str) -> ctypes.CDLL:
    """`csrc/bandmm_dw.cu` built for another stage (voxels, ring depth)."""
    vox, depth = stage
    out = os.path.join(tmp, f"bandmm_dw_{vox}_{depth}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-DK2_STAGE_VOX={vox}",
                           f"-DK2_STAGE_RING={depth}", "-I", CSRC_DIR, "-o", out,
                           os.path.join(CSRC_DIR, "bandmm_dw.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {stage}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(out)
    D._bind(lib)
    return lib


def run_k1(lib, args, plan):
    xm, xs, tap, w = args
    k, ci, co = w.shape
    v, h = xs.shape[1], xs.shape[0]
    out = torch.empty((v, co), dtype=torch.float32, device=w.device)
    scratch = (torch.empty(scratch_shape(plan, v, co), dtype=torch.float32,
                           device=w.device) if plan.splits > 1 else None)
    B.KERNEL.check(lib.slot_conv_apply(
        ptr(xm), ptr(xs), ptr(tap), ptr(w), ptr(out), ptr(scratch), v, h, ci, co,
        k, 1, *plan, stream()))
    return out


def run_k2(lib, args, k, plan):
    xm, xs, tap, g = args
    v, h, ci, co = xs.shape[1], xs.shape[0], xs.shape[2], g.shape[1]
    shape = D.partial_shape(plan, k, ci, co, True)
    part = None if shape is None else torch.empty(shape, dtype=torch.float32,
                                                  device=g.device)
    out = torch.empty((k, ci, co), dtype=torch.float32, device=g.device)
    D.KERNEL.check(lib.slot_conv_dw(
        ptr(xm), ptr(xs), ptr(tap), ptr(g), ptr(part), ptr(out), v, h, ci, co,
        k, *plan, 1, stream()))
    return out


def in_turns(variants):
    """{label: (first, second)} ms of each callable, timed in order and
    then in reverse."""
    times = {label: [] for label, _ in variants}
    for order in (variants, variants[::-1]):
        for label, fn in order:
            times[label].append(cuda_ms(fn))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("slotconv_tiles: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16

    def cast(*ts):
        return tuple(None if t is None else t.to(bf).contiguous() for t in ts)

    k1_lib = B.KERNEL.lib()
    for name, fp32 in k1_forms(dev):
        xm, xs, tap, w = cast(fp32[0], fp32[1], None, fp32[3])
        args = (xm, xs, fp32[2], w)
        k, ci, co = w.shape
        h, v = xs.shape[:2]
        if not B.slot_tensor_cores(bf, ci, h, k):
            continue
        ref = B.slot_conv_apply_ref(*args)
        own = B.apply_plan(k, v, h, ci, co)
        plans = {own} | {own._replace(bm=bm, splits=min(s, k)) for bm, s in K1_PLANS}
        variants = []
        for plan in sorted(plans):
            out = run_k1(k1_lib, args, plan)
            err = float((out - ref).abs().max())
            if not err <= 1e-4 * float(ref.abs().max()):
                raise AssertionError(f"K1 {name} {plan}: max|d| {err}")
            variants.append((plan, lambda p=plan: run_k1(k1_lib, args, p)))
        for plan, (a, b) in in_turns(variants).items():
            mark = "  <- apply_plan" if plan == own else ""
            print(f"K1 {name:40s} bm={plan.bm:3d} splits={plan.splits:2d} "
                  f"bn={plan.bn:3d}: {a:.4f} / {b:.4f} ms{mark}")

    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(K2_STAGES)) as pool:
        libs = dict(zip(K2_STAGES, pool.map(lambda st: build_k2(st, tmp), K2_STAGES)))
        for name, fp32, k in k2_forms(dev):
            xm, xs, g = cast(fp32[0], fp32[1], fp32[3])
            args = (xm, xs, fp32[2], g)
            h, v, ci = xs.shape
            co = g.shape[1]
            if not B.slot_tensor_cores(bf, ci, h, k):
                continue
            ref = D.slot_conv_dw_ref(*args, k_taps=k)
            own = D.dw_plan(k, v, h, ci, co)
            variants = []
            for stage, lib in libs.items():
                for target in K2_TARGETS:
                    plan = D.dw_plan(k, v, h, ci, co, target=target)
                    out = run_k2(lib, args, k, plan)
                    err = float((out - ref).abs().max())
                    if not err <= 1e-4 * float(ref.abs().max()):
                        raise AssertionError(f"K2 {name} {stage} {plan}: max|d| {err}")
                    variants.append(((stage, target, plan),
                                     lambda lb=lib, p=plan: run_k2(lb, args, k, p)))
            for (stage, target, plan), (a, b) in in_turns(variants).items():
                mark = "  <- dw_plan" if stage == K2_STAGES[0] and plan == own else ""
                print(f"K2 {name:40s} vox={stage[0]:3d} ring={stage[1]} "
                      f"target={target:3d} chunks={plan.chunks:3d}: "
                      f"{a:.4f} / {b:.4f} ms{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
