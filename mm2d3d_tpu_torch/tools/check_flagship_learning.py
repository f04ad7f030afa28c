"""Flagship-scale learning-trajectory check on the card (port of the root
`tools/check_flagship_learning.py`).

The CPU tests run the train step at toy widths only; a numerical fault that
shows at the flagship's (a wrong adjoint tier, bf16 accumulation, the tier
and capacity interplay) would pass them and still train wrong.  This runs
25 fixed-seed train steps of the flagship (`flagship_task()`: 7 planes,
full_scale 4096, bf16, batch 8 per domain) over two fixed pairs of
`data.synthetic.make_batch` batches (seeds 0-3), weights from
`torch.Generator().manual_seed(0)` and the dropout generator seeded 7, and
holds `train/loss_total` against a recorded trajectory
(`mm2d3d_tpu_torch/checks/flagship_learning_h100.json`, recorded on an
H100; the JAX package's CHECKS.json is the TPU's):

- the first loss within 2% (the forward before any update);
- the mean of the last 5 within 5%;
- every step within the per-step gate, the sensitive one: the fault that
  `--mutate` injects (the backward of every submanifold conv at a 3-tier
  level over tier 1 alone, its mid and heavy tiers dropped from both
  gradients, `ops.spconv._DEBUG_DROP_COMPACT_TIERS_BWD`; the forward
  exact) moves the middle of the trajectory more than its end, because
  the optimizers re-converge around small gradient errors.

Usage:
    python -m mm2d3d_tpu_torch.tools.check_flagship_learning           # check
    python -m mm2d3d_tpu_torch.tools.check_flagship_learning --record  # record
    python -m mm2d3d_tpu_torch.tools.check_flagship_learning --mutate  # must fail

`--record` runs the trajectory twice (the step is reproducible on one card,
so the two must agree bit for bit) and once with the fault, and writes the
losses, the card's name and power limit, the torch, CUDA and cuDNN
versions, whether the repeat reproduced the losses, the fault's largest
per-step deviation, and the per-step gate: `--tol-step`, tightened to half
the fault's deviation where the fault moves less than twice that.  A check
takes the recorded gate unless `--tol-step` is given.

Exit 0 = within band; 1 = out of band (or no recorded trajectory).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 25
LAST_K = 5
TOL_FIRST = 0.02
TOL_LAST = 0.05
TOL_STEP = 0.0075
BATCH = 8
SCAN = dict(height=225, width=400, n_points=8192, num_classes=6, full_scale=4096)
TASK = {}  # `flagship_task` overrides: none, the flagship as shipped
CHECKS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "checks",
                  "flagship_learning_h100.json")


@contextlib.contextmanager
def mutated(on: bool = True):
    """The compacted tiers dropped from the submanifold backward inside the
    block (`--mutate`)."""
    from ..ops import spconv

    before = spconv._DEBUG_DROP_COMPACT_TIERS_BWD
    spconv._DEBUG_DROP_COMPACT_TIERS_BWD = on
    try:
        yield
    finally:
        spconv._DEBUG_DROP_COMPACT_TIERS_BWD = before


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN and matmuls inside the block (cuDNN takes TF32
    for fp32 convolutions unless told not to), so a trajectory does not
    depend on the caller's settings."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@no_tf32()
def trajectory(steps: int, device="cuda") -> list:
    """`train/loss_total` of `steps` train steps from the fixed seeds."""
    from ..data.synthetic import make_batch
    from ..flagship import flagship_task

    task = flagship_task(device=device, **TASK)
    task.init_params(torch.Generator().manual_seed(0))

    def mk(seed):
        return make_batch(np.random.RandomState(seed), batch_size=BATCH,
                          **SCAN).to(task.device)

    pairs = [(mk(0), mk(1)), (mk(2), mk(3))]
    gen = torch.Generator(device=task.device).manual_seed(7)
    t0 = time.perf_counter()
    logs = [task.train_step(*pairs[i % 2], gen)["train/loss_total"]
            for i in range(steps)]
    losses = [float(x) for x in torch.stack(logs).float().cpu()]
    print(f"{steps} steps in {time.perf_counter() - t0:.1f} s; losses: "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss: {losses}")
    return losses


def max_step_dev(losses, ref) -> float:
    """The largest relative deviation of a step's loss from the recorded."""
    return max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(losses, ref))


def compare(losses, band: dict, tol_step: float) -> bool:
    """Prints the three gates' readings -> whether all three hold."""
    first, last = losses[0], float(np.mean(losses[-LAST_K:]))
    ref = band["losses"]
    ok_first = abs(first - band["first_loss"]) <= TOL_FIRST * abs(band["first_loss"])
    ok_last = abs(last - band["last_loss_mean"]) <= TOL_LAST * abs(band["last_loss_mean"])
    dev = max_step_dev(losses, ref) if len(ref) == len(losses) else float("inf")
    ok_steps = dev <= tol_step

    def verdict(ok):
        return "ok" if ok else "OUT OF BAND"

    print(f"first {first:.4f} vs {band['first_loss']:.4f} ({verdict(ok_first)}); "
          f"last{LAST_K} {last:.4f} vs {band['last_loss_mean']:.4f} "
          f"({verdict(ok_last)}); max per-step dev {dev:.4%} vs {tol_step:.4%} "
          f"({verdict(ok_steps)})", flush=True)
    return ok_first and ok_last and ok_steps


def environment(device: torch.device) -> dict:
    """The device and toolchain a trajectory was recorded on."""
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "cudnn": torch.backends.cudnn.version()}
    if device.type == "cuda":
        env["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    else:
        env["card"] = f"none: {device.type}"
    return env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", action="store_true",
                    help="record the trajectory (on the card the file names)")
    ap.add_argument("--mutate", action="store_true",
                    help="drop the compacted tiers from the submanifold backward; "
                    "the check must fail")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--tol-step", type=float, default=None,
                    help=f"per-step gate (default: the recorded one; {TOL_STEP} "
                    "when recording)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--checks", default=CHECKS, help="the recorded trajectory's file")
    args = ap.parse_args(argv)

    from ..train.step import resolve_device

    device = resolve_device(args.device)
    if args.record:
        losses = trajectory(args.steps, device)
        again = trajectory(args.steps, device)
        with mutated():
            fault = max_step_dev(trajectory(args.steps, device), losses)
        tol = TOL_STEP if args.tol_step is None else args.tol_step
        # the gate must sit well below what the fault moves
        tol = min(tol, fault / 2)
        band = {
            "first_loss": losses[0],
            "last_loss_mean": float(np.mean(losses[-LAST_K:])),
            "losses": losses,
            "steps": args.steps,
            "last_k": LAST_K,
            "tol_first": TOL_FIRST,
            "tol_last": TOL_LAST,
            "tol_step": tol,
            "repeat_bit_identical": again == losses,
            "repeat_max_step_dev": max_step_dev(again, losses),
            "mutate_max_step_dev": fault,
            "env": environment(device),
        }
        os.makedirs(osp.dirname(osp.abspath(args.checks)), exist_ok=True)
        with open(args.checks, "w") as f:
            json.dump(band, f, indent=1)
        print(f"recorded {args.checks}: first {losses[0]:.4f}, last{LAST_K} "
              f"{band['last_loss_mean']:.4f}; repeat bit-identical "
              f"{band['repeat_bit_identical']}; the fault moves a step by up to "
              f"{fault:.4%}; per-step gate {tol:.4%}", flush=True)
        return 0

    if not osp.exists(args.checks):
        print(f"no recorded trajectory at {args.checks}: run with --record first")
        return 1
    with open(args.checks) as f:
        band = json.load(f)
    print(f"recorded on {band['env']}", flush=True)
    with mutated(args.mutate):
        if args.mutate:
            print("MUTATED: compacted tiers dropped from the submanifold backward",
                  flush=True)
        losses = trajectory(args.steps, device)
    tol = band["tol_step"] if args.tol_step is None else args.tol_step
    if not compare(losses, band, tol):
        print("FLAGSHIP LEARNING CHECK FAILED: the flagship's numerics moved; do "
              "not trust flagship training until explained (re-record only after "
              "diagnosing why)")
        return 1
    print("flagship learning check: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
