"""The command: one run of one cell, its result line and its checks.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted` (window calls), `failed` (calls that dropped voxels or rulebook
hits), `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` the `breakdown`, and last
`checks`: each number compared beside its limit, which are also the last
lines of standard error.  Without a CUDA device, with fewer devices than the
cell asks for, or with JAX or the JAX package loaded once the run is over,
it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import torch

from . import check, manifest
from .cell import Run

FORBIDDEN = ("jax", "jaxlib", "flax", "mm2d3d_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `mm2d3d_tpu_torch` is not `mm2d3d_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def execute(spec: Dict, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> Tuple[Dict, List[str]]:
    """One run on `device` -> (result, check lines).  Metrics are read only
    on a CUDA device; elsewhere `metrics` stays empty (no CPU number under a
    device metric's name)."""
    device = torch.device(device)
    run = Run(spec, seed, device)
    run.setup()
    rec = run.rec
    rec["setup_s"] = time.perf_counter() - t_start
    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run.window(seconds, spans=traced)
    if traced:
        run.traced(spec["mix"]["traced_calls"])
    run.release()
    numbers = run.compare()
    correct, shown = check.judge(numbers, spec["limits"], spec["not_compared"])
    if traced:
        rec["work_pool"] = run.work_of_pool()

    metrics = {}
    if on_card:
        for m in (spec["per_layer"] if traced else spec["end_to_end"]):
            value = manifest.reader(m["name"], spec["root"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": rec["calls"],
        "failed": rec["overflow_calls"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else device.type,
            "count": spec["cell"]["chips"],
            "memory_peak_bytes": max(setup_peak, rec["peak_bytes"] or 0),
        },
    }
    trace = rec.get("trace") or {}
    if traced and trace:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
        result["attributed_share"] = trace["attributed_share"]
    result["checks"] = shown
    lines = ["set-up phases (s): " + json.dumps(rec["setup_phases"])]
    if "_worst" in numbers:
        lines.append("worst leaves: " + json.dumps(numbers["_worst"]))
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in shown.items()]
    return result, lines


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    man = manifest.load()
    spec = manifest.cell_spec(man, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    card = power_limit()
    print(f"imports and device: {time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    result, lines = execute(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                            t_start)
    result["device"]["card"] = card
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {bad}, which the port must not load", file=sys.stderr)
        return 3
    print(f"card: {card}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    # "checks" last
    result["checks"] = result.pop("checks")
    print(json.dumps(result))
    return 0
