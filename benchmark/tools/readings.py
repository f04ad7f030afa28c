"""The readings that the limits of `correct` are set from, on the card.

    python3 benchmark/tools/readings.py --workload <cell> --program-seeds 1,2,...
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 3]
        [--out readings_<cell>.json]

In one process: the program's numbers on each program seed (set-up and its
warm steps; an eval cell also a window of `--seconds`), the control's (the
reference in fp8 in the program's place) on each control seed, and, for a
train cell, the planted fault "half of the batch left out" (the reference
on the first half of each batch in the program's place) on each fault seed.
Prints each number's largest program reading and smallest control and
fault readings, and writes every reading to `--out`.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import torch  # noqa: E402

from core import manifest  # noqa: E402
from core.cell import Run, as_program, numbers  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    spec = manifest.cell_spec(manifest.load(), args.workload)
    kind = spec["mix"]["kind"]
    out = {"cell": args.workload, "program": {}, "control": {}, "fault_half_batch": {}}
    for seed in _seeds(args.program_seeds):
        t0 = time.perf_counter()
        run = Run(spec, seed, args.device)
        run.setup()
        if kind == "eval":
            run.window(args.seconds)
        run.release()
        out["program"][seed] = run.compare()
        print(f"program seed {seed}: {out['program'][seed]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for seed in sorted(set(_seeds(args.control_seeds)) | set(_seeds(args.fault_seeds))):
        run = Run(spec, seed, args.device)
        run.make_pool()
        ref = run.reference_record("fp32")
        if seed in _seeds(args.control_seeds):
            out["control"][seed] = numbers(kind, as_program(kind, run.reference_record("fp8")),
                                           ref)
            print(f"control seed {seed}: {out['control'][seed]}", flush=True)
        if kind == "train" and seed in _seeds(args.fault_seeds):
            out["fault_half_batch"][seed] = numbers(
                kind, run.reference_record("fp32", half=True), ref)
            print(f"half-batch seed {seed}: {out['fault_half_batch'][seed]}", flush=True)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
    for part, pick in (("program", max), ("control", min), ("fault_half_batch", min)):
        readings = [r for r in out[part].values()]
        if readings:
            keys = [k for k in readings[0] if not k.startswith("_")]
            print(part, {k: pick(r[k] for r in readings) for k in keys}, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
