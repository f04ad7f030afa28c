"""K1 (`slot_conv_apply`) and K2 (`slot_conv_dw`) at the flagship's call
shapes and at the tensor-core kernels' edges: the cases of `chip_smoke.py`
phase 3, timed on one tree, or on two trees in turns on one card.

    python mm2d3d_tpu_torch/tools/slotconv_ab.py              # this tree
    python mm2d3d_tpu_torch/tools/slotconv_ab.py --ab OTHER   # OTHER, this, this, OTHER

OTHER is the root of another checkout of the repository (an older commit
unpacked with `git archive`).  Each tree runs in its own process, which
imports that tree's `mm2d3d_tpu_torch`, builds its kernels and times every
case in bf16 (CUDA events around 20 calls queued behind a sleep kernel,
median of 3 samples; the same inputs from the same seeds in every tree).
`--ab` prints each case's four readings and whether both of this tree's are
under both of OTHER's.  The forms (`tools/kernel_cases.py`, this tree's
in every run) use only the wrappers' interface, which is the same in both
trees.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _kernel_cases():
    """This tree's `tools/kernel_cases.py`, loaded from its file: in a child
    run the package on the path may be another checkout's, and both trees
    must get the same inputs."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernel_cases.py")
    spec = importlib.util.spec_from_file_location("kernel_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree() -> dict:
    """bf16 ms of every case on the tree whose package is imported."""
    import torch

    from mm2d3d_tpu_torch.ops.kernels.bandmm import slot_conv_apply
    from mm2d3d_tpu_torch.ops.kernels.bandmm_dw import slot_conv_dw

    kc = _kernel_cases()
    cuda_ms = kc.cuda_ms
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16

    def cast(*ts):
        return tuple(None if t is None else t.to(bf).contiguous() for t in ts)

    cases = {}
    for name, (xm, xs, tap, w) in kc.k1_forms(dev):
        xm, xs, w = cast(xm, xs, w)
        cases[f"K1 {name}"] = cuda_ms(lambda: slot_conv_apply(xm, xs, tap, w))
    for name, (xm, xs, tap, g), k in kc.k2_forms(dev):
        xm, xs, g = cast(xm, xs, g)
        cases[f"K2 {name}"] = cuda_ms(lambda: slot_conv_dw(xm, xs, tap, g, k_taps=k))
    for name, (xm, xs, tap, w, g), k in kc.edge_forms(dev):
        xm, xs, w, g = cast(xm, xs, w, g)
        cases[f"K1 {name}"] = cuda_ms(lambda: slot_conv_apply(xm, xs, tap, w))
        cases[f"K2 {name}"] = cuda_ms(lambda: slot_conv_dw(xm, xs, tap, g, k_taps=k))
    return {"device": torch.cuda.get_device_name(0), "cases": cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="root of the checkout whose package to time (a child run)")
    ap.add_argument("--ab", default=None, metavar="OTHER",
                    help="time OTHER and this tree in turns: OTHER, this, this, OTHER")
    args = ap.parse_args(argv)
    if args.tree is not None:
        import torch

        if not torch.cuda.is_available():
            print("slotconv_ab: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(time_tree()))
        return 0
    trees = [HERE] if args.ab is None else [os.path.abspath(args.ab), HERE, HERE,
                                            os.path.abspath(args.ab)]
    runs = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree],
            capture_output=True, text=True, cwd=tree,
            env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode != 0:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    names = list(runs[-1]["cases"])
    if args.ab is None:
        for n in names:
            print(f"{n:60s} {runs[0]['cases'][n]:.4f} ms")
        return 0
    print(f"{'case (bf16, ms)':60s} {'other':>8s} {'this':>8s} {'this':>8s} "
          f"{'other':>8s}  ratio")
    for n in names:
        o1, t1, t2, o2 = (r["cases"].get(n, float("nan")) for r in runs)
        faster = max(t1, t2) < min(o1, o2)
        print(f"{n:60s} {o1:8.4f} {t1:8.4f} {t2:8.4f} {o2:8.4f}  "
              f"{(t1 + t2) / (o1 + o2):.3f}{'' if faster else '  NOT FASTER'}")
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, next((sys.argv[i + 1] for i, a in enumerate(sys.argv)
                             if a == "--tree"), HERE))
    sys.exit(main())
