"""Probe: how fast does the card move slot rows, by mechanism?  Port of
the JAX package's TPU probe `tools/exp_dma_gather.py`, on one NVIDIA GPU.

    python -m mm2d3d_tpu_torch.tools.exp_dma_gather

The TPU probe asked whether copies issued from inside a kernel could beat
XLA's gather engine for the slot rows the sparse convs gather (ROADMAP
Queue 2, the slot gather inside K1/K2).  Mosaic could not copy a single
row (8-row groups were its finest grain), so its answer was "no".  The
same mechanisms on Hopper, at the TPU probe's own sizes (its three
`case`s), each against `torch.index_select` computing the same rows:

  A. `torch.index_select` of H x V random rows of x (V, Ci): the library
     gather, the incumbent (the TPU's `jnp.take`); A2 the same rows as
     the port's sparse convs gathered them before their own kernel
     (`x[idx.long()]`; now `ops/kernels/slot_gather.py`); then K7 per row
     on the same rows (B1), a
     hand-written gather of the slot rows themselves.
  B. K7 `group_gather`: rows by group id with `cp.async`, at the TPU's
     grain G = 8 and per row (G = 1) at equal bytes, 128 lanes wide
     (`ops/kernels/exp_gather.py`).  Prints G groups/s and G rows/s.
  C. K8 `window_copy`: contiguous windows of w = 1024 and 2048 rows, one
     bulk asynchronous copy each.  Prints GB/s and us per window.
  D. K9 `window_gather`: rows by local id out of a window multicast to a
     thread-block cluster's shared memory (the TPU's one-hot product), at
     the plan's cluster size (2 CTAs up to 96 KB of window, 4 above), then
     the other.  Prints G rows/s.

Every kernel's result is held bit-equal to its plain version before it is
timed (CUDA events around 20 calls queued behind a sleep kernel, median of
3: `tools/kernel_cases.py::cuda_ms`).  Each case prints one line per
mechanism, then the card's name and power limit, and the last line is one
JSON object with every reading.  Needs a CUDA device: raises without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops.kernels.exp_gather import (
    GATHER_CLUSTERS, group_gather, group_gather_ref, group_order, window_copy,
    window_copy_ref, window_gather, window_gather_plan, window_gather_ref,
)
from .kernel_cases import GATHER_CASES, GATHER_WINDOWS, cuda_ms

CASES = GATHER_CASES  # (H, V, Ci)
T = 512  # the TPU probe's output tile: ids per slot and tile of B
LANES = 128  # B's row width (the TPU's lane width)
GROUPS = (8, 1)  # B's rows per group: the TPU's grain, then per row
WINDOWS = GATHER_WINDOWS  # C's and D's window rows
SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("this probe times CUDA kernels and needs a CUDA device")
    return torch.device("cuda", 0)


def bf16(rng: np.random.RandomState, *shape, dev) -> torch.Tensor:
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)


def ints(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def check_equal(out: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    if out.shape != ref.shape or not torch.equal(out, ref):
        raise AssertionError(f"{what}: kernel != plain version")


def group_inputs(rng, h: int, v: int, dev) -> dict:
    """B's inputs: x (max(V / 8, 8 T), 128) and, per G, ids (H, G' T ntile)
    with ntile = min(8, V / T) tiles, so that every G moves the same bytes:
    group ids at G = 8 (the TPU's), row ids at G = 1."""
    x = bf16(rng, max(v // 8, T * 8), LANES, dev=dev)
    ntile = min(8, v // T)
    out = {"x": x}
    for g in GROUPS:
        tile = T * 8 // g
        out[g] = ints(rng.randint(0, x.shape[0] // g, (h, tile * ntile)), dev)
    return out


def run_case(h: int, v: int, ci: int, dev, seed: int = 0) -> list:
    """Every mechanism at one of the TPU probe's sizes; one dict per
    reading (kernel, variant, ms, library_ms, bytes and the rates)."""
    rng = np.random.RandomState(seed)
    tag = f"H={h} V={v} Ci={ci} bf16"
    x = bf16(rng, v, ci, dev=dev)
    idx = ints(rng.randint(0, v, (h, v)), dev)
    rows = h * v
    flat = idx.reshape(-1)
    a = cuda_ms(lambda: torch.index_select(x, 0, flat))
    print(f"A index_select    {tag:34s} {a:9.4f} ms\n"
          f"    -> {rows / a / 1e6:.2f} G rows/s", flush=True)
    out = [{"case": tag, "kernel": "index_select", "variant": "A", "ms": a,
            "rows": rows, "g_rows_per_s": rows / a / 1e6}]
    # the sparse convs' gather before `ops/kernels/slot_gather.py`: x[idx.long()]
    a2 = cuda_ms(lambda: x[idx.long()])
    print(f"A2 x[idx.long()]  {tag:34s} {a2:9.4f} ms\n"
          f"    -> {rows / a2 / 1e6:.2f} G rows/s", flush=True)
    out.append({"case": tag, "kernel": "advanced indexing", "variant": "A2", "ms": a2,
                "rows": rows, "g_rows_per_s": rows / a2 / 1e6})
    # K7 per row on A's own rows: the same function as A
    res = group_gather(x, idx, 1, v)
    check_equal(res, torch.index_select(x, 0, flat), f"K7 G=1 on A's rows {tag}")
    b1 = cuda_ms(lambda: group_gather(x, idx, 1, v))
    print(f"B1 group gather G=1, A's rows {tag:22s} {b1:9.4f} ms\n"
          f"    -> {rows / b1 / 1e6:.2f} G rows/s, {a / b1:.2f}x of A's rate, "
          f"{a2 / b1:.2f}x of A2's", flush=True)
    out.append({"case": tag, "kernel": "exp_group_gather", "variant": "G=1 A's rows",
                "ms": b1, "library_ms": a, "rows": rows,
                "g_rows_per_s": rows / b1 / 1e6, "vs_library": a / b1,
                "vs_advanced_indexing": a2 / b1})

    gi = group_inputs(rng, h, v, dev)
    xg = gi["x"]
    for g in GROUPS:
        tile = T * 8 // g
        ids = gi[g]
        res = group_gather(xg, ids, g, tile)
        check_equal(res, group_gather_ref(xg, ids, g, tile), f"K7 G={g} {tag}")
        row_ids = (group_order(ids, tile).long()[:, None] * g
                   + torch.arange(g, device=dev)).reshape(-1)
        check_equal(torch.index_select(xg, 0, row_ids), res, f"K7 G={g} library")
        ms = cuda_ms(lambda: group_gather(xg, ids, g, tile))
        lib = cuda_ms(lambda: torch.index_select(xg, 0, row_ids))
        n_groups, n_rows = ids.numel(), row_ids.numel()
        print(f"B group gather G={g} {n_groups} groups {tag:22s} {ms:9.4f} ms "
              f"(index_select {lib:.4f} ms)\n"
              f"    -> {n_groups / ms / 1e6:.4f} G groups/s, {n_rows / ms / 1e6:.2f} "
              f"G rows/s, {lib / ms:.2f}x of index_select's rate "
              f"(A {rows / a / 1e6:.2f} G rows/s)", flush=True)
        out.append({"case": tag, "kernel": "exp_group_gather", "variant": f"G={g}",
                    "ms": ms, "library_ms": lib, "groups": n_groups, "rows": n_rows,
                    "g_groups_per_s": n_groups / ms / 1e6,
                    "g_rows_per_s": n_rows / ms / 1e6, "vs_library": lib / ms})

    for w in WINDOWS:
        n = max(h * v // w, 1)
        offs = ints(rng.randint(0, (v - w) // 8, (n,)) * 8, dev)
        res = window_copy(x, offs, w)
        check_equal(res, window_copy_ref(x, offs, w), f"K8 w={w} {tag}")
        row_ids = (offs.long()[:, None] + torch.arange(w, device=dev)).reshape(-1)
        ms = cuda_ms(lambda: window_copy(x, offs, w))
        lib = cuda_ms(lambda: torch.index_select(x, 0, row_ids))
        moved = n * w * ci * x.element_size()
        print(f"C window copy w={w:5d} {tag:30s} {ms:9.4f} ms "
              f"(index_select {lib:.4f} ms)\n"
              f"    -> {moved / ms / 1e6:.0f} GB/s, {ms / n * 1000:.3f} us/window "
              f"over {n} windows ({ms / a:.2f}x vs A's time)", flush=True)
        out.append({"case": tag, "kernel": "exp_window_copy", "variant": f"w={w}",
                    "ms": ms, "library_ms": lib, "windows": n,
                    "gb_per_s": moved / ms / 1e6,
                    "us_per_window": ms / n * 1000, "vs_library": lib / ms})

    for w in WINDOWS:
        lidx = ints(rng.randint(0, w, (h, v)), dev)
        xw = x[:w]
        lflat = lidx.reshape(-1)
        lib = cuda_ms(lambda: torch.index_select(xw, 0, lflat))
        default = window_gather_plan(rows, w, ci * xw.element_size())["cluster"]
        for cluster in sorted(GATHER_CLUSTERS, key=lambda c: c != default):  # the plan's first
            res = window_gather(xw, lidx, cluster)
            check_equal(res, window_gather_ref(xw, lidx), f"K9 w={w} cluster {cluster} {tag}")
            ms = cuda_ms(lambda: window_gather(xw, lidx, cluster))
            variant = f"w={w}" + ("" if cluster == default else f" cluster {cluster}")
            print(f"D window gather {variant:16s} {tag:28s} {ms:9.4f} ms "
                  f"(cluster {cluster}; index_select {lib:.4f} ms)\n"
                  f"    -> {rows / ms / 1e6:.2f} G rows/s ({ms / a:.2f}x vs A's time)",
                  flush=True)
            out.append({"case": tag, "kernel": "exp_window_gather", "variant": variant,
                        "cluster": cluster, "ms": ms, "library_ms": lib, "rows": rows,
                        "g_rows_per_s": rows / ms / 1e6, "vs_library": lib / ms})
    return out


def run(dev) -> list:
    """The TPU probe's three cases."""
    return [r for h, v, ci in CASES for r in run_case(h, v, ci, dev)]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    dev = require_cuda()
    readings = run(dev)
    smi = subprocess.run(SMI, capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
