"""Probe: variants of K1's E build, on fixed gathered inputs.  Port of the
JAX package's TPU probe `tools/exp_bandmm_variants.py`, on one NVIDIA GPU.

    python -m mm2d3d_tpu_torch.tools.exp_bandmm_variants [--stages]

Times K10 (`ops/kernels/exp_bandmm.py::band_apply`, the banded slot-conv
apply in the TPU's (channels, voxels) layout) at the TPU probe's size,
V = 65,536, H = 3, Ci = Co = 16, K = 27, so that the build of the banded
matrix E is timed apart from the gathers.  The TPU probe timed four ways
of writing its E build at tile 512 (`main`) and a tile sweep with a
band-pairing variant (`main2`, argument `2`); here the Hopper counterparts
of both questions, every combination of:

  - the E build: `full` stages all 27 bands (K1's route today) or
    `compact` only the bands some row of the tile hits (ROADMAP Queue 2,
    skipping empty bands);
  - voxels per block: 64 or 128.

over two tap tables: `real-table` (seeded, the way a slot table holds its
taps: distinct, ascending, never 13, 80% hits; the TPU probe's own recipe
holds duplicates and tap 13, on which its variants compute different
functions) and `flagship L0` (the level-0 tier-1 table of a batch-8
flagship topology, whose tiles hit fewer bands).  Each variant is held to
the plain version within 1e-4 * max|plain| and to itself over two calls,
bit for bit, then timed (CUDA events around 20 calls queued behind a sleep
kernel, median of 3) beside the plain version and the bytes' bound at the
HBM rate.  No PyTorch call computes this function (none picks a weight
per row), so there is no library row.  Prints one line per variant, the
card's name and power limit, and a JSON last line.  Needs a CUDA device:
raises without one.

`--stages` also asks where the time goes: each of its variants is
`csrc/exp_bandmm.cu` with steps of the block cut out (no product; no E
build; no zeroing of E; all three: staging and stores only), built by nvcc
into a temporary directory (the package's source is untouched) and timed
on the real-table taps beside the whole kernel.  A cut variant's output is
wrong by design and is not checked.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..ops.kernels import CSRC_DIR, NVCC_FLAGS, _nvcc, ptr, stream
from ..ops.kernels.exp_bandmm import (
    E_BUILDS, VOXELS_PER_BLOCK, band_apply, band_apply_ref, real_table_taps,
)
from .exp_dma_gather import SMI, require_cuda
from .kernel_cases import cuda_ms

V, H, CI, CO, K = 65536, 3, 16, 16, 27  # the TPU probe's sizes
REL_TOL = 1e-4  # max|kernel - plain| <= REL_TOL * max|plain| (fp32 sums in another order)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def inputs(dev, seed: int = 0, v: int = V, taps: str = "real-table") -> tuple:
    """(xm (Ci, V), x (H, Ci, V), tap (H, V), w (Co, K * Ci)) on `dev`, bf16
    but the int32 taps, from `seed`; taps "real-table" (`real_table_taps`)
    or "flagship L0" (the level-0 tier-1 table of a batch-8 flagship
    topology, V its capacity)."""
    rng = np.random.RandomState(seed)
    if taps == "flagship L0":
        from .kernel_cases import _hierarchy

        tap = _hierarchy(dev).levels[0].slot_tap.contiguous()
        v = tap.shape[1]
    else:
        tap = torch.from_numpy(real_table_taps(rng, H, v, K)).to(dev)

    def bf16(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    return bf16(CI, v), bf16(H, CI, v), tap, bf16(CO, K * CI)


def bound_ms(xm, x, tap, w, out) -> float:
    """Bytes read and written once (the slot rows that hold a tap, xm, the
    taps, W and the output) at the HBM rate; the useful products, 0.11
    GFLOP here, take ~0.1 us on the tensor cores."""
    hits = int(((tap >= 0) & (tap < K)).sum())
    n = (hits * x.shape[1] * x.element_size()
         + sum(t.numel() * t.element_size() for t in (xm, tap, w, out)))
    return n / HBM_BYTES_PER_S * 1e3


def run(dev) -> list:
    """Every (taps, E build, voxels per block) variant; one dict each."""
    out = []
    for taps in ("real-table", "flagship L0"):
        xm, x, tap, w = inputs(dev, taps=taps)
        ref = band_apply_ref(xm, x, tap, w)
        plain = cuda_ms(lambda: band_apply_ref(xm, x, tap, w), reps=5)
        scale = float(ref.abs().max())
        for e_build in E_BUILDS:
            for voxels in VOXELS_PER_BLOCK:
                tag = f"{taps} E={e_build} {voxels} voxels/block V={x.shape[2]}"
                res = band_apply(xm, x, tap, w, e_build, voxels)
                err = float((res - ref).abs().max())
                if not err <= REL_TOL * scale:
                    raise AssertionError(f"K10 {tag}: max|d| {err} > {REL_TOL} * {scale}")
                if not torch.equal(res, band_apply(xm, x, tap, w, e_build, voxels)):
                    raise AssertionError(f"K10 {tag}: two calls differ")
                ms = cuda_ms(lambda: band_apply(xm, x, tap, w, e_build, voxels))
                bnd = bound_ms(xm, x, tap, w, res)
                print(f"{tag:52s} {ms:8.4f} ms  plain {plain:8.4f} ms  bound "
                      f"{bnd:.4f} ms ({bnd / ms:.0%})  max|d| {err:.2e}", flush=True)
                out.append({"case": tag, "taps": taps, "e_build": e_build,
                            "voxels": voxels, "ms": ms, "plain_ms": plain,
                            "bound_ms": bnd, "max_abs_err": err,
                            "max_abs_plain": scale})
    return out


# the block's steps that `--stages` cuts out: (text in csrc/exp_bandmm.cu,
# its replacement)
CUTS = {
    "product": ("for (int b = 0; b < nb; ++b) {", "for (int b = 0; b < 0; ++b) {"),
    "E build": ("for (int e = tid; e < (H + 1) * Ci * BV; e += kThreads) {",
                "for (int e = tid; e < 0; e += kThreads) {"),
    "zeroing": ("for (int i = tid; i < nb * Ci * kEStride / 8; i += kThreads)",
                "for (int i = tid; i < 0; i += kThreads)"),
}
STAGE_VARIANTS = {"no product": ("product",), "no E build": ("E build",),
                  "no zeroing": ("zeroing",),
                  "staging and stores only": ("product", "E build", "zeroing")}


def build_cut(name: str, cuts, tmp: str) -> ctypes.CDLL:
    """csrc/exp_bandmm.cu without the steps `cuts`, built into `tmp`."""
    with open(os.path.join(CSRC_DIR, "exp_bandmm.cu")) as f:
        src = f.read()
    for cut in cuts:
        old, new = CUTS[cut]
        if src.count(old) != 1:
            raise RuntimeError(f"exp_bandmm.cu: the {cut} step is not where --stages "
                               "expects it")
        src = src.replace(old, new)
    tag = name.replace(" ", "_")
    path = os.path.join(tmp, f"exp_bandmm_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(tmp, f"libexp_bandmm_{tag}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(out)
    lib.exp_bandmm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.exp_bandmm.restype = ctypes.c_int
    return lib


def run_stages(dev) -> list:
    """The whole kernel and each cut variant on the real-table taps, full and
    compact E, 64 voxels a block, timed in turns (the list, then reversed)."""
    xm, x, tap, w = inputs(dev)
    h, ci, v = x.shape
    co, k = w.shape[0], w.shape[1] // ci
    out = torch.empty((co, v), dtype=torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(STAGE_VARIANTS)) as pool:
            built = [pool.submit(build_cut, name, cuts, tmp)
                     for name, cuts in STAGE_VARIANTS.items()]
            libs = dict(zip(STAGE_VARIANTS, (b.result() for b in built)))
        calls = {}
        for e_build in E_BUILDS:
            calls[f"E={e_build} whole kernel"] = (
                lambda eb=e_build: band_apply(xm, x, tap, w, eb, 64))
            for name, lib in libs.items():
                def call(lib=lib, eb=e_build):
                    rc = lib.exp_bandmm(ptr(xm), ptr(x), ptr(tap), ptr(w), ptr(out), v, h,
                                        ci, co, k, int(eb == "compact"), 64, stream())
                    if rc:
                        raise RuntimeError(f"exp_bandmm {name}: CUDA error {rc}")
                calls[f"E={e_build} {name}"] = call
        times = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                times[name].append(cuda_ms(calls[name]))
    readings = []
    for name, t in times.items():
        print(f"stages {name:40s} {min(t):8.4f}-{max(t):8.4f} ms", flush=True)
        readings.append({"case": f"stages {name}", "ms": t})
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", action="store_true",
                    help="also time K10 with steps of the block cut out")
    args = ap.parse_args(argv)
    dev = require_cuda()
    readings = run(dev)
    if args.stages:
        readings += run_stages(dev)
    smi = subprocess.run(SMI, capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
