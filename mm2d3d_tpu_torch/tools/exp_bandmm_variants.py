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

  - the E build: `full` multiplies all 27 bands (K1's route today) or
    `compact` only the bands some voxel of a warp's 16 hits (ROADMAP
    Queue 2, skipping empty bands);
  - voxels per tile of the persistent grid's ring: 64 or 128.

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
`csrc/exp_bandmm.cu` with steps of the kernel cut out (no product; no
fragment build; no stores; no bands and no stores: the ring, the staging
of the sources and the out tile alone), or with the probe shape's own
instantiation (K = 27, Ci = Co = 16 fixed, the band loop unrolled) turned
off, so that the general one (any shape, a loop over the set bands) runs
the same case; each is built by nvcc into a temporary directory (the
package's source is untouched) and timed on the real-table taps beside the
whole kernel.  A cut variant's output is wrong by design and is not
checked; the general variant computes the same function.
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

import torch

from ..ops.kernels import CSRC_DIR, NVCC_FLAGS, _nvcc, ptr, stream
from ..ops.kernels.exp_bandmm import (
    E_BUILDS, VOXELS_PER_BLOCK, band_apply, band_apply_ref, band_plan,
)
from .exp_dma_gather import SMI, require_cuda
from .kernel_cases import BAND_CASE, band_inputs, cuda_ms

V, H, CI, CO, K = BAND_CASE  # the TPU probe's sizes
REL_TOL = 1e-4  # max|kernel - plain| <= REL_TOL * max|plain| (fp32 sums in another order)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


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
        xm, x, tap, w = band_inputs(dev, taps=taps)
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


# the kernel's steps that `--stages` cuts out: (text in csrc/exp_bandmm.cu,
# its replacement).  Without the build (the row selection and its
# ldmatrix), band k's operand is a register expression; without the
# product, the operands are folded into the sums by integer ops (`fold`),
# so the build is not optimised away; without the bands, no band is built
# or multiplied (W's fragments are not read either); without the stores,
# no tile is written (a test that never holds guards them); without the
# probe instantiation, the probe's shape takes the general one.
CUTS = {
    "fragment build": (
        "if (slow) sum_band<kSlots>(a, tv, slot, cen, zero, k, is_c); "
        "else pick_band<kSlots>(a, tv, slot, cen, zero, k, is_c);",
        "for (int i = 0; i < 4; ++i) a[i] = slot[0] + k;"),
    "product": ("  mma_bf16(acc[0], a, b[0], b[1]);\n  mma_bf16(acc[1], a, b[2], b[3]);",
                "  fold(acc, a, b);"),
    "bands": ("const unsigned bands = kCompact ? warp_hits : all_bands;",
              "const unsigned bands = 0u;"),
    "stores": ("if (q < n) *reinterpret_cast<float4*>",
               "if (q < n && o[co * kOutRow + q] == 3.0e38f) *reinterpret_cast<float4*>"),
    "probe instantiation": ("if (H <= 3 && K == 27 && Ci == 16 && Co == 16) {",
                            "if (false) {"),
}
STAGE_VARIANTS = {"no product": ("product",), "no fragment build": ("fragment build",),
                  "no stores": ("stores",),
                  "ring and staging only": ("bands", "stores"),
                  "general path": ("probe instantiation",)}


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
    lib.exp_bandmm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.exp_bandmm.restype = ctypes.c_int
    return lib


def run_stages(dev) -> list:
    """The whole kernel and each cut variant on the real-table taps, full and
    compact E, 64 voxels a block, timed in turns (the list, then reversed)."""
    xm, x, tap, w = band_inputs(dev)
    h, ci, v = x.shape
    co, k = w.shape[0], w.shape[1] // ci
    blocks = band_plan(v, h, ci, co, k, 64)["blocks"]
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
                                        ci, co, k, int(eb == "compact"), 64, blocks,
                                        stream())
                    if rc:
                        raise RuntimeError(f"exp_bandmm {name}: CUDA error {rc}")
                calls[f"E={e_build} {name}"] = call
        # the general instantiation computes the same function: hold it to
        # the plain version before it is timed
        ref = band_apply_ref(xm, x, tap, w)
        for e_build in E_BUILDS:
            calls[f"E={e_build} general path"]()
            err = float((out - ref).abs().max())
            if not err <= REL_TOL * float(ref.abs().max()):
                raise AssertionError(f"K10 general path E={e_build}: max|d| {err}")
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
