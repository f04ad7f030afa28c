"""K6's tensor-core tile, measured: the bf16 dense contraction at the
flagship's shapes under several (voxels per block, reduction elements per
stage, ring depth) tiles, on one NVIDIA GPU.

    python -m mm2d3d_tpu_torch.tools.tapsum_tiles

Each variant is `csrc/tapsum.cu` with the 64-voxel branch of its launcher
built for another tile (nvcc into a temporary directory; the source in the
package is not touched), called through the same C interface with the
split plan recomputed for its tile.  Every variant is held to the plain
version (1e-4 * max|plain|), then timed by CUDA events in turns (the list,
then the list reversed), and the two readings are printed as min/max.  The
gathered rows come from a batch-8 flagship topology without slot tables,
as in `chip_smoke.py` phase 3.  `tapsum_plan` picks the tile these numbers
favour; rerun this after a change to the kernel.  Refuses to run without a
CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..data.synthetic import make_batch
from ..ops.kernels import CSRC_DIR, NVCC_FLAGS, _nvcc, stream
from ..ops.kernels.tapsum import SMS, tapsum_plan, tapsum_ref
from ..train.batch import build_topology

# (voxels per block, reduction elements per stage, ring depth)
TILES = ((64, 64, 4), (64, 64, 6), (64, 128, 4), (128, 64, 4), (64, 32, 8),
         (128, 32, 6), (128, 128, 3))
# (name, level, Ci, Co) at the flagship's levels
SHAPES = (("enc L0", 0, 16, 16), ("dec L0 concat", 0, 32, 16),
          ("enc L2", 2, 48, 48), ("enc L3", 3, 64, 64),
          ("dec L3 concat", 3, 128, 64), ("dec L5 concat", 5, 192, 96),
          ("enc L6", 6, 112, 112), ("dec L5 concat adjoint", 5, 96, 192))
BRANCH = "launch_tc_bn<64, 64, 4>"


def build(tile, tmp: str) -> ctypes.CDLL:
    src = open(os.path.join(CSRC_DIR, "tapsum.cu")).read()
    if BRANCH not in src:
        raise RuntimeError(f"{BRANCH} not found in tapsum.cu")
    src = src.replace(BRANCH, "launch_tc_bn<{}, {}, {}>".format(*tile))
    name = "tapsum_{}_{}_{}".format(*tile)
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    out = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tile}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(out)
    lib.tapsum.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def splits_for(bm: int, v: int, bn: int, co: int) -> int:
    blocks = -(-v // bm) * -(-co // bn)
    return min(27, -(-SMS // blocks)) if blocks < SMS else 1


def device_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("tapsum_tiles: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(TILES)) as pool:
            libs = dict(zip(TILES, pool.map(lambda t: build(t, tmp), TILES)))
        batch = make_batch(np.random.RandomState(0), batch_size=8, height=225,
                           width=400, n_points=8192).to(dev)
        with torch.no_grad():
            _, hier = build_topology(batch, 4096, 7, slot_caps=None)
        gen = torch.Generator(device=dev).manual_seed(6)
        for name, level, ci, co in SHAPES:
            lev = hier.levels[level]
            x = torch.randn((lev.capacity, ci), generator=gen, device=dev)
            g = torch.cat([x, x.new_zeros((1, ci))])[lev.nbr.long()].bfloat16()
            w = (0.1 * torch.randn((27, ci, co), generator=gen, device=dev)).bfloat16()
            ref = tapsum_ref(g, w)
            v = g.shape[1]
            bn = tapsum_plan(27, v, ci, co).bn
            times = {t: [] for t in TILES}
            for tile in TILES + TILES[::-1]:
                lib, s = libs[tile], splits_for(tile[0], v, bn, co)
                out = torch.empty((v, co), device=dev)
                scratch = torch.empty((s, v, co), device=dev)

                def call():
                    rc = lib.tapsum(g.data_ptr(), w.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), 27, v, ci, co, 1, s, 64,
                                    bn, stream())
                    if rc:
                        raise RuntimeError(f"tile {tile}: launch failed ({rc})")

                call()
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                if not err <= 1e-4 * float(ref.abs().max()):
                    raise AssertionError(f"{name} tile {tile}: max|d| {err}")
                times[tile].append(device_ms(call))
            print(f"{name} V={v} Ci={ci} Co={co}: " + "; ".join(
                "BM{} BK{} x{} {:.4f}/{:.4f} ms".format(*t, min(m), max(m))
                for t, m in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
