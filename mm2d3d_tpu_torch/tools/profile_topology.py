"""Where the topology build's time goes, phase by phase, on one NVIDIA GPU
(port of `tools/profile_topology.py`).

    python -m mm2d3d_tpu_torch.tools.profile_topology

The flagship's batch (`data.synthetic.make_batch` from seed 0: batch 8,
225x400, 8192 points, full_scale 4096), 7 levels, `default_capacities` and
`default_slot_caps`, through four cumulative phases under the JAX tool's
names:

    voxelize only                  `ops.voxelize.voxelize` (presorted)
    + coarsen chain (6 levels)     and `ops.hierarchy._coarsen_grid` x6
    + nbr (dense coarsest + K3)    and `build_nbr` on the coarsest grid, then
                                   `propagate_nbr_slots(..., h1=0)` at
                                   levels 5..0 (K3 x6, the port's form of
                                   the JAX `propagate_nbr`)
    full (+ slot tables)           voxelize and `build_hierarchy`, as
                                   `train.batch.build_topology` calls them

For each phase, per call: the host ms until the calls return and the wall
ms until the device is done (host clock, `ITERS` calls, all taken before
the profiler first runs), the device's busy ms (the union of kernel
intervals in a `torch.profiler` trace of `PROFILED` calls), the device
kernels, the host syncs
(CUDA sync debug mode) and the launches of the port's kernels (K3: 0, 0, 6,
6); these are `tools/profile_forward.py`'s stage numbers.  Then the JAX
tool's difference line (wall ms), the same for host and device ms, and one
JSON line.  Refuses to run without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..data.synthetic import make_batch
from ..ops import hierarchy as H
from ..ops import kernels
from ..ops.voxelize import voxelize
from ..train.batch import default_capacities, default_slot_caps, flatten_points
from .autotune import sync
from .profile_forward import report

ITERS = 10
PROFILED = 2  # calls per phase under the profiler, whose trace is slow to read
BATCH = 8
NUM_LEVELS = 7
SCAN = dict(height=225, width=400, n_points=8192, num_classes=6, full_scale=4096)
PHASES = ("voxelize only", "+ coarsen chain (6 levels)",
          "+ nbr (dense coarsest + K3)", "full (+ slot tables)")
SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def flagship_batch(device, batch_size: int = BATCH, **scan):
    """The JAX tool's batch, on `device`."""
    return make_batch(np.random.RandomState(0), batch_size=batch_size,
                      **{**SCAN, **scan}).to(device)


def phases(batch, num_levels: int = NUM_LEVELS) -> dict:
    """The four cumulative phases over `batch`: {name: fn}, each fn taking
    no argument and returning what it built: the grid; (grids,
    transitions); (grids, transitions, neighbour tables); (grid,
    hierarchy)."""
    full_scale = SCAN["full_scale"]
    nb = batch.batch_size
    coords, _, _, mask, bidx = flatten_points(batch)
    caps = default_capacities(coords.shape[0], num_levels, batch_size=nb)
    slot_caps = default_slot_caps(num_levels, caps)

    def vox():
        return voxelize(coords, bidx, mask, full_scale, capacity=caps[0],
                        presorted=batch.coords_sorted)

    def grids_only():
        grids, transitions = [vox()], []
        for l in range(1, num_levels):
            grid_c, trans = H._coarsen_grid(grids[-1], capacity=caps[l])
            grids.append(grid_c)
            transitions.append(trans)
        return grids, transitions

    def with_nbr():
        grids, transitions = grids_only()
        nbrs = [None] * num_levels
        nbrs[-1] = H.build_nbr(grids[-1], num_batches=nb)
        for l in range(num_levels - 2, -1, -1):
            nbrs[l] = H.propagate_nbr_slots(grids[l], transitions[l], nbrs[l + 1],
                                            h1=0)[0]
        return grids, transitions, nbrs

    def full():
        grid = vox()
        return grid, H.build_hierarchy(grid, num_levels, caps, slot_caps,
                                       num_batches=nb)

    return dict(zip(PHASES, (vox, grids_only, with_nbr, full)))


def launches(fn, device) -> dict:
    """The port's kernel launches of one call of fn (launch counters read
    before and after; the counters are not reset)."""
    before = kernels.counts()
    fn()
    sync(device)
    return {k: n - before[k] for k, n in kernels.counts().items()}


def run(device) -> dict:
    """Every phase's numbers per call, the differences between consecutive
    phases and the per-phase launches, all at the flagship batch."""
    batch = flagship_batch(device)
    fns = phases(batch)
    with torch.no_grad():
        table = report(fns, ITERS, PROFILED)
        for name, fn in fns.items():
            table[name]["launches"] = launches(fn, device)
    for name in PHASES:
        t = table[name]
        print(f"{name:44s} host {t['host_ms']:8.2f} ms  wall {t['wall_ms']:8.2f} ms  "
              f"device {t['device_busy_ms']:7.3f} ms  {t['kernels']:6.0f} kernels  "
              f"K3 x{t['launches']['propagate']}", flush=True)
    diffs = {}
    for key in ("wall_ms", "host_ms", "device_busy_ms"):
        v = [table[name][key] for name in PHASES]
        diffs[key] = {"coarsen": v[1] - v[0], "nbr": v[2] - v[1], "slots": v[3] - v[2]}
    print("coarsen: {coarsen:.2f}  nbr: {nbr:.2f}  slots: {slots:.2f}".format(
        **diffs["wall_ms"]))
    for key in ("host_ms", "device_busy_ms"):
        print(f"{key}: " + "  ".join(f"{k}: {v:.2f}" for k, v in diffs[key].items()))
    return {"phases": table, "differences": diffs}


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_topology times the card: no CUDA device")
    smi = subprocess.run(SMI, capture_output=True, text=True).stdout.strip()
    print(smi)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi,
           **run(torch.device("cuda", 0))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
