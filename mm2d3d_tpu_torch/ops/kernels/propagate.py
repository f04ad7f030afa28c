"""K3: fused octree neighbour propagation + tier-1 slot build.

Port of `mm2d3d_tpu/ops/pallas/propagate.py`.  After the gathers of
`ops.hierarchy._propagate_candidates`, each fine voxel picks each of its 26
off-centre neighbours from 8 x 8 gathered child-table candidates by its
coordinate parity, writes the dense table, the first `h1` hits as tier-1
slots in ascending-tap order, and counts every hit.  CUDA kernel:
`mm2d3d_tpu_torch/csrc/propagate.cu`; plain version: `propagate_slots_ref`.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Optional

import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)

CENTER = 13
MISS_TAP = 27
_OFFSETS = list(itertools.product((-1, 0, 1), repeat=3))  # = OFFSETS_27


def _bind(lib):
    lib.propagate_slots.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.propagate_slots.restype = ctypes.c_int


KERNEL = register(Kernel(
    "propagate", ("propagate.cu", "common.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/pallas/propagate.py:59",
))


def _axis_sel(d: int, p: torch.Tensor):
    """Per-axis (parent-block index a, child slot s) for tap offset d and
    parity p (0/1 tensor) — hierarchy._axis_sel, vectorized over voxels."""
    a = p.new_zeros(()) if d == -1 else (p.new_ones(()) if d == 1 else 1 - p)
    s = p if d == 0 else 1 - p
    return a, s


@functools.lru_cache(maxsize=None)
def _tap_ids(device: torch.device) -> torch.Tensor:
    """(26,) the off-centre tap ids, copied to `device` once: a copy on
    every call would make the host wait for the device."""
    return torch.tensor([k for k in range(27) if k != CENTER],
                        dtype=torch.int32, device=device)


def rank_slots(nbr_k: torch.Tensor, miss: int, num_slots: int, rank0: int,
               tap_ids: Optional[torch.Tensor] = None, miss_tap: int = MISS_TAP):
    """Pack each column's hits of the (26, V) off-centre table into slots
    rank0 .. rank0 + num_slots - 1, in ascending-tap order.

    Returns (src (H, V), tap (H, V), cnt (V,)); empty slots are (miss,
    `miss_tap`) and `cnt` counts all hits.  `tap_ids` (K,) names the rows'
    taps for another table (the (8, Vc) child table: its octants 0-7, with
    `miss_tap` 8); by default the rows are the 26 off-centre taps.

    Each hit's slot is its exclusive prefix count along the taps minus
    rank0; ONE scatter per table places every hit (ranks are unique within
    a column, and hits outside the slot window land on a dump row that is
    cut off), so the op count does not grow with the number of slots."""
    kk, v = nbr_k.shape
    if tap_ids is None:
        tap_ids = _tap_ids(nbr_k.device)
    k_ids = tap_ids[:, None].expand(kk, v)
    hit = nbr_k != miss
    hit_i = hit.to(torch.int32)
    cnt = hit_i.sum(0, dtype=torch.int32)
    slot = torch.cumsum(hit_i, 0, dtype=torch.int32) - hit_i - rank0
    slot = torch.where(hit & (slot >= 0) & (slot < num_slots), slot,
                       num_slots).long()
    src = nbr_k.new_full((num_slots + 1, v), miss).scatter_(0, slot, nbr_k)
    tap = nbr_k.new_full((num_slots + 1, v), miss_tap).scatter_(0, slot, k_ids)
    return src[:num_slots], tap[:num_slots], cnt


def propagate_slots_ref(crows: torch.Tensor, par: torch.Tensor,
                        valid: torch.Tensor, h1: int):
    """Plain PyTorch version of the kernel: the parity select, then the
    ascending-tap ranking of `rank_slots`."""
    v = crows.shape[2]
    flat = crows.reshape(64, v)
    px, py, pz = par[0], par[1], par[2]
    rows = torch.arange(v, dtype=torch.int32, device=crows.device)
    cols = []
    for k, (dx, dy, dz) in enumerate(_OFFSETS):
        if k == CENTER:
            cols.append(torch.where(valid[0] != 0, rows, v))
            continue
        ax, sx = _axis_sel(dx, px)
        ay, sy = _axis_sel(dy, py)
        az, sz = _axis_sel(dz, pz)
        idx = (ax * 4 + ay * 2 + az) * 8 + (sx * 4 + sy * 2 + sz)
        cols.append(flat.gather(0, idx.to(torch.int64)[None])[0])
    nbr = torch.stack(cols).to(torch.int32)
    nbr_off = torch.cat([nbr[:CENTER], nbr[CENTER + 1:]])
    src1, tap1, cnt = rank_slots(nbr_off, v, h1, 0)
    return nbr, src1, tap1, cnt


def propagate_slots(crows: torch.Tensor, par: torch.Tensor,
                    valid: torch.Tensor, h1: int):
    """crows (8, 8, V), par (3, V), valid (1, V) int32 ->
    (nbr (27, V), src1 (h1, V), tap1 (h1, V), cnt (V,)) int32.

    Misses are V (sources) and 27 (taps); bit-identical to
    `propagate_slots_ref`."""
    v = crows.shape[-1]
    if crows.shape != (8, 8, v) or par.shape != (3, v) or valid.shape != (1, v):
        raise ValueError(
            f"bad shapes crows {tuple(crows.shape)}, par {tuple(par.shape)}, "
            f"valid {tuple(valid.shape)}"
        )
    for name, t in (("crows", crows), ("par", par), ("valid", valid)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not 0 <= h1 <= 26:
        raise ValueError(f"h1 must be in [0, 26], got {h1}")
    no_grad_inputs(crows, par, valid)
    if not on_cuda(crows, par, valid):
        return propagate_slots_ref(crows, par, valid, h1)

    require_contiguous(crows=crows, par=par, valid=valid)
    dev = crows.device
    nbr = torch.empty((27, v), dtype=torch.int32, device=dev)
    src1 = torch.empty((h1, v), dtype=torch.int32, device=dev)
    tap1 = torch.empty((h1, v), dtype=torch.int32, device=dev)
    cnt = torch.empty((v,), dtype=torch.int32, device=dev)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.propagate_slots(
        ptr(crows), ptr(par), ptr(valid), ptr(nbr), ptr(src1), ptr(tap1),
        ptr(cnt), v, h1, stream(),
    ))
    return nbr, src1, tap1, cnt
