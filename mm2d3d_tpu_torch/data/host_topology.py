"""Host-side (C++) sparse-topology construction
(port of `mm2d3d_tpu/data/host_topology.py`).

Builds the exact (VoxelGrid, Hierarchy) of `train.batch.build_topology` on
the CPU with hash maps (`mm2d3d_tpu_torch.native`), so the data loader can
build a batch's tables while the card runs the previous step: every table,
the sort fields of the grid included, equals the device path's
(tests/test_torch_host_topology.py).  `to_device` moves a topology onto the
card in two copies from pinned memory.

Unlike the JAX package's, `topology_for_batch` passes the slot profile on,
so a KITTI-family config (`train.slot_profile: dense`) gets the dense
plan's capacities and slot tables here too.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..ops.hierarchy import GridLevel, Hierarchy, LevelTransition, child_slot_spec
from ..ops.kernels.propagate import MISS_TAP
from ..ops.voxelize import VoxelGrid
from ..train.batch import PointBatch, default_capacities, default_slot_caps

_INVALID = np.iinfo(np.int32).max


def _part1by2(v):
    v = v.astype(np.uint32) & np.uint32(0x3FF)
    v = (v ^ (v << 16)) & np.uint32(0xFF0000FF)
    v = (v ^ (v << 8)) & np.uint32(0x0300F00F)
    v = (v ^ (v << 4)) & np.uint32(0x030C30C3)
    v = (v ^ (v << 2)) & np.uint32(0x09249249)
    return v


def _keys_for(coords, batch, valid):
    """(batch, morton) pair keys, INVALID where not `valid`: numpy mirror of
    `ops.keys.pack` + `mask_invalid`."""
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    lo = _part1by2(z) | (_part1by2(y) << 1) | (_part1by2(x) << 2)
    hi6 = _part1by2(z >> 10) | (_part1by2(y >> 10) << 1) | (_part1by2(x >> 10) << 2)
    hi = (batch.astype(np.uint32) << 6) | hi6
    hi = np.where(valid, hi.view(np.int32), _INVALID).astype(np.int32)
    lo = np.where(valid, lo.view(np.int32), _INVALID).astype(np.int32)
    return hi, lo


def _sort_fields(coords, bidx, valid, full_scale, p2v, presorted):
    """The grid's sort fields as `ops.voxelize.voxelize` makes them:
    sort_perm (the stable sort of the (hi, lo) keys, None when presorted),
    seg_sorted (each point's row in sorted order; an invalid point takes
    the row before it, a point past the capacity the dump row) and
    valid_sorted."""
    in_range = ((coords >= 0) & (coords < full_scale)).all(1)
    ok = valid & in_range
    perm = None
    if not presorted:
        hi, lo = _keys_for(coords, bidx, ok)
        key = (hi.astype(np.int64) << 32) + (lo.astype(np.int64) + (1 << 31))
        perm = np.argsort(key, kind="stable").astype(np.int32)
        p2v, ok = p2v[perm], ok[perm]
    seg = np.maximum.accumulate(np.where(ok, p2v, 0))
    return perm, seg.astype(np.int32), ok


def _build_slots_np(nbr: np.ndarray, num_slots: int):
    """The 1-tier slot form (numpy mirror of `ops.hierarchy`'s, same slot
    order) -> (src, tap, dropped)."""
    k, v = nbr.shape
    hit = nbr < v
    hit[13] = False  # the centre tap is not a slot
    order = np.argsort(~hit, axis=0, kind="stable")[:num_slots]  # (H, V)
    cols = np.arange(v)[None, :]
    taken = hit[order, cols]
    src = np.where(taken, nbr[order, cols], v).astype(np.int32)
    tap = np.where(taken, order, MISS_TAP).astype(np.int32)
    dropped = np.int32(np.maximum(hit.sum(0) - num_slots, 0).sum())
    return src, tap, dropped


def _build_child_slots_np(child: np.ndarray, vf: int, h_lo: int, vh_cap: int):
    """Numpy mirror of `ops.hierarchy.build_child_slots`."""
    vc = child.shape[0]
    hit = child < vf  # (Vc, 8)
    cnt = hit.sum(1)
    order = np.argsort(~hit, axis=1, kind="stable")  # octants, hits first
    rows = np.arange(vc)[:, None]
    taken = hit[rows, order]
    src_full = np.where(taken, child[rows, order], vf).astype(np.int32).T
    tap_full = np.where(taken, order, 8).astype(np.int32).T  # (8, Vc)
    heavy_rows = np.nonzero(cnt > h_lo)[0]
    take = heavy_rows[:vh_cap]
    idx = np.full(vh_cap, vc, np.int32)
    idx[: len(take)] = take
    src2 = np.full((8 - h_lo, vh_cap), vf, np.int32)
    tap2 = np.full((8 - h_lo, vh_cap), 8, np.int32)
    src2[:, : len(take)] = src_full[h_lo:, take]
    tap2[:, : len(take)] = tap_full[h_lo:, take]
    dropped = np.int32((cnt[heavy_rows[vh_cap:]] - h_lo).sum())
    return src_full[:h_lo], tap_full[:h_lo], idx, src2, tap2, dropped


def _slots_for(spec, nbr: np.ndarray, cap: int) -> dict:
    """A level's slot tables for its spec (every form `build_hierarchy`
    takes), from its (27, V) table."""
    if not spec:
        return {}
    if not isinstance(spec, tuple):
        src, tap, dropped = _build_slots_np(nbr, spec)
        return dict(slot_src=src, slot_tap=tap, slot_overflow=dropped)
    nbr_rows = np.ascontiguousarray(nbr.T)  # the C++ code takes voxel rows
    if len(spec) == 5:
        h1, h2, h_max, vm_cap, vh_cap = spec
        (s1, t1, im, invm, sm, tm, ih, sh, th, dropped) = native.build_slots_tiered(
            nbr_rows, h1, h2, h_max, min(vm_cap, cap), min(vh_cap, cap))
        return dict(slot_src=s1, slot_tap=t1, slot_overflow=dropped,
                    slot_idxm=im, slot_invm=invm, slot_srcm=sm, slot_tapm=tm,
                    slot_idx=ih, slot_src2=sh, slot_tap2=th)
    h_lo, h_max, vh_cap = spec
    # the 2-tier form: the tiered build with h2 == h_max and no far tier
    (s1, t1, idx, _, s2, t2, _, _, _, dropped) = native.build_slots_tiered(
        nbr_rows, h_lo, h_max, h_max, min(vh_cap, cap), 0)
    return dict(slot_src=s1, slot_tap=t1, slot_overflow=dropped, slot_idx=idx,
                slot_src2=s2, slot_tap2=t2)


def _tensors(cls, **fields):
    """`cls(**fields)` with every numpy array or scalar as a CPU tensor."""
    return cls(**{k: torch.from_numpy(np.asarray(v)) if isinstance(
        v, (np.ndarray, np.generic)) else v for k, v in fields.items()})


def build_topology_host(
    coords: np.ndarray,  # (P, 3) int
    bidx: np.ndarray,  # (P,) int
    valid: np.ndarray,  # (P,) bool
    full_scale: int,
    num_levels: int,
    capacities: Optional[Sequence[int]] = None,
    batch_size: Optional[int] = None,
    slot_caps="default",
    slot_profile: str = "default",
    child_slot_caps=None,
    presorted: bool = False,
) -> Tuple[VoxelGrid, Hierarchy]:
    """The (VoxelGrid, Hierarchy) of `train.batch.build_topology`, as CPU
    tensors: `capacities`, `slot_caps`, `slot_profile` and `child_slot_caps`
    as there; `presorted` is the batch's `coords_sorted` (no sort_perm)."""
    coords = np.ascontiguousarray(coords, np.int32)
    bidx = np.ascontiguousarray(bidx, np.int32)
    valid = np.asarray(valid, bool)
    if capacities is None:
        capacities = default_capacities(len(coords), num_levels,
                                        batch_size=batch_size, profile=slot_profile)
    if isinstance(slot_caps, str):
        if slot_caps != "default":
            raise ValueError(f"unknown slot caps {slot_caps!r}")
        slot_caps = default_slot_caps(num_levels, tuple(capacities), slot_profile)

    def spec_at(l):
        return slot_caps[l] if slot_caps is not None and l < len(slot_caps) else None

    cap = capacities[0]
    vc, vb, p2v, counts, nvox = native.voxelize_dedup(coords, bidx, valid,
                                                      full_scale, cap)
    rv = np.arange(cap) < nvox
    hi, lo = _keys_for(vc, vb, rv)
    perm, seg, ok = _sort_fields(coords, bidx, valid, full_scale, p2v, presorted)
    grid = _tensors(VoxelGrid, key_hi=hi, key_lo=lo, coords=vc, batch=vb, valid=rv,
                    num_voxels=np.int32(nvox), p2v=p2v, counts=counts,
                    full_scale=full_scale, sort_perm=perm, seg_sorted=seg,
                    valid_sorted=ok)

    levels: List[GridLevel] = []
    transitions: List[LevelTransition] = []
    fs = full_scale
    for l in range(num_levels):
        if l > 0:
            cap_f, nvox_f, vc_f, vb_f = cap, nvox, vc, vb
            cap, fs = capacities[l], fs // 2
            vc, vb, _, _, nvox = native.voxelize_dedup(
                vc_f >> 1, vb_f, np.arange(cap_f) < nvox_f, fs, cap)
            parent, off_id, child = native.build_transition(
                vc_f, vb_f, nvox_f, cap_f, vc, vb, nvox, cap, fs)
            cslots = {}
            spec = child_slot_spec(child_slot_caps, l - 1, cap)
            if spec is not None:
                h_lo, vh_cap = spec
                cslots = dict(zip(
                    ("cslot_src", "cslot_tap", "cslot_idx", "cslot_src2",
                     "cslot_tap2", "cslot_overflow"),
                    _build_child_slots_np(child, cap_f, h_lo, min(vh_cap, cap))))
            transitions.append(_tensors(LevelTransition, parent=parent,
                                        off_id=off_id, child=child, **cslots))
            rv = np.arange(cap) < nvox
            hi, lo = _keys_for(vc, vb, rv)
        nbr = np.ascontiguousarray(native.build_nbr27(vc, vb, nvox, cap, fs).T)
        levels.append(_tensors(
            GridLevel, key_hi=hi, key_lo=lo, coords=vc, batch=vb, valid=rv,
            num_voxels=np.int32(nvox), nbr=nbr, full_scale=fs,
            **_slots_for(spec_at(l), nbr, cap)))
    return grid, Hierarchy(levels=tuple(levels), transitions=tuple(transitions))


def topology_for_batch(batch: PointBatch, full_scale: int, num_levels: int,
                       capacities: Optional[Sequence[int]] = None,
                       slot_profile: str = "default", child_slot_caps=None):
    """`build_topology_host` of a CPU `PointBatch` (a loader's), under the
    task's slot profile."""
    b, n = batch.coords.shape[:2]
    return build_topology_host(
        batch.coords.reshape(b * n, 3).numpy(),
        np.repeat(np.arange(b, dtype=np.int32), n),
        batch.point_mask.reshape(b * n).numpy(), full_scale, num_levels,
        capacities=capacities, batch_size=b, slot_profile=slot_profile,
        child_slot_caps=child_slot_caps, presorted=batch.coords_sorted)


def _fields(topo):
    """(object, field name, tensor) of every table of a topology."""
    grid, hier = topo
    for obj in (grid, *hier.levels, *hier.transitions):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor):
                yield obj, f.name, t


def to_device(topo, device):
    """A CPU topology on `device`: its int32 tables packed into one pinned
    buffer and its boolean ones into another, each copied with one
    non-blocking copy, then viewed back into the tables."""
    device = torch.device(device)
    if device.type == "cpu":
        return topo
    fields = list(_fields(topo))
    out = {}
    for dtype in (torch.int32, torch.bool):
        part = [(o, name, t) for o, name, t in fields if t.dtype == dtype]
        if not part:
            continue
        sizes = [t.numel() for _, _, t in part]
        buf = torch.empty(sum(sizes), dtype=dtype, pin_memory=True)
        torch.cat([t.reshape(-1) for _, _, t in part], out=buf)
        dev = buf.to(device, non_blocking=True)
        for (o, name, t), piece in zip(part, dev.split(sizes)):
            out[id(o), name] = piece.view(t.shape)
    if len(out) != len(fields):
        raise TypeError("a topology table is neither int32 nor bool")

    def moved(o):
        return dataclasses.replace(o, **{
            f.name: out[id(o), f.name] for f in dataclasses.fields(o)
            if (id(o), f.name) in out})

    grid, hier = topo
    return moved(grid), Hierarchy(levels=tuple(map(moved, hier.levels)),
                                  transitions=tuple(map(moved, hier.transitions)))
