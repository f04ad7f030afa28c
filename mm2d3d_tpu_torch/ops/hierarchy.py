"""Sparse-grid hierarchy: per-level voxel tables and static rulebooks.

Port of `mm2d3d_tpu/ops/hierarchy.py`: the voxel tables are coarsened
bottom-up, the coarsest level's 27-neighbour table comes from a dense
occupancy map where it is small enough and from a search of the sorted keys
otherwise (`build_nbr`), and every finer level's table and tier-1 slots
come from octree propagation through the K3 kernel (`ops.kernels.propagate`),
followed by the compacted overflow tiers of each level's slot spec (or no
slot tables, for the dense 27-tap path).  All tables are int32 and
bit-identical to the JAX package's.  A 5^3 stem convolution's 125-neighbour
table at level 0 (`build_nbr5`) is propagated from level 1's 27-neighbour
table; the JAX package has none.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import keys as K
from .kernels.propagate import propagate_slots, rank_slots
from .voxelize import VoxelGrid, dedup_sorted
from ..utils.profiling import span

OFFSETS_27 = np.array(
    list(itertools.product((-1, 0, 1), repeat=3)), dtype=np.int32
)  # (27, 3), lexicographic; index 13 is the centre
CENTER = 13
OFF_CENTER = [k for k in range(27) if k != CENTER]
OFFSETS_125 = np.array(
    list(itertools.product(range(-2, 3), repeat=3)), dtype=np.int32
)  # (125, 3), lexicographic; tap k pairs with 124 - k
CENTER_125 = 62


def _nbr5_tables():
    """Per parity class p = (x & 1) * 4 + (y & 1) * 2 + (z & 1) of a fine
    voxel and per 5^3 offset d: the coarse 3^3 tap of the parent that holds
    the neighbour at d, and the neighbour's octant in that parent's 2x2x2
    block -> two (125, 8) int64 tables.  Per axis the fine coordinate
    2c + r plus d in [-2, 2] lies in parent c + ((r + d) >> 1), offset
    -1..1, at bit (r + d) & 1."""
    par = np.array(list(itertools.product((0, 1), repeat=3)), np.int64)  # (8, 3)
    s = OFFSETS_125[:, None, :] + par[None]  # (125, 8, 3)
    a, o = (s >> 1) + 1, s & 1
    return (a[..., 0] * 9 + a[..., 1] * 3 + a[..., 2],
            o[..., 0] * 4 + o[..., 1] * 2 + o[..., 2])

# Dense-map neighbour lookup bound (fs^3 * batches int32 entries).
_DENSE_NBR_MAX_ENTRIES = 1 << 22

_CONSTANTS = {
    "offsets": OFFSETS_27[OFF_CENTER],  # (26, 3) off-centre tap offsets
    # (8,) the 2x2x2 parent-block corners (ax, ay, az) as indices
    # ax * 9 + ay * 3 + az of the 3x3x3 tap grid
    "corners": np.array([ax * 9 + ay * 3 + az for ax, ay, az
                         in itertools.product((0, 1), repeat=3)], np.int64),
    "octants": np.arange(8, dtype=np.int32),  # the child table's taps
}
_CONSTANTS["nbr5_taps"], _CONSTANTS["nbr5_octants"] = _nbr5_tables()


@functools.lru_cache(maxsize=None)
def _on_device(name: str, device: torch.device) -> torch.Tensor:
    """A table of `_CONSTANTS`, copied to `device` once: a copy on every
    call would make the host wait for the device."""
    return torch.as_tensor(_CONSTANTS[name], device=device)


class SlotTier(NamedTuple):
    """One tier of a slot plan, as the sparse convolutions apply it: K1
    over the rows `src` names at the taps `tap`, merged into the output by
    its row map.  Tier 1 covers every output row (`rows` None); a
    compacted tier's row j is output row `rows[j]`, added by a gather
    through the inverse map `inv` (the mid tier) or, where `inv` is None,
    by a scatter at `rows` (the heavy tier)."""

    src: torch.Tensor  # (H, Vt) int32 source rows
    tap: torch.Tensor  # (H, Vt) int32 taps
    rows: Optional[torch.Tensor] = None  # (Vt,) int32 output row of each tier row
    inv: Optional[torch.Tensor] = None  # (V,) int32 inverse of `rows`


@dataclass
class GridLevel:
    key_hi: torch.Tensor  # (V,) int32 sorted keys
    key_lo: torch.Tensor
    coords: torch.Tensor  # (V, 3) int32
    batch: torch.Tensor  # (V,) int32
    valid: torch.Tensor  # (V,) bool
    num_voxels: torch.Tensor  # () int32
    nbr: torch.Tensor  # (27, V) int32 in [0, V]; V = missing
    full_scale: int
    # tier 1: the first H off-centre hits of every voxel (source row, tap)
    slot_src: Optional[torch.Tensor] = None  # (H, V) int32; V = empty
    slot_tap: Optional[torch.Tensor] = None  # (H, V) int32; 27 = empty
    slot_overflow: Optional[torch.Tensor] = None  # () int32 dropped hits
    # heavy tier (compacted): voxels with more hits than the tiers before
    slot_idx: Optional[torch.Tensor] = None  # (Vh,) int32; V = pad
    slot_src2: Optional[torch.Tensor] = None  # (H2, Vh)
    slot_tap2: Optional[torch.Tensor] = None
    # mid tier of the 3-tier form (compacted, with its inverse map)
    slot_idxm: Optional[torch.Tensor] = None  # (Vm,) int32; V = pad
    slot_invm: Optional[torch.Tensor] = None  # (V,) int32 in [0, Vm]
    slot_srcm: Optional[torch.Tensor] = None  # (Hm, Vm)
    slot_tapm: Optional[torch.Tensor] = None
    # the 5^3 stem's 125-neighbour table (level 0 only, `build_nbr5`)
    nbr5: Optional[torch.Tensor] = None  # (125, V) int32 in [0, V]; V = missing

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]

    def slot_tiers(self) -> Tuple[SlotTier, ...]:
        """The level's slot plan in the order its tiers are applied and
        summed: () without slot tables, tier 1, then the mid tier of the
        3-tier form, then the heavy tier."""
        if self.slot_src is None:
            return ()
        tiers = [SlotTier(self.slot_src, self.slot_tap)]
        if self.slot_srcm is not None:
            tiers.append(SlotTier(self.slot_srcm, self.slot_tapm, self.slot_idxm,
                                  self.slot_invm))
        if self.slot_src2 is not None:
            tiers.append(SlotTier(self.slot_src2, self.slot_tap2, self.slot_idx))
        return tuple(tiers)


@dataclass
class LevelTransition:
    """Maps between a fine level (f) and the next coarser level (c)."""

    parent: torch.Tensor  # (Vf,) int32 in [0, Vc]; Vc = dump
    off_id: torch.Tensor  # (Vf,) int32 in [0, 8)
    child: torch.Tensor  # (Vc, 8) int32 in [0, Vf]; Vf = missing
    # the child table packed into slots (`build_child_slots`): the first
    # h_lo children of every parent, the rest of the few heavier parents in
    # a compacted table; the tap of a slot is the child's octant
    cslot_src: Optional[torch.Tensor] = None  # (h_lo, Vc) int32; Vf = empty
    cslot_tap: Optional[torch.Tensor] = None  # (h_lo, Vc) int32; 8 = empty
    cslot_idx: Optional[torch.Tensor] = None  # (Vh,) int32; Vc = pad
    cslot_src2: Optional[torch.Tensor] = None  # (8 - h_lo, Vh)
    cslot_tap2: Optional[torch.Tensor] = None
    cslot_overflow: Optional[torch.Tensor] = None  # () int32 dropped children

    def child_tiers(self) -> Tuple[SlotTier, ...]:
        """The child slots as a slot plan over the coarse rows (K = 8): ()
        without them, else tier 1 and the heavy tier."""
        if self.cslot_src is None:
            return ()
        return (SlotTier(self.cslot_src, self.cslot_tap),
                SlotTier(self.cslot_src2, self.cslot_tap2, self.cslot_idx))


@dataclass
class Hierarchy:
    levels: Tuple[GridLevel, ...]
    transitions: Tuple[LevelTransition, ...] = field(default_factory=tuple)


def build_nbr(grid: VoxelGrid, num_batches: Optional[int] = None) -> torch.Tensor:
    """27-neighbour table (27, V) of a (coarse) grid: 26 exact-match lookups
    and the centre column, as the JAX `build_nbr`.

    With `num_batches` given, fs <= 1024 and fs^3 * num_batches <=
    `_DENSE_NBR_MAX_ENTRIES`, one write of the valid rows builds a dense
    occupancy map and the 26 probes read it; otherwise each probe searches
    the sorted keys (`keys.lookup_pairs`).  Both give the same table."""
    v = grid.capacity
    fs = grid.full_scale
    dev = grid.coords.device
    rows = torch.arange(v, dtype=torch.int32, device=dev)
    offs = _on_device("offsets", dev)
    qc = grid.coords[None] + offs[:, None, :]  # (26, V, 3)
    ok = grid.valid[None] & (qc >= 0).all(-1) & (qc < fs).all(-1)
    q_batch = grid.batch.expand(26, v)

    if (num_batches is not None and fs <= 1024
            and fs ** 3 * num_batches <= _DENSE_NBR_MAX_ENTRIES):
        cell_count = fs ** 3 * num_batches
        _, own_lo = K.pack(grid.coords, grid.batch)
        base = grid.batch.to(torch.int64) * fs ** 3
        own_flat = torch.where(grid.valid, base + own_lo, cell_count)
        dense = torch.zeros(cell_count + 1, dtype=torch.int32, device=dev)
        dense[own_flat] = rows + 1
        _, q_lo = K.pack(qc, q_batch)
        q_flat = torch.where(ok, base[None] + q_lo, cell_count)
        hit = dense[q_flat] - 1  # -1 = missing
        # `ok` masks the result too: masked writes and queries share the
        # dump cell
        hit = torch.where(ok & (hit >= 0), hit, v).to(torch.int32)
    else:
        q_hi, q_lo = K.mask_invalid(*K.pack(qc, q_batch), ok)
        hit = K.lookup_pairs(grid.key_hi, grid.key_lo, q_hi, q_lo, missing=v)
    center = torch.where(grid.valid, rows, v).to(torch.int32)
    return torch.cat([hit[:CENTER], center[None], hit[CENTER:]])


def build_nbr5(fine: VoxelGrid, trans: LevelTransition,
               nbr_c: torch.Tensor) -> torch.Tensor:
    """125-neighbour table (125, Vf) of a fine level, in `OFFSETS_125` tap
    order, from the next coarser level's 27-neighbour table: the 27 parents
    of a voxel's 3^3 parent neighbourhood hold every fine voxel at offsets
    -2..2, so tap d of voxel v is the child, at the octant `_nbr5_tables`
    gives, of the parent's neighbour at the coarse tap it gives.  Missing
    parents and children, out-of-grid offsets and invalid rows give Vf;
    the centre is the row itself where valid, as in `build_nbr`.  Gathers
    only: no search, no kernel of its own."""
    vf = fine.capacity
    vc = nbr_c.shape[1]
    dev = fine.coords.device
    rel = (fine.coords & 1).long()
    par = rel[:, 0] * 4 + rel[:, 1] * 2 + rel[:, 2]  # (Vf,)
    taps = _on_device("nbr5_taps", dev)[:, par]  # (125, Vf)
    octants = _on_device("nbr5_octants", dev)[:, par]  # (125, Vf)
    nbr_c_pad = torch.cat([nbr_c, nbr_c.new_full((27, 1), vc)], 1)  # (27, Vc + 1)
    parents = nbr_c_pad[:, trans.parent.long()]  # (27, Vf); dumped -> vc
    coarse = parents.gather(0, taps).long()  # (125, Vf) in [0, Vc]
    child_pad = torch.cat([trans.child, trans.child.new_full((1, 8), vf)])
    nbr = child_pad.reshape(-1)[coarse * 8 + octants]
    rows = torch.arange(vf, dtype=torch.int32, device=dev)
    nbr[CENTER_125] = torch.where(fine.valid, rows, vf)
    return nbr


def _compact_indices(mask: torch.Tensor, cap: int, fill: int):
    """First `cap` indices where `mask`, in order (`fill` pads), and the
    inverse map (row -> its compacted position, or `cap`)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    inv = torch.where(mask & (pos < cap), pos, cap).to(torch.int32)
    idx = torch.full((cap + 1,), fill, dtype=torch.int32, device=mask.device)
    idx[inv.long()] = torch.arange(n, dtype=torch.int32, device=mask.device)
    return idx[:cap], inv


def _off_center(nbr: torch.Tensor) -> torch.Tensor:
    return torch.cat([nbr[:CENTER], nbr[CENTER + 1:]])


def _rank_slots_compacted(nbr_off, cnt, v, h_from, h_to, cap):
    """Slots [h_from, h_to) for the voxels with more than h_from hits,
    compacted to `cap` rows -> (idx, inv, src, tap, n_uncompacted)."""
    heavy = cnt > h_from
    idx, inv = _compact_indices(heavy, cap, v)
    nbr_rows = torch.cat([nbr_off.T, nbr_off.new_full((1, nbr_off.shape[0]), v)])
    nbr_hi = nbr_rows[idx.long()].T
    src, tap, _ = rank_slots(nbr_hi, v, h_to - h_from, h_from)
    over = heavy & (torch.cumsum(heavy.to(torch.int32), 0, dtype=torch.int32) > cap)
    uncompacted = torch.where(over, torch.clamp(cnt, max=h_to) - h_from, 0)
    return idx, inv, src, tap, uncompacted.sum(dtype=torch.int32)


def _over_tail(cnt: torch.Tensor, h_max: int) -> torch.Tensor:
    return torch.clamp(cnt - h_max, min=0).sum(dtype=torch.int32)


def finish_slots_tiered(nbr, cnt, h1, h2, h_max, vm_cap, vh_cap):
    """The mid and heavy tiers of the 3-tier form, given the dense table and
    hit count -> (idxm, invm, srcm, tapm, idxh, srch, taph, dropped)."""
    v = nbr.shape[1]
    nbr_off = _off_center(nbr)
    idxm, invm, srcm, tapm, un_m = _rank_slots_compacted(
        nbr_off, cnt, v, h1, h2, vm_cap)
    idxh, _, srch, taph, un_h = _rank_slots_compacted(
        nbr_off, cnt, v, h2, h_max, vh_cap)
    dropped = _over_tail(cnt, h_max) + un_m + un_h
    return idxm, invm, srcm, tapm, idxh, srch, taph, dropped


def finish_slots_split(nbr, cnt, h_lo, h_max, vh_cap):
    """The heavy tier of the 2-tier form -> (idx, src2, tap2, dropped)."""
    v = nbr.shape[1]
    idx, _, src2, tap2, un = _rank_slots_compacted(
        _off_center(nbr), cnt, v, h_lo, h_max, vh_cap)
    return idx, src2, tap2, _over_tail(cnt, h_max) + un


def build_child_slots(child: torch.Tensor, vf: int, h_lo: int, vh_cap: int):
    """The (Vc, 8) child table packed into slots, as the JAX
    `build_child_slots`: tier 1 holds the first `h_lo` present children of
    every parent (tap = octant, in octant order), the heavy tier the rest
    for the first `vh_cap` parents with more.  A parent has at most 8
    children, so only the heavy tier's capacity can drop one (counted).
    -> (src1 (h_lo, Vc), tap1, idx (vh_cap,), src2 (8 - h_lo, vh_cap),
    tap2, dropped () int32)."""
    vc = child.shape[0]
    octants = _on_device("octants", child.device)
    src1, tap1, cnt = rank_slots(child.T, vf, h_lo, 0, octants, 8)
    heavy = cnt > h_lo
    idx, _ = _compact_indices(heavy, vh_cap, vc)
    child_pad = torch.cat([child, child.new_full((1, 8), vf)])
    src2, tap2, _ = rank_slots(child_pad[idx.long()].T, vf, 8 - h_lo, h_lo,
                               octants, 8)
    over = heavy & (torch.cumsum(heavy.to(torch.int32), 0, dtype=torch.int32)
                    > vh_cap)
    dropped = torch.where(over, cnt - h_lo, 0).sum(dtype=torch.int32)
    return src1, tap1, idx, src2, tap2, dropped


def child_slot_spec(child_slot_caps, l: int, vc: int):
    """Transition l's (h_lo, vh_cap), or None: `"default"` is (3, max(256,
    Vc / 4)) at every transition (JAX's default), a sequence gives one spec
    (or None) per transition."""
    if child_slot_caps is None:
        return None
    if isinstance(child_slot_caps, str):
        if child_slot_caps != "default":
            raise ValueError(f"unknown child slot caps {child_slot_caps!r}")
        return 3, max(256, vc // 4)
    return child_slot_caps[l]


def _tier1(nbr: torch.Tensor, h1: int):
    """Tier-1 slots and hit counts from a dense table (the coarsest level,
    which is not propagated)."""
    return rank_slots(_off_center(nbr), nbr.shape[1], h1, 0)


def _propagate_candidates(fine: VoxelGrid, trans: LevelTransition,
                          nbr_c: torch.Tensor) -> torch.Tensor:
    """Per fine voxel, the child tables of its 2x2x2 parent-block corners,
    V-minor -> (8, 8, Vf) int32."""
    vf = fine.capacity
    vc = nbr_c.shape[1]
    par = (fine.coords & 1).to(torch.int64)
    # coarse offset of block corner (ax, ay, az) is par - 1 + a per axis
    base = par[:, 0] * 9 + par[:, 1] * 3 + par[:, 2]  # (Vf,)
    corner = _on_device("corners", par.device)
    nbr_c_rows = torch.cat([nbr_c.T, nbr_c.new_full((1, 27), vc)])  # (Vc+1, 27)
    prow = nbr_c_rows[trans.parent.long()]  # (Vf, 27); dumped parents -> vc
    pns = prow.gather(1, base[:, None] + corner[None])  # (Vf, 8)
    child_pad = torch.cat([trans.child, trans.child.new_full((1, 8), vf)])
    return child_pad[pns.T.long()].permute(0, 2, 1).contiguous()  # (8, 8, Vf)


def propagate_nbr_slots(fine: VoxelGrid, trans: LevelTransition,
                        nbr_c: torch.Tensor, h1: int):
    """Fine-level neighbour table + tier-1 slots + hit counts from the coarse
    table: the candidate gathers, then the K3 kernel.
    Returns (nbr (27, Vf), src1 (h1, Vf), tap1 (h1, Vf), cnt (Vf,))."""
    crows = _propagate_candidates(fine, trans, nbr_c)
    par = (fine.coords & 1).T.contiguous().to(torch.int32)
    valid = fine.valid.to(torch.int32)[None]
    return propagate_slots(crows, par, valid, h1)


def _coarsen_grid(grid: VoxelGrid, capacity: Optional[int] = None):
    """Next-coarser voxel grid (stride-2 sites) and the transition maps."""
    vf = grid.capacity
    coarse = grid.coords >> 1
    hi, lo = K.pack(coarse, grid.batch)
    hi, lo = K.mask_invalid(hi, lo, grid.valid)
    grid_c = dedup_sorted(hi, lo, grid.full_scale // 2, capacity=capacity)
    vc = grid_c.capacity
    parent = grid_c.p2v
    rel = grid.coords & 1
    off_id = (rel[:, 0] * 4 + rel[:, 1] * 2 + rel[:, 2]).to(torch.int32)
    child = torch.full((vc + 1, 8), vf, dtype=torch.int32, device=parent.device)
    child[parent.long(), off_id.long()] = torch.arange(
        vf, dtype=torch.int32, device=parent.device)
    return grid_c, LevelTransition(parent=parent, off_id=off_id, child=child[:vc])


def coarsen(level: GridLevel, capacity: Optional[int] = None):
    """`_coarsen_grid` and a search-built neighbour table (standalone use,
    the JAX `coarsen`) -> (GridLevel, LevelTransition)."""
    grid_c, trans = _coarsen_grid(level, capacity=capacity)
    return _level(grid_c, build_nbr(grid_c)), trans


def _level(grid: VoxelGrid, nbr: torch.Tensor) -> GridLevel:
    return GridLevel(
        key_hi=grid.key_hi, key_lo=grid.key_lo, coords=grid.coords,
        batch=grid.batch, valid=grid.valid, num_voxels=grid.num_voxels,
        nbr=nbr, full_scale=grid.full_scale,
    )


SlotSpec = Union[None, int, Tuple[int, ...]]


def _check_spec(l: int, spec: SlotSpec) -> SlotSpec:
    if spec is None or (isinstance(spec, int) and not isinstance(spec, bool)
                        and spec >= 0):
        return spec
    if isinstance(spec, tuple) and len(spec) in (3, 5):
        return spec
    raise ValueError(f"level {l}: slot spec must be None, an int >= 0, or a 3- "
                     f"or 5-tuple, got {spec!r}")


def build_hierarchy(grid: VoxelGrid, num_levels: int,
                    capacities: Sequence[int],
                    slot_caps: Optional[Sequence[SlotSpec]],
                    num_batches: Optional[int], child_slot_caps=None,
                    stem_kernel: int = 3) -> Hierarchy:
    """All U-Net levels from the level-0 grid.

    `slot_caps[l]` takes every form the JAX `build_hierarchy` takes: a
    3-tier spec (h1, h2, h_max, vm_cap, vh_cap), a 2-tier spec (h_lo, h_max,
    vh_cap) (`train.batch.default_slot_caps`), an int h (1-tier: the first h
    hits, the rest dropped and counted), or None / 0 (no slot tables: the
    level's convolutions take the dense 27-tap path).  `slot_caps=None`, or
    a list shorter than `num_levels`, leaves the levels without a spec dense.

    The coarsest level's table comes from `build_nbr` (the dense map up to
    `_DENSE_NBR_MAX_ENTRIES` cells, the key search above); every finer one from
    `propagate_nbr_slots` (K3), which also yields its tier-1 slots.  A
    level without slots takes K3's table with h1 = 0: the same table as the
    JAX package's select tree (`propagate_nbr`), from one launch.

    `child_slot_caps` packs each transition's child table into slots
    (`build_child_slots`; "default" or one (h_lo, vh_cap) or None per
    transition, `child_slot_spec`), which the strided convolutions then
    take (`ops.spconv.down_conv2`, `up_conv2`); None (the default) keeps
    the plain child table, as in JAX.  `stem_kernel` is the size of the 3D
    network's first convolution: 5 adds level 0's 125-neighbour table
    (`GridLevel.nbr5`, `build_nbr5`)."""
    if stem_kernel not in (3, 5):
        raise ValueError(f"stem_kernel must be 3 or 5, got {stem_kernel}")
    nbr5 = stem_kernel == 5
    if nbr5 and num_levels < 2:
        raise ValueError("the 125-neighbour table is propagated from level 1: "
                         f"num_levels must be at least 2, got {num_levels}")
    grids: List[VoxelGrid] = [grid]
    transitions: List[LevelTransition] = []
    with span("topology/coarsen"):
        for l in range(1, num_levels):
            grid_c, trans = _coarsen_grid(grids[-1], capacity=capacities[l])
            spec = child_slot_spec(child_slot_caps, l - 1, grid_c.capacity)
            if spec is not None:
                h_lo, vh_cap = spec
                (trans.cslot_src, trans.cslot_tap, trans.cslot_idx, trans.cslot_src2,
                 trans.cslot_tap2, trans.cslot_overflow) = build_child_slots(
                    trans.child, grids[-1].capacity, h_lo,
                    min(vh_cap, grid_c.capacity))
            grids.append(grid_c)
            transitions.append(trans)
    specs = [_check_spec(l, slot_caps[l])
             if slot_caps is not None and l < len(slot_caps) else None
             for l in range(num_levels)]
    h1s = [(spec[0] if isinstance(spec, tuple) else spec) or 0 for spec in specs]
    has_slots = [isinstance(spec, tuple) or bool(spec) for spec in specs]

    nbrs = [None] * num_levels
    tier1 = [None] * num_levels  # (src1, tap1, cnt)
    with span("topology/neighbours"):
        nbrs[-1] = build_nbr(grids[-1], num_batches)
        if has_slots[-1]:
            tier1[-1] = _tier1(nbrs[-1], h1s[-1])
        for l in range(num_levels - 2, -1, -1):
            nbrs[l], s1, t1, cnt = propagate_nbr_slots(
                grids[l], transitions[l], nbrs[l + 1], h1s[l])
            tier1[l] = (s1, t1, cnt)
    if nbr5:
        with span("topology/nbr5"):
            nbr5_0 = build_nbr5(grids[0], transitions[0], nbrs[1])

    levels = []
    with span("topology/slots"):
        for l, (g, n, spec) in enumerate(zip(grids, nbrs, specs)):
            lev = _level(g, n)
            if has_slots[l]:
                s1, t1, cnt = tier1[l]
                lev.slot_src, lev.slot_tap = s1, t1
            if isinstance(spec, tuple) and len(spec) == 5:
                h1, h2, h_max, vm_cap, vh_cap = spec
                (lev.slot_idxm, lev.slot_invm, lev.slot_srcm, lev.slot_tapm,
                 lev.slot_idx, lev.slot_src2, lev.slot_tap2, lev.slot_overflow) = (
                    finish_slots_tiered(n, cnt, h1, h2, h_max,
                                        min(vm_cap, g.capacity),
                                        min(vh_cap, g.capacity)))
            elif isinstance(spec, tuple):
                h_lo, h_max, vh_cap = spec
                lev.slot_idx, lev.slot_src2, lev.slot_tap2, lev.slot_overflow = (
                    finish_slots_split(n, cnt, h_lo, h_max, min(vh_cap, g.capacity)))
            elif spec:
                lev.slot_overflow = _over_tail(cnt, spec)
            levels.append(lev)
    if nbr5:
        levels[0].nbr5 = nbr5_0
    return Hierarchy(levels=tuple(levels), transitions=tuple(transitions))
