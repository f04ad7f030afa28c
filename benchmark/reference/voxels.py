"""Plain voxelisation, coarsening and neighbour search.

Level 0 holds one voxel per distinct (scan, x, y, z) among the valid points
inside the grid [0, full_scale)^3; level l + 1 holds the distinct
(scan, x >> 1, y >> 1, z >> 1) of level l, on a grid half as wide.  A
submanifold 3x3x3 convolution at a level pairs every voxel with each voxel
at offset (dx, dy, dz) in {-1, 0, 1}^3 (taps in lexicographic order, the
centre is tap 13); a stride-2 convolution pairs each voxel with its parent,
through the tap (x & 1) * 4 + (y & 1) * 2 + (z & 1).  Voxels are kept in
the order of their integer keys, which is an implementation choice: every
result the reference gives is per point or a sum over voxels.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

OFFSETS_27 = list(itertools.product((-1, 0, 1), repeat=3))


@dataclass
class Level:
    keys: torch.Tensor  # (V,) int64, ascending
    coords: torch.Tensor  # (V, 3) int64
    full_scale: int
    # per tap k: (output rows, input rows) of the submanifold convolution
    pairs: List[Tuple[torch.Tensor, torch.Tensor]]

    @property
    def num_voxels(self) -> int:
        return self.keys.shape[0]

    def num_pairs(self) -> int:
        return sum(int(o.numel()) for o, _ in self.pairs)


@dataclass
class Transition:
    parent: torch.Tensor  # (V_fine,) int64 row of the parent voxel
    tap: torch.Tensor  # (V_fine,) int64 in [0, 8)
    _rows: Optional[List[torch.Tensor]] = None

    def rows_by_tap(self) -> List[torch.Tensor]:
        """The fine rows of each tap; within one tap no two share a parent."""
        if self._rows is None:
            self._rows = [torch.nonzero(self.tap == t)[:, 0] for t in range(8)]
        return self._rows


@dataclass
class Voxels:
    levels: List[Level]
    transitions: List[Transition]
    point_voxel: torch.Tensor  # (P,) int64 voxel row of each point, -1 = none
    counts: torch.Tensor  # (V0,) points per level-0 voxel


def _key(scan: torch.Tensor, c: torch.Tensor, fs: int) -> torch.Tensor:
    return ((scan * fs + c[:, 0]) * fs + c[:, 1]) * fs + c[:, 2]


def _decode(keys: torch.Tensor, fs: int):
    z = keys % fs
    y = (keys // fs) % fs
    x = (keys // (fs * fs)) % fs
    return keys // (fs ** 3), torch.stack([x, y, z], 1)


def _level(keys: torch.Tensor, fs: int) -> Level:
    scan, coords = _decode(keys, fs)
    v = keys.shape[0]
    pairs = []
    for off in OFFSETS_27:
        q = coords + torch.tensor(off, device=keys.device)
        inside = ((q >= 0) & (q < fs)).all(1)
        qk = _key(scan, q.clamp(0, fs - 1), fs)
        pos = torch.searchsorted(keys, qk).clamp(max=v - 1)
        hit = inside & (keys[pos] == qk)
        pairs.append((torch.nonzero(hit)[:, 0], pos[hit]))
    return Level(keys=keys, coords=coords, full_scale=fs, pairs=pairs)


def voxelize(coords: torch.Tensor, point_mask: torch.Tensor, full_scale: int,
             num_levels: int) -> Voxels:
    """coords (B, N, 3) int, point_mask (B, N) bool -> every level."""
    b, n = point_mask.shape
    c = coords.reshape(-1, 3).long()
    scan = torch.arange(b, device=c.device).repeat_interleave(n)
    ok = point_mask.reshape(-1) & ((c >= 0) & (c < full_scale)).all(1)
    keys, inv = torch.unique(_key(scan[ok], c[ok], full_scale), return_inverse=True)
    point_voxel = torch.full((b * n,), -1, dtype=torch.int64, device=c.device)
    point_voxel[ok] = inv
    counts = torch.bincount(inv, minlength=keys.shape[0])

    levels = [_level(keys, full_scale)]
    transitions = []
    fs = full_scale
    for _ in range(1, num_levels):
        scan_l, coords_l = _decode(levels[-1].keys, fs)
        fs //= 2
        parent_keys, parent = torch.unique(_key(scan_l, coords_l >> 1, fs),
                                           return_inverse=True)
        rel = coords_l & 1
        transitions.append(Transition(parent=parent,
                                      tap=rel[:, 0] * 4 + rel[:, 1] * 2 + rel[:, 2]))
        levels.append(_level(parent_keys, fs))
    return Voxels(levels=levels, transitions=transitions,
                  point_voxel=point_voxel, counts=counts)
