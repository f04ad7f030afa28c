"""Morton pair keys for sparse voxel grids (port of `mm2d3d_tpu/ops/keys.py`).

A voxel site (batch, x, y, z), coordinates < 4096, is identified by a pair of
int32 keys holding (batch, morton(x, y, z)), the 36-bit z-order interleave:

    hi = (batch << 6) | morton_bits[30:36]
    lo = morton_bits[0:30]

Pairs order lexicographically, which equals (batch, morton) order, and
right-shifting coordinates keeps that order (morton(c >> 1) == morton(c) >> 3),
so a coarsened sorted table is sorted already.  The bit arithmetic runs in
int64 (torch's uint32 shifts are incomplete) and the keys come out int32, as
in the JAX package, so tables compare bit for bit.  Where this port sorts or
searches, it takes one int64 key ``hi << 32 | (lo + 2^31)``, which has the
pairs' signed lexicographic order.
"""

from __future__ import annotations

import functools

import torch

INVALID = torch.iinfo(torch.int32).max  # sorts after every real key


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of `v` (int64) to bit positions 0,3,...,27."""
    v = v & 0x3FF
    v = (v ^ (v << 16)) & 0xFF0000FF
    v = (v ^ (v << 8)) & 0x0300F00F
    v = (v ^ (v << 4)) & 0x030C30C3
    v = (v ^ (v << 2)) & 0x09249249
    return v


def _compact1by2(v: torch.Tensor) -> torch.Tensor:
    """Inverse of `_part1by2`: collect bits 0,3,...,27 into the low 10 bits."""
    v = v & 0x09249249
    v = (v ^ (v >> 2)) & 0x030C30C3
    v = (v ^ (v >> 4)) & 0x0300F00F
    v = (v ^ (v >> 8)) & 0xFF0000FF
    v = (v ^ (v >> 16)) & 0x3FF
    return v


@functools.lru_cache(maxsize=None)
def _spread_table(device: torch.device) -> torch.Tensor:
    """`_part1by2` of every 10-bit value: one gather replaces its 13 ops."""
    return _part1by2(torch.arange(1024, dtype=torch.int64)).to(device)


def pack(coords: torch.Tensor, batch: torch.Tensor):
    """Integer voxel coords (..., 3) + batch index (...) -> (hi, lo) int32.

    Coordinates must be in [0, 4096); callers mask out-of-range entries."""
    spread = _spread_table(coords.device)
    c = coords.to(torch.int64)
    lo10 = spread[c & 0x3FF]  # (..., 3) spread low 10 bits of x, y, z
    hi10 = spread[(c >> 10) & 0x3FF]  # bits 10..19 (the uint32 view's)
    lo = (lo10[..., 2] | (lo10[..., 1] << 1)) | (lo10[..., 0] << 2)
    hi6 = (hi10[..., 2] | (hi10[..., 1] << 1)) | (hi10[..., 0] << 2)
    hi = (((batch.to(torch.int64) & 0xFFFFFFFF) << 6) | hi6) & 0xFFFFFFFF
    return _as_int32(hi), _as_int32(lo)


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """Wrap a uint32 value held in int64 to int32, as a bit cast would."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def batch_of(hi: torch.Tensor) -> torch.Tensor:
    """Batch index from the hi key."""
    return hi >> 6


def unpack(hi: torch.Tensor, lo: torch.Tensor):
    """Inverse of `pack`: keys -> (coords (..., 3) int32, batch int32).
    Garbage on INVALID keys; callers mask."""
    lo_u = lo.to(torch.int64) & 0xFFFFFFFF
    hi_u = hi.to(torch.int64) & 0x3F  # morton bits 30..35
    x = _compact1by2(lo_u >> 2) | (_compact1by2(hi_u >> 2) << 10)
    y = _compact1by2(lo_u >> 1) | (_compact1by2(hi_u >> 1) << 10)
    z = _compact1by2(lo_u) | (_compact1by2(hi_u) << 10)
    coords = torch.stack([x, y, z], dim=-1).to(torch.int32)
    return coords, batch_of(hi)


def mask_invalid(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor):
    """Replace keys of invalid entries with the INVALID sentinel."""
    return (torch.where(valid, hi, INVALID).to(torch.int32),
            torch.where(valid, lo, INVALID).to(torch.int32))


def _packed(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key per pair, in the pairs' order: lo + 2^31 maps the
    signed int32 order of lo onto [0, 2^32)."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + (1 << 31))


def sort_perm(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting pair keys lexicographically ((hi, lo)
    ascending), via one int64 key with the same order."""
    return torch.sort(_packed(hi, lo), stable=True).indices.to(torch.int32)


def pairs_less(hi_a, lo_a, hi_b, lo_b):
    return (hi_a < hi_b) | ((hi_a == hi_b) & (lo_a < lo_b))


def pairs_equal(hi_a, lo_a, hi_b, lo_b):
    return (hi_a == hi_b) & (lo_a == lo_b)


def searchsorted_pairs(hi_sorted: torch.Tensor, lo_sorted: torch.Tensor,
                       hi_query: torch.Tensor, lo_query: torch.Tensor
                       ) -> torch.Tensor:
    """Leftmost insertion index (int32) of each query pair into a sorted
    pair table: the JAX package's branchless binary search, as one
    `torch.searchsorted` over the packed keys (no host sync)."""
    return torch.searchsorted(_packed(hi_sorted, lo_sorted),
                              _packed(hi_query, lo_query), out_int32=True)


def lookup_pairs(hi_sorted: torch.Tensor, lo_sorted: torch.Tensor,
                 hi_query: torch.Tensor, lo_query: torch.Tensor,
                 missing: int) -> torch.Tensor:
    """Exact-match lookup: index (int32) of each query in the sorted table,
    or `missing`.  A query whose hi is INVALID is never found, though the
    table's padding rows hold INVALID too."""
    table = _packed(hi_sorted, lo_sorted)
    query = _packed(hi_query, lo_query)
    idx = torch.searchsorted(table, query, out_int32=True)
    idx = torch.clamp(idx, max=table.shape[0] - 1)
    found = (table[idx.long()] == query) & (hi_query != INVALID)
    return torch.where(found, idx, missing).to(torch.int32)
