"""K10: the banded slot-conv apply on pre-gathered inputs, a probe of K1's
E build.

Port of the TPU probe kernels of the JAX package's
`tools/exp_bandmm_variants.py` (`kern_a`-`kern_d`, `mk_c`, `mk_pair`),
which time E-build variants of the banded kernel of
`mm2d3d_tpu/ops/pallas/bandmm.py` on fixed gathered inputs.  In the TPU's
(channels, voxels) layout:

    out = W @ E                                          -> (Co, V) fp32

with band k of E (K * Ci, V) the sum of every source of band k: the slot
rows x[h] whose tap is k and, on band 13, the centre xm first; summed in
fp32 and rounded once to the input type.  On a real slot table (each tap
at most once per column, never 13; `real_table_taps`) every band has one
source at most, so E is exact and this is K1's function.  The TPU
variants differ from it, and from each other, only on other tables:
`kern_a` replaces band 13 by xm and skips taps below the slot index,
`mk_pair` adds tap-13 rows to the centre and skips taps below the slot
index less one.

CUDA kernel: `csrc/exp_bandmm.cu`, a persistent grid (`band_plan`): each
block stages W once and walks tiles of 64 or 128 voxels through a ring of
`RING_STAGES` stages filled by tensor-map copies on mbarriers; the banded
operand is built in registers, never in memory, and multiplied on the
tensor cores, `full` (all K bands) or `compact` (the bands a warp's 16
voxels hit).  Plain version `band_apply_ref`.  No system path calls it:
`tools/exp_bandmm_variants.py` (the port's) times it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)
from .tapsum import SMS

CENTER = 13
E_BUILDS = ("full", "compact")
VOXELS_PER_BLOCK = (64, 128)  # voxels per tile, one consumer warp per 16
RING_STAGES = 3  # csrc/exp_bandmm.cu: kStages
# the persistent grid: at most this many blocks per SM, by voxels per tile
# (csrc/exp_bandmm.cu: __launch_bounds__)
BLOCKS_PER_SM = {64: 3, 128: 2}
MAX_CI = 256  # csrc/exp_bandmm.cu: a tensor map's box holds at most 256 rows
MAX_CO = 64  # csrc/exp_bandmm.cu: kMaxCo
MAX_SLOTS = 8  # csrc/exp_bandmm.cu: kMaxSlots (H)
MAX_TAPS = 32  # csrc/bandsel.cuh: kMaxTcBands
MAX_SMEM_BYTES = 227 * 1024 - 1024  # csrc/bulk.cuh: kMaxBulkBytes
SM_SMEM_BYTES = 228 * 1024  # shared memory of one SM, 1 KB of it reserved per block


def _bind(lib):
    lib.exp_bandmm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p,
    ]
    lib.exp_bandmm.restype = ctypes.c_int


KERNEL = register(Kernel(
    "exp_bandmm",
    ("exp_bandmm.cu", "common.cuh", "mma.cuh", "bandsel.cuh", "bulk.cuh", "tma.cuh"),
    _bind,
    replaces="tools/exp_bandmm_variants.py:71",
))


def smem_bytes(bv: int, h: int, ci: int, co: int, k: int) -> int:
    """Shared memory of one block (csrc/exp_bandmm.cu::smem_bytes): 1 KB to
    align the ring; `RING_STAGES` stages of H + 1 (Ci, bv) bf16 blocks (x's
    slots and xm) and H int32 tap rows, each a whole number of KB; W with
    rows padded by 8 bf16; two (Co, bv + 4) fp32 out tiles; per consumer
    warp a 512-byte (voxel, channel) block per source the kernel holds (3
    slots up to H = 3, else 8; the centre; zeros)."""
    stage = -(-(2 * (h + 1) * ci * bv + 4 * h * bv) // 1024) * 1024
    slots = 3 if h <= 3 else MAX_SLOTS
    return (1024 + RING_STAGES * stage + 2 * co * (k * ci + 8) + 8 * co * (bv + 4)
            + bv // 16 * (slots + 2) * 512)


def band_plan(v: int, h: int, ci: int, co: int, k: int, voxels: int) -> dict:
    """The kernel's launch: `tiles` of `voxels` voxels, a persistent grid of
    `blocks` (up to BLOCKS_PER_SM per SM where they fit its shared memory,
    never more than the tiles), `threads` per block (a consumer warp per 16
    voxels and the producer warp) and `smem` bytes per block."""
    smem = smem_bytes(voxels, h, ci, co, k)
    tiles = -(-v // voxels)
    per_sm = max(1, min(BLOCKS_PER_SM[voxels], SM_SMEM_BYTES // (smem + 1024)))
    return {"tiles": tiles, "blocks": max(1, min(tiles, SMS * per_sm)),
            "per_sm": per_sm, "threads": 32 * (voxels // 16 + 1), "smem": smem}


def real_table_taps(rng: np.random.RandomState, h: int, v: int, k: int = 27,
                    hit: float = 0.8) -> np.ndarray:
    """Taps (h, v) int32 as a real slot table holds them
    (`ops/kernels/propagate.py::rank_slots`): per column h distinct
    off-centre taps in ascending order, each kept with probability `hit`,
    the kept ones packed into the first slots, misses (`k`) after them."""
    off = np.array([t for t in range(k) if t != CENTER])
    pick = np.sort(off[np.argsort(rng.rand(v, off.size), axis=1)[:, :h]], axis=1)
    keep = rng.rand(v, h) < hit
    order = np.argsort(~keep, axis=1, kind="stable")  # kept first, in order
    taps = np.where(np.take_along_axis(keep, order, 1),
                    np.take_along_axis(pick, order, 1), k)
    return np.ascontiguousarray(taps.T).astype(np.int32)


def band_matrix(xm: Optional[torch.Tensor], x: torch.Tensor, tap: torch.Tensor,
                k_taps: int) -> torch.Tensor:
    """E (K * Ci, V) in x's type: band k the fp32 sum of its sources (the
    centre first, then the slots in order), rounded once."""
    h, ci, v = x.shape
    e = torch.zeros((k_taps, ci, v), dtype=torch.float32, device=x.device)
    if xm is not None:
        e[CENTER] = xm.float()
    for s in range(h):
        hit = tap[s][None, :] == torch.arange(k_taps, device=x.device)[:, None]
        e = torch.where(hit[:, None, :], e + x[s].float(), e)
    return e.to(x.dtype).reshape(k_taps * ci, v)


def band_apply_ref(xm: Optional[torch.Tensor], x: torch.Tensor, tap: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Plain version of `band_apply`: W @ E in fp32."""
    k_taps = w.shape[1] // x.shape[1]
    return w.float() @ band_matrix(xm, x, tap, k_taps).float()


def _check(xm, x, tap, w, e_build, voxels):
    if x.dim() != 3 or tap.shape != (x.shape[0], x.shape[2]) or w.dim() != 2:
        raise ValueError(f"band_apply: expected x (H, Ci, V), tap (H, V), w (Co, "
                         f"K * Ci), got {tuple(x.shape)}, {tuple(tap.shape)}, "
                         f"{tuple(w.shape)}")
    h, ci, v = x.shape
    if w.shape[1] % ci != 0:
        raise ValueError(f"band_apply: w's {w.shape[1]} columns are not K x Ci = {ci}")
    if xm is not None and xm.shape != (ci, v):
        raise ValueError(f"band_apply: xm must be (Ci, V) = {(ci, v)}")
    if tap.dtype != torch.int32:
        raise TypeError(f"band_apply: tap must be int32, got {tap.dtype}")
    if e_build not in E_BUILDS or voxels not in VOXELS_PER_BLOCK:
        raise ValueError(f"band_apply: e_build in {E_BUILDS} and voxels in "
                         f"{VOXELS_PER_BLOCK}, got {e_build!r}, {voxels}")
    if xm is not None and w.shape[1] // ci <= CENTER:
        raise ValueError("band_apply: the centre xm needs K > 13")


def band_apply(xm: Optional[torch.Tensor], x: torch.Tensor, tap: torch.Tensor,
               w: torch.Tensor, e_build: str = "full", voxels: int = 64) -> torch.Tensor:
    """xm (Ci, V) or None, x (H, Ci, V), tap (H, V) int32, w (Co, K * Ci)
    -> out (Co, V) fp32 = W @ E.  On a CUDA tensor: bf16, Ci and Co
    multiples of 16, Ci <= 256, Co <= 64, K <= 32, H <= 8, one block's W,
    ring and out tiles within 226 KB of shared memory; `e_build` ("full" or
    "compact") and `voxels` (64 or 128 per tile) pick the kernel's variant,
    and the result is the same function either way."""
    _check(xm, x, tap, w, e_build, voxels)
    no_grad_inputs(xm, x, w)
    if not on_cuda(xm, x, tap, w):
        return band_apply_ref(xm, x, tap, w)

    h, ci, v = x.shape
    co, k = w.shape[0], w.shape[1] // ci
    if {x.dtype, w.dtype} | ({xm.dtype} if xm is not None else set()) != {torch.bfloat16}:
        raise TypeError("band_apply: the kernel takes bf16 xm, x and w")
    if (ci % 16 or ci > MAX_CI or co % 16 or co > MAX_CO or k > MAX_TAPS
            or h > MAX_SLOTS):
        raise ValueError(f"band_apply: the kernel takes Ci, Co multiples of 16, "
                         f"Ci <= {MAX_CI}, Co <= {MAX_CO}, K <= {MAX_TAPS}, H <= "
                         f"{MAX_SLOTS}; got {ci}, {co}, {k}, {h}")
    plan = band_plan(v, h, ci, co, k, voxels)
    need = plan["smem"]
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"band_apply: a block needs {need} B of shared memory, "
                         f"more than {MAX_SMEM_BYTES}")
    require_contiguous(xm=xm, x=x, tap=tap, w=w)
    if w.data_ptr() % 16:
        raise ValueError("band_apply: w must be 16-byte aligned")
    out = torch.empty((co, v), dtype=torch.float32, device=x.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.exp_bandmm(
        ptr(xm), ptr(x) if h else None, ptr(tap), ptr(w), ptr(out), v, h, ci, co, k,
        int(e_build == "compact"), voxels, plan["blocks"], stream(),
    ))
    return out
