"""K2: weight gradient of the slot-compacted sparse convolution.

Port of `mm2d3d_tpu/ops/pallas/bandmm.py::slot_conv_dw`:

    dW[k] = sum_{h, v : tap[h, v] = k} x_src[h, v]^T g[v]
            (+ xm^T g into row 13)                   -> (K, Ci, Co) fp32

CUDA kernel: `mm2d3d_tpu_torch/csrc/bandmm_dw.cu`; plain version:
`slot_conv_dw_ref`.  Blocks sum chunks of voxels into fp32 partials, and a
second pass adds the chunks in a fixed order: deterministic, no float
atomics.  bf16 with Ci % 8 == 0 runs on tensor cores as E^T @ g with the
TPU's banded matrix E built in shared memory (`bandmm.band_sources`), each
block owning 64 rows (band, ci) of dW and one chunk (`dw_plan`); fp32 and
Ci % 8 != 0 run on CUDA cores, one (ci, co) pair per thread.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)
from .bandmm import CENTER, slot_tensor_cores
from .tapsum import column_tile

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# CUDA cores
_THREADS = 256  # threads per block of the partial-sum pass, one (ci, co) each
_TARGET_BLOCKS = 528  # four blocks per SM of an H100: chunks = this / tiles
_MAX_SLOTS = 27  # slots staged per row (H, plus the centre): 42 KB of shared memory
_MIN_ROWS = 64  # fewest voxel rows a chunk is given
# tensor cores (csrc/bandmm_dw.cu)
TC_ROWS = 64  # rows (band, ci) of dW per block
TC_MIN_ROWS = 128  # fewest voxels a chunk is given: two stages of 64
SEL_BYTES = 16384  # the band table: bands x voxels of a chunk, one byte each
_TC_SMALL_DW = 16384  # K * Ci * Co of a dW whose partials are cheap


def _bind(lib):
    lib.slot_conv_dw.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p,
    ]
    lib.slot_conv_dw.restype = ctypes.c_int


KERNEL = register(Kernel(
    "bandmm_dw", ("bandmm_dw.cu", "common.cuh", "mma.cuh", "bandsel.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/pallas/bandmm.py:102",
))


def slot_conv_dw_ref(xm: Optional[torch.Tensor],
                     x_src: Optional[torch.Tensor],
                     tap: Optional[torch.Tensor],
                     g: torch.Tensor, k_taps: int = 27) -> torch.Tensor:
    """Plain PyTorch version: the one-hot band einsum of `_dw_xla`, in fp32
    (bf16 products are exact in fp32)."""
    ci = (xm if xm is not None else x_src).shape[-1]
    gf = g.float()
    if x_src is not None:
        v = x_src.shape[1]
        taps = torch.arange(k_taps, dtype=tap.dtype, device=tap.device)
        onehot = (tap[..., None] == taps).float()  # (H, V, K); misses all 0
        e = torch.einsum("hvk,hvc->vkc", onehot, x_src.float())
        dw = (e.reshape(v, k_taps * ci).T @ gf).reshape(k_taps, ci, -1)
    else:
        dw = gf.new_zeros((k_taps, ci, g.shape[-1]))
    if xm is not None:
        dw[CENTER] += xm.float().T @ gf
    return dw


class DwPlan(NamedTuple):
    tile: int  # tensor cores: output channels per block; CUDA cores: threads along Co
    rows: int  # voxels per chunk
    chunks: int  # ceil(V / rows): the partials summed by the second pass


def max_bands(ci: int, k: int) -> int:
    """Bands that a tensor-core block's 64 rows of dW can touch."""
    return min(k, (TC_ROWS - 1) // ci + 2)


def dw_plan(k: int, v: int, h: int, ci: int, co: int,
            dtype: torch.dtype = torch.bfloat16,
            target: Optional[int] = None) -> DwPlan:
    """The launch: blocks of dW rows x output channels x voxel chunks, with
    enough chunks to give the card ~528 blocks (CUDA cores: (ci, co) pairs,
    chunks of at least 64 voxels) or, on tensor cores (64 rows of K * Ci per
    block, K6's column tile, chunks of at least 128 voxels whose band table
    fits 16 KB), ~528 where dW is small (level 0: its partials are cheap)
    and ~264 where it is not (the partials' traffic grows with the chunks;
    `tools/slotconv_tiles.py` measured both; `target` sets a tensor-core
    plan's block count for that probe).  A pure function of the shapes, so
    the summation order is fixed."""
    if slot_tensor_cores(dtype, ci, h, k):
        bn = column_tile(co)
        tiles = -(-k * ci // TC_ROWS) * -(-co // bn)
        if target is None:
            target = (_TARGET_BLOCKS if k * ci * co <= _TC_SMALL_DW
                      else _TARGET_BLOCKS // 2)
        min_rows, tile = TC_MIN_ROWS, bn
        max_rows = SEL_BYTES // max_bands(ci, k)
    else:
        tile = 16 if co <= 16 else 32
        tiles = -(-ci // (_THREADS // tile)) * -(-co // tile)
        target, min_rows, max_rows = _TARGET_BLOCKS, _MIN_ROWS, v
    if v == 0:
        return DwPlan(tile, min_rows, 0)
    chunks = max(1, min(-(-target // tiles), -(-v // min_rows)))
    rows = min(-(-v // chunks), max_rows)
    return DwPlan(tile, rows, -(-v // rows))


def partial_shape(plan: DwPlan, k: int, ci: int, co: int,
                  on_tensor_cores: bool) -> Optional[Tuple[int, ...]]:
    """The fp32 partials the wrapper allocates: (chunks, K, Ci, Co); None
    where there are no chunks, or where the tensor-core kernel writes dW
    straight (one chunk)."""
    if plan.chunks == 0 or (on_tensor_cores and plan.chunks == 1):
        return None
    return (plan.chunks, k, ci, co)


def slot_conv_dw(xm: Optional[torch.Tensor],
                 x_src: Optional[torch.Tensor],
                 tap: Optional[torch.Tensor],
                 g: torch.Tensor, k_taps: int = 27) -> torch.Tensor:
    """Weight gradient of `bandmm.slot_conv_apply` -> (K, Ci, Co) fp32 (row
    13 gets xm^T g iff `xm` is given).

    Args:
      xm: (V, Ci) validity-masked centre features, or None.  27 taps only.
      x_src: (H, V, Ci) gathered slot features, or None.
      tap: (H, V) int32 band ids in [0, K); K marks an empty slot.
      g: (V, Co) gradient of the output rows, same dtype as the features
        (fp32 or bf16).
    """
    ref = xm if xm is not None else x_src
    if ref is None:
        raise ValueError("slot_conv_dw needs xm or x_src")
    v, ci = ref.shape[-2], ref.shape[-1]
    if g.dim() != 2 or g.shape[0] != v:
        raise ValueError(f"g {tuple(g.shape)} vs V={v}")
    co = g.shape[1]
    if xm is not None and (xm.shape != (v, ci) or k_taps != 27):
        raise ValueError(f"xm {tuple(xm.shape)} with K={k_taps}")
    if x_src is not None:
        h = x_src.shape[0]
        if x_src.shape != (h, v, ci) or tap is None or tap.shape != (h, v):
            raise ValueError(
                f"x_src {tuple(x_src.shape)} / tap "
                f"{None if tap is None else tuple(tap.shape)} vs V={v}, Ci={ci}"
            )
        if tap.dtype != torch.int32:
            raise TypeError(f"tap must be int32, got {tap.dtype}")
    else:
        h = 0
    for name, t in (("xm", xm), ("x_src", x_src)):
        if t is not None and t.dtype != g.dtype:
            raise TypeError(f"{name} {t.dtype} != g {g.dtype}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {g.dtype}")
    no_grad_inputs(xm, x_src, tap, g)
    if not on_cuda(xm, x_src, tap, g):
        return slot_conv_dw_ref(xm, x_src, tap, g, k_taps)

    require_contiguous(xm=xm, x_src=x_src, tap=tap, g=g)
    tc = slot_tensor_cores(g.dtype, ci, h, k_taps)
    if tc:
        if any(t is not None and t.data_ptr() % 16 for t in (xm, x_src, g)):
            raise ValueError("xm, x_src and g must be 16-byte aligned (cp.async)")
    elif h + (xm is not None) > _MAX_SLOTS or k_taps > 27:
        raise ValueError(f"H={h} slots (+ centre) or K={k_taps} beyond the CUDA-core "
                         f"kernel's limits of {_MAX_SLOTS} and 27")
    plan = dw_plan(k_taps, v, h, ci, co, g.dtype)
    shape = partial_shape(plan, k_taps, ci, co, tc)
    partial = (None if shape is None
               else torch.empty(shape, dtype=torch.float32, device=g.device))
    out = torch.empty((k_taps, ci, co), dtype=torch.float32, device=g.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.slot_conv_dw(
        ptr(xm), ptr(x_src), ptr(tap), ptr(g), ptr(partial), ptr(out),
        v, h, ci, co, k_taps, *plan, _DTYPES[g.dtype], stream(),
    ))
    return out
