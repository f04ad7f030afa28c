"""K2: weight gradient of the slot-compacted sparse convolution.

Port of `mm2d3d_tpu/ops/pallas/bandmm.py::slot_conv_dw`:

    dW[k] = sum_{h, v : tap[h, v] = k} x_src[h, v]^T g[v]
            (+ xm^T g into row 13)                   -> (K, Ci, Co) fp32

CUDA kernel: `mm2d3d_tpu_torch/csrc/bandmm_dw.cu` (per-chunk partial sums,
then a fixed-order reduction: deterministic, no float atomics); plain
version: `slot_conv_dw_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)
from .bandmm import CENTER

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # threads per block of the partial-sum pass, one (ci, co) each
_TARGET_BLOCKS = 528  # four blocks per SM of an H100: chunks = this / tiles
_MAX_SLOTS = 27  # slots staged per row (H, plus the centre): 42 KB of shared memory
_MIN_ROWS = 64  # fewest voxel rows a chunk is given


def _bind(lib):
    lib.slot_conv_dw.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p,
    ]
    lib.slot_conv_dw.restype = ctypes.c_int


KERNEL = register(Kernel(
    "bandmm_dw", ("bandmm_dw.cu", "common.cuh"), _bind,
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


def _chunking(v: int, ci: int, co: int):
    """(co_tile, rows_per_chunk, n_chunks) of the partial-sum pass: enough
    chunks of voxel rows to give the card ~_TARGET_BLOCKS blocks.  A pure
    function of the shapes, so the summation order is fixed."""
    co_tile = 16 if co <= 16 else 32
    tiles = -(-ci // (_THREADS // co_tile)) * -(-co // co_tile)
    if v == 0:
        return co_tile, _MIN_ROWS, 0
    chunks = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-v // _MIN_ROWS)))
    rows = -(-v // chunks)
    return co_tile, rows, -(-v // rows)


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
    if h + (xm is not None) > _MAX_SLOTS or k_taps > 27:
        raise ValueError(f"H={h} slots (+ centre) or K={k_taps} beyond the kernel's "
                         f"limits of {_MAX_SLOTS} and 27")
    co_tile, rows, n_chunks = _chunking(v, ci, co)
    partial = torch.empty((n_chunks, k_taps, ci, co), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((k_taps, ci, co), dtype=torch.float32, device=g.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.slot_conv_dw(
        ptr(xm), ptr(x_src), ptr(tap), ptr(g), ptr(partial), ptr(out),
        v, h, ci, co, k_taps, co_tile, rows, n_chunks, _DTYPES[g.dtype],
        stream(),
    ))
    return out
