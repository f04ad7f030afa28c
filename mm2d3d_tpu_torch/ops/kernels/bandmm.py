"""K1: slot-compacted sparse convolution apply.

Port of `mm2d3d_tpu/ops/pallas/bandmm.py::slot_conv_apply` (forward only):

    out[v] = sum_h [0 <= tap[h, v] < K] x_src[h, v] @ W[tap[h, v]]
             (+ xm[v] @ W[13])                       -> (V, Co) fp32

CUDA kernel: `mm2d3d_tpu_torch/csrc/bandmm.cu` (a tiled gather-GEMM, not the
TPU's banded matrix); plain version: `slot_conv_apply_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)

CENTER = 13
_MAX_CI = 512  # the kernel stages 16 * Ci fp32 per block in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    lib.slot_conv_apply.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p,
    ]
    lib.slot_conv_apply.restype = ctypes.c_int


KERNEL = register(Kernel(
    "bandmm", ("bandmm.cu", "common.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/pallas/bandmm.py:87",
))


def slot_conv_apply_ref(xm: Optional[torch.Tensor],
                        x_src: Optional[torch.Tensor],
                        tap: Optional[torch.Tensor],
                        weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the one-hot band einsum of `_apply_xla`, in fp32
    (a one-hot select is exact in any type, and bf16 products are exact in
    fp32)."""
    k_taps, ci, co = weight.shape
    w = weight.float()
    out = None
    if x_src is not None:
        h, v, _ = x_src.shape
        taps = torch.arange(k_taps, dtype=tap.dtype, device=tap.device)
        onehot = (tap[..., None] == taps).float()  # (H, V, K); misses all 0
        e = torch.einsum("hvk,hvc->vkc", onehot, x_src.float())
        out = e.reshape(v, k_taps * ci) @ w.reshape(k_taps * ci, co)
    if xm is not None:
        ctr = xm.float() @ w[CENTER]
        out = ctr if out is None else out + ctr
    return out


def slot_conv_apply(xm: Optional[torch.Tensor],
                    x_src: Optional[torch.Tensor],
                    tap: Optional[torch.Tensor],
                    weight: torch.Tensor) -> torch.Tensor:
    """sum_h x_src[h] @ weight[tap[h]]  (+ xm @ weight[13])  ->  (V, Co) fp32.

    Args:
      xm: (V, Ci) validity-masked centre features, or None.  Only meaningful
        for 27-tap weights.
      x_src: (H, V, Ci) gathered slot features, or None for a centre-only
        application.
      tap: (H, V) int32 band ids in [0, K); K marks an empty slot.
      weight: (K, Ci, Co), same dtype as the features (fp32 or bf16).

    The TPU kernel's `tap_lo` (a band-pruning bound for the overflow tiers)
    has no counterpart: this kernel reads each slot's own tap.
    """
    k_taps, ci, co = weight.shape
    ref = xm if xm is not None else x_src
    if ref is None:
        raise ValueError("slot_conv_apply needs xm or x_src")
    v = ref.shape[-2]
    if xm is not None and (xm.shape != (v, ci) or k_taps != 27):
        raise ValueError(f"xm {tuple(xm.shape)} vs weight {tuple(weight.shape)}")
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
        if t is not None and t.dtype != weight.dtype:
            raise TypeError(f"{name} {t.dtype} != weight {weight.dtype}")
    if weight.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {weight.dtype}")
    no_grad_inputs(xm, x_src, tap, weight)
    if not on_cuda(xm, x_src, tap, weight):
        return slot_conv_apply_ref(xm, x_src, tap, weight)

    require_contiguous(xm=xm, x_src=x_src, tap=tap, weight=weight)
    if ci > _MAX_CI:
        raise ValueError(f"Ci={ci} exceeds the kernel's limit of {_MAX_CI}")
    out = torch.empty((v, co), dtype=torch.float32, device=weight.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.slot_conv_apply(
        ptr(xm), ptr(x_src), ptr(tap), ptr(weight), ptr(out),
        v, h, ci, co, k_taps, _DTYPES[weight.dtype], stream(),
    ))
    return out
