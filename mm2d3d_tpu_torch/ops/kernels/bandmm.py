"""K1: slot-compacted sparse convolution apply.

Port of `mm2d3d_tpu/ops/pallas/bandmm.py::slot_conv_apply` (forward only):

    out[v] = sum_h [0 <= tap[h, v] < K] x_src[h, v] @ W[tap[h, v]]
             (+ xm[v] @ W[13])                       -> (V, Co) fp32

CUDA kernel: `mm2d3d_tpu_torch/csrc/bandmm.cu`; plain version:
`slot_conv_apply_ref`.  bf16 with Ci % 8 == 0 runs on tensor cores as the
product E @ W of the TPU's banded matrix E, built band by band in shared
memory from the slot rows (`band_sources` states which row feeds which
band), with the bands split into groups where the voxel tiles alone would
leave SMs idle (`apply_plan`, K6's `tapsum_plan`); the groups' fp32
partials go to a scratch the wrapper allocates and are summed in a fixed
order.  fp32 and Ci % 8 != 0 run on CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)
from .tapsum import TapsumPlan, scratch_shape, tapsum_plan, tensor_cores

CENTER = 13
_MAX_CI = 512  # the CUDA-core kernel stages 16 * Ci fp32 per block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TC_SLOTS = 64  # csrc/bandsel.cuh: a slot id fits a signed char
MAX_TC_TAPS = 32  # csrc/bandsel.cuh: a row's taken bands fit a 32-bit mask
_SIMT_PLAN = TapsumPlan(1, 16, 128)  # csrc/bandmm.cu: kVT, kCT * kCPT


def _bind(lib):
    lib.slot_conv_apply.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p,
    ]
    lib.slot_conv_apply.restype = ctypes.c_int


KERNEL = register(Kernel(
    "bandmm", ("bandmm.cu", "common.cuh", "mma.cuh", "bandsel.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/pallas/bandmm.py:87",
))


def slot_tensor_cores(dtype: torch.dtype, ci: int, h: int, k: int) -> bool:
    """The route of K1 and K2: K6's (`tapsum.tensor_cores`: bf16 rows of
    whole 16-byte chunks) where the slots and taps also fit the band
    table, CUDA cores otherwise (fp32; the input conv's Ci = 3)."""
    return tensor_cores(dtype, ci) and h <= MAX_TC_SLOTS and k <= MAX_TC_TAPS


def apply_plan(k: int, v: int, h: int, ci: int, co: int,
               dtype: torch.dtype = torch.bfloat16) -> TapsumPlan:
    """(splits, voxels, channels) per block: on tensor cores K6's plan for
    the same GEMM (V x K * Ci) @ (K * Ci x Co), the splits cutting the
    bands into groups; on CUDA cores one unsplit tile of 16 voxels by 128
    channels."""
    if not slot_tensor_cores(dtype, ci, h, k):
        return _SIMT_PLAN
    return tapsum_plan(k, v, ci, co, dtype)


def band_sources(tap: Optional[torch.Tensor], k_taps: int, v: int,
                 with_xm: bool) -> torch.Tensor:
    """The tensor-core kernels' selection rule (`csrc/bandsel.cuh`), in plain
    PyTorch: sel (P, K, V) int64, the band table of each of the P passes.
    sel[p, k, v] is the slot h that feeds band k of row v of E in pass p:
    the (p + 1)-th slot, in slot order, whose tap is k; H for the masked
    centre, which is band 13's first source; -1 for none.  Real tables hold
    each tap once per row and never 13: one pass."""
    h = 0 if tap is None else tap.shape[0]
    cols = torch.arange(v)
    seen = torch.zeros((k_taps, v), dtype=torch.int64)  # sources so far
    found = []  # (pass, band, column, slot)
    if with_xm:
        found.append((torch.zeros(v, dtype=torch.int64),
                      torch.full((v,), CENTER), cols, torch.full((v,), h)))
        seen[CENTER] = 1
    for s in range(h):
        t = tap[s].long().cpu()
        ok = (t >= 0) & (t < k_taps)
        tc, c = t[ok], cols[ok]
        found.append((seen[tc, c].clone(), tc, c, torch.full_like(c, s)))
        seen[tc, c] += 1
    passes = max(1, int(seen.max()) if seen.numel() else 1)
    sel = torch.full((passes, k_taps, v), -1, dtype=torch.int64)
    for p, t, c, s in found:
        sel[p, t, c] = s
    return sel


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
    plan = apply_plan(k_taps, v, h, ci, co, weight.dtype)
    if slot_tensor_cores(weight.dtype, ci, h, k_taps):
        if any(t is not None and t.data_ptr() % 16 for t in (xm, x_src, weight)):
            raise ValueError("xm, x_src and weight must be 16-byte aligned (cp.async)")
    elif ci > _MAX_CI:
        raise ValueError(f"Ci={ci} exceeds the CUDA-core kernel's limit of {_MAX_CI}")
    out = torch.empty((v, co), dtype=torch.float32, device=weight.device)
    scratch = (torch.empty(scratch_shape(plan, v, co), dtype=torch.float32,
                           device=weight.device) if plan.splits > 1 else None)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.slot_conv_apply(
        ptr(xm), ptr(x_src), ptr(tap), ptr(weight), ptr(out), ptr(scratch),
        v, h, ci, co, k_taps, _DTYPES[weight.dtype], *plan, stream(),
    ))
    return out
