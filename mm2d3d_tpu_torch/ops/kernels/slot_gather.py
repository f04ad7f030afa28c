"""Slot-row gather of the sparse convolutions: out[..., n, :] = x[ids[..., n], :].

Replaces no Pallas kernel: it stands for XLA's `jnp.take` of the map padded
by `_pad_zero_row` in the JAX package's `ops/spconv.py`; the port's
`ops/spconv.py` calls it at every gather of its slot, neighbour, child and
parent tables, forward and backward.  CUDA kernel:
`mm2d3d_tpu_torch/csrc/slot_gather.cu` (its note gives the design); plain
version: `slot_gather_ref`.

An id outside [0, V) gives a row of zeros: the pad id V of every table and
the dumped parents, with no padded copy of x and no int64 copy of the ids.
x is read through its row stride, so a channel slice needs no copy.  The
kernel copies bytes, so it is exact in every type.
"""

from __future__ import annotations

import ctypes

import torch

from . import Kernel, no_grad_inputs, on_cuda, ptr, register, stream

VECTOR_BYTES = (16, 8, 4, 2, 1)  # the kernel's chunk widths, widest first


def _bind(lib):
    lib.slot_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.slot_gather.restype = ctypes.c_int


KERNEL = register(Kernel(
    "slot_gather", ("slot_gather.cu", "common.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/spconv.py:41",
))


def vector_bytes(row_bytes: int, stride_bytes: int, *addresses: int) -> int:
    """The kernel's chunk: the widest of `VECTOR_BYTES` that divides a row's
    bytes, the source's row stride and every address."""
    return next(w for w in VECTOR_BYTES
                if row_bytes % w == 0 and stride_bytes % w == 0
                and all(a % w == 0 for a in addresses))


def _check(x: torch.Tensor, ids: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (V, C), got {tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("x's channels must be contiguous (a row stride is fine)")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")


def slot_gather_ref(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x's rows at ids over a zero row appended at V,
    every id outside [0, V) sent to it."""
    v = x.shape[0]
    padded = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return padded[torch.where((ids >= 0) & (ids < v), ids, v).long()]


def slot_gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x (V, C), ids int32 of any shape -> (*ids.shape, C) in x's type:
    x[ids], zeros where an id is outside [0, V)."""
    _check(x, ids)
    no_grad_inputs(x)
    if not on_cuda(x, ids):
        return slot_gather_ref(x, ids)

    c = x.shape[1]
    out = torch.empty((*ids.shape, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    row_bytes = c * x.element_size()
    stride_bytes = x.stride(0) * x.element_size()
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.slot_gather(
        ptr(x), x.shape[0], stride_bytes, ptr(ids), ids.numel(), row_bytes,
        vector_bytes(row_bytes, stride_bytes, x.data_ptr(), out.data_ptr()),
        ptr(out), stream(),
    ))
    return out
