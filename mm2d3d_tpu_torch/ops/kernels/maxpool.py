"""K4: 3x3 stride-2 pad-1 max pool over NHWC (the ResNet stem pool).

Port of `mm2d3d_tpu/ops/pallas/maxpool.py::maxpool3x3s2`.  CUDA kernel:
`mm2d3d_tpu_torch/csrc/maxpool.cu`; plain version: `maxpool3x3s2_ref`.
`MaxPool3x3s2` is the differentiable form: K4 forward, and the backward the
JAX package gives its Pallas pool, which is not a Pallas kernel but XLA's
select-and-scatter (`jax.vjp` of `_ref_pool`): here PyTorch's own max-pool
backward on the saved input, which also routes each gradient to the first
maximum of its window.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    lib.maxpool3x3s2.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p,
    ]
    lib.maxpool3x3s2.restype = ctypes.c_int


KERNEL = register(Kernel(
    "maxpool", ("maxpool.cu", "common.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/pallas/maxpool.py:51",
))


def maxpool3x3s2_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (torch MaxPool2d(3, 2, 1)), NHWC in and out."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) NHWC-contiguous -> (B, ceil(H/2), ceil(W/2), C).

    The kernel reads 8 channels as one 16-byte vector: on a CUDA tensor, C
    must be a multiple of 8 and the data 16-byte aligned."""
    if x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    no_grad_inputs(x)
    if not on_cuda(x):
        return maxpool3x3s2_ref(x)

    require_contiguous(x=x)
    b, h, w, c = x.shape
    if c % 8 != 0:
        raise ValueError(f"channel count must be a multiple of 8, got {c}")
    if x.data_ptr() % 16 != 0:
        raise ValueError("x must be 16-byte aligned")
    y = torch.empty((b, (h + 1) // 2, (w + 1) // 2, c), dtype=x.dtype,
                    device=x.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.maxpool3x3s2(
        ptr(x), ptr(y), b, h, w, c, _DTYPES[x.dtype], stream(),
    ))
    return y


class MaxPool3x3s2(torch.autograd.Function):
    """`maxpool3x3s2` with a gradient: K4 forward on the detached
    NHWC-contiguous input; the backward is autograd of the plain version on
    the saved input, which finds each window's first maximum again from x,
    as select-and-scatter does."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return maxpool3x3s2(x.detach())

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            (dx,) = torch.autograd.grad(maxpool3x3s2_ref(xd), xd, g)
        return dx
