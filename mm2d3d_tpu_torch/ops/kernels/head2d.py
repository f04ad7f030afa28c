"""K5: the fused 2D head — composed 3x3 conv + bias, crop, 5x5 average pool.

Port of `mm2d3d_tpu/ops/pallas/head2d.py::head_pool`:

    y   = conv3x3_SAME(concat(inputs), w12) + b12      over the padded map
    y   = y[:, :h_real, :w_real]                       the crop
    out = avg_pool5x5(y), count_include_pad            -> (B, h_real, w_real, C2)

The three decoder-tail pieces are never concatenated.  CUDA kernel:
`mm2d3d_tpu_torch/csrc/head2d.cu`; plain version: `head_pool_ref`.
`HeadPool` is the differentiable form: K5 forward, and the backward the JAX
package gives its kernel, autograd of the plain version on the saved inputs
(`_head_pool_bwd` takes `jax.vjp` of `_head_pool_ref`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)

_STRIP = 16  # the TPU kernel's rows per grid step, kept in `supports`
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    lib.head_pool.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    lib.head_pool.restype = ctypes.c_int


KERNEL = register(Kernel(
    "head2d", ("head2d.cu", "common.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/pallas/head2d.py:75",
))


def supports(hp: int, wp: int, h_real: int, w_real: int, c2: int) -> bool:
    """The JAX package's static-shape conditions for the fused head (a copy
    of `head2d.supports`): `Net2DSeg(fused_head=True)` takes the fused head
    exactly where the JAX net's `pallas_head` does."""
    return (
        hp % _STRIP == 0
        and c2 >= 8
        and 0 < h_real <= hp
        and 0 < w_real <= wp
    )


def _shift_sum5(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of the 5 shifts -2..2 along `dim`, zeros outside (JAX's
    `shift_sum5`; layout-independent, unlike CUDA's avg_pool2d backward on
    channels_last input)."""
    n = t.shape[dim]
    pad = [0, 0] * (t.dim() - 1 - dim) + [2, 2]
    tp = F.pad(t, pad)
    out = tp.narrow(dim, 0, n)
    for d in range(1, 5):
        out = out + tp.narrow(dim, d, n)
    return out


def head_pool_ref(inputs: Sequence[torch.Tensor], w12: torch.Tensor,
                  b12: torch.Tensor, h_real: int, w_real: int,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version, a port of `_head_pool_ref`: the inputs and w12
    rounded to `compute_dtype` (default: the inputs' dtype), the conv summed
    in fp32 as the Pallas kernel sums it (bf16 products are exact in fp32),
    b12 added in fp32, the crop, the separable 5x5 box sum, / 25."""
    cd = compute_dtype or inputs[0].dtype
    x = torch.cat([p.permute(0, 3, 1, 2) for p in inputs], 1).to(cd).float()
    w = w12.to(cd).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x, w, padding=1) + b12.float()[None, :, None, None]
    y = y[:, :, :h_real, :w_real].permute(0, 2, 3, 1)  # (B, h, w, C2)
    return _shift_sum5(_shift_sum5(y, 1), 2) * (1.0 / 25.0)


def head_pool(inputs: Sequence[torch.Tensor], w12: torch.Tensor,
              b12: torch.Tensor, h_real: int, w_real: int,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused conv3x3 + bias + crop + 5x5 avg-pool -> (B, h_real, w_real, C2)
    fp32.

    Args:
      inputs: one to three (B, Hp, Wp, C_p) NHWC-contiguous pieces of the
        head's input, fp32 or bf16, all of one dtype.
      w12: (3, 3, sum C_p, C2) composed weights (HWIO); b12: (C2,).
      h_real, w_real: the crop, at most (Hp, Wp).
      compute_dtype: the type the inputs and w12 are rounded to before they
        multiply (default: the inputs' dtype); the sums are fp32.
    """
    inputs = list(inputs)
    if not 1 <= len(inputs) <= 3:
        raise ValueError(f"1 to 3 input pieces, got {len(inputs)}")
    b, hp, wp = inputs[0].shape[:3]
    cins = [p.shape[-1] for p in inputs]
    for p in inputs:
        if p.dim() != 4 or tuple(p.shape[:3]) != (b, hp, wp):
            raise ValueError(f"piece {tuple(p.shape)} vs (B, Hp, Wp) = {(b, hp, wp)}")
        if p.dtype != inputs[0].dtype:
            raise TypeError(f"pieces of several dtypes: {p.dtype}, {inputs[0].dtype}")
    if inputs[0].dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {inputs[0].dtype}")
    c2 = w12.shape[-1]
    if tuple(w12.shape) != (3, 3, sum(cins), c2) or tuple(b12.shape) != (c2,):
        raise ValueError(f"w12 {tuple(w12.shape)} / b12 {tuple(b12.shape)} vs "
                         f"{sum(cins)} input channels")
    if not (0 <= h_real <= hp and 0 <= w_real <= wp):
        raise ValueError(f"crop {(h_real, w_real)} outside {(hp, wp)}")
    cd = compute_dtype or inputs[0].dtype
    if cd not in _DTYPES:
        raise TypeError(f"unsupported compute dtype {cd}")
    no_grad_inputs(*inputs, w12, b12)
    if not on_cuda(*inputs, w12, b12):
        return head_pool_ref(inputs, w12, b12, h_real, w_real, cd)

    require_contiguous(**{f"inputs[{i}]": p for i, p in enumerate(inputs)})
    dev = inputs[0].device
    w = w12.to(cd).float().contiguous()
    bias = b12.float().contiguous()
    scratch = torch.empty((b, h_real, w_real, c2), dtype=torch.float32, device=dev)
    out = torch.empty_like(scratch)
    xs = inputs + [None] * (3 - len(inputs))
    cs = cins + [0] * (3 - len(inputs))
    round_bf16 = int(cd == torch.bfloat16 and inputs[0].dtype == torch.float32)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.head_pool(
        *(ptr(x) for x in xs), *cs, ptr(w), ptr(bias), ptr(scratch), ptr(out),
        b, hp, wp, h_real, w_real, c2, _DTYPES[inputs[0].dtype], round_bf16,
        stream(),
    ))
    return out


class HeadPool(torch.autograd.Function):
    """`head_pool` with a gradient: K5 forward; the backward differentiates
    the plain version on the saved inputs, as `_head_pool_bwd` takes the
    vjp of `_head_pool_ref`.

        HeadPool.apply(h_real, w_real, compute_dtype, w12, b12, *inputs)
    """

    @staticmethod
    def forward(ctx, h_real, w_real, compute_dtype, w12, b12, *inputs):
        ctx.save_for_backward(w12, b12, *inputs)
        ctx.args = (h_real, w_real, compute_dtype)
        return head_pool(inputs, w12, b12, h_real, w_real, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        h_real, w_real, cd = ctx.args
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = head_pool_ref(leaves[2:], leaves[0], leaves[1], h_real, w_real, cd)
            grads = torch.autograd.grad(out, leaves, g)
        return (None, None, None, *grads)
