"""K5: the fused 2D head — composed 3x3 conv + bias, crop, 5x5 average pool.

Port of `mm2d3d_tpu/ops/pallas/head2d.py::head_pool`:

    y   = conv3x3_SAME(concat(inputs), w12) + b12      over the padded map
    y   = y[:, :h_real, :w_real]                       the crop
    out = avg_pool5x5(y), count_include_pad            -> (B, h_real, w_real, C2)

The three decoder-tail pieces are never concatenated.  CUDA kernel:
`mm2d3d_tpu_torch/csrc/head2d.cu` (bf16 compute on tensor cores, fp32 on
CUDA cores); plain version: `head_pool_ref`.
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
# padded input channels whose bf16 weights (9 x Kp x 16 x 2 B) fit in a
# block's shared memory beside the two halo buffers (csrc/head2d.cu)
_MAX_KP = 640


def _bind(lib):
    lib.head_pool.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.head_pool.restype = ctypes.c_int


KERNEL = register(Kernel(
    "head2d", ("head2d.cu", "common.cuh", "mma.cuh"), _bind,
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


def _check(inputs: Sequence[torch.Tensor], w12: torch.Tensor, b12: torch.Tensor,
           h_real: int, w_real: int,
           compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """Validate `head_pool`'s arguments; returns the compute dtype."""
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
    return cd


def pack_weights(w12: torch.Tensor, cins: Sequence[int]) -> torch.Tensor:
    """w12 (3, 3, sum C_p, C2) -> bf16 (ceil(C2 / 16), 9, Kp, 16), the
    tensor-core pass's layout: each piece's channels zero-padded to a
    multiple of 16 (Kp their sum), the output channels to 16 per block."""
    c2 = w12.shape[-1]
    n_oc = -(-c2 // 16)
    wb = w12.to(torch.bfloat16)
    if all(c % 16 == 0 for c in cins):  # the flagship's 3 x 64: one pad
        w = F.pad(wb, (0, 16 * n_oc - c2))
    else:
        parts, c0 = [], 0
        for c in cins:
            parts.append(F.pad(wb[:, :, c0:c0 + c], (0, 16 * n_oc - c2, 0, (-c) % 16)))
            c0 += c
        w = torch.cat(parts, 2)
    kp = w.shape[2]
    return w.reshape(9, kp, n_oc, 16).permute(2, 0, 1, 3).contiguous()


def launch_passes(inputs: Sequence[torch.Tensor], w12: torch.Tensor,
                  b12: torch.Tensor, h_real: int, w_real: int, cd: torch.dtype,
                  passes: int = 3, y: Optional[torch.Tensor] = None):
    """Launch K5 on CUDA pieces (checked by `head_pool`): pass 1 (conv +
    bias + crop into the fp32 scratch `y`) and/or pass 2 (the 5x5 pool of
    `y`), `passes` = 1, 2 or 3.  Returns (y, out); `out` is written by pass
    2 only.  Counts one launch per call.  bf16 compute runs pass 1 on
    tensor cores, fp32 on CUDA cores."""
    inputs = list(inputs)
    require_contiguous(**{f"inputs[{i}]": p for i, p in enumerate(inputs)})
    b, hp, wp = inputs[0].shape[:3]
    cins = [p.shape[-1] for p in inputs]
    c2 = w12.shape[-1]
    dev = inputs[0].device
    tensor_cores = cd == torch.bfloat16
    if tensor_cores:
        w = pack_weights(w12, cins)
        if w.shape[2] > _MAX_KP:
            raise ValueError(f"{w.shape[2]} padded input channels: the weights "
                             f"outgrow shared memory (at most {_MAX_KP})")
    else:
        w = w12.float().contiguous()
    bias = b12.float().contiguous()
    if y is None:
        y = torch.empty((b, h_real, w_real, c2), dtype=torch.float32, device=dev)
    out = torch.empty_like(y)
    xs = inputs + [None] * (3 - len(inputs))
    cs = cins + [0] * (3 - len(inputs))
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.head_pool(
        *(ptr(x) for x in xs), *cs, ptr(w), ptr(bias), ptr(y), ptr(out),
        b, hp, wp, h_real, w_real, c2, _DTYPES[inputs[0].dtype],
        int(tensor_cores), passes, stream(),
    ))
    return y, out


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
    cd = _check(inputs, w12, b12, h_real, w_real, compute_dtype)
    no_grad_inputs(*inputs, w12, b12)
    if not on_cuda(*inputs, w12, b12):
        return head_pool_ref(inputs, w12, b12, h_real, w_real, cd)
    return launch_passes(inputs, w12, b12, h_real, w_real, cd)[1]


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
