"""K6: dense 27-tap contraction of the submanifold convolution.

Port of `mm2d3d_tpu/ops/pallas/tapsum.py::tapsum`:

    out[v] = sum_k g[k, v] @ w[k]                         -> (V, Co) fp32

for the gathered neighbourhoods `g (K, V, Ci)` of the dense 27-tap path
(`ops.spconv._SubmDense`, forward and input gradient).  CUDA kernel:
`mm2d3d_tpu_torch/csrc/tapsum.cu`; plain version: `tapsum_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    lib.tapsum.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p,
    ]
    lib.tapsum.restype = ctypes.c_int


KERNEL = register(Kernel(
    "tapsum", ("tapsum.cu", "common.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/pallas/tapsum.py:42",
))


def tapsum_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the per-tap products summed over the taps, in
    fp32 (bf16 products are exact in fp32), as `_xla_tapsum`."""
    return torch.einsum("kvi,kio->vo", g.float(), w.float())


def tapsum(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k g[k] @ w[k] -> (V, Co) fp32.

    Args:
      g: (K, V, Ci) gathered tap rows, fp32 or bf16; any V and Ci.
      w: (K, Ci, Co) tap weights, the same dtype.
    """
    if g.dim() != 3 or w.dim() != 3 or g.shape[0] != w.shape[0] \
            or g.shape[2] != w.shape[1]:
        raise ValueError(f"g {tuple(g.shape)} vs w {tuple(w.shape)}")
    if g.dtype != w.dtype:
        raise TypeError(f"g {g.dtype} != w {w.dtype}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {g.dtype}")
    no_grad_inputs(g, w)
    if not on_cuda(g, w):
        return tapsum_ref(g, w)

    require_contiguous(g=g, w=w)
    k_taps, v, ci = g.shape
    co = w.shape[2]
    out = torch.empty((v, co), dtype=torch.float32, device=g.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.tapsum(
        ptr(g), ptr(w), ptr(out), k_taps, v, ci, co, _DTYPES[g.dtype], stream(),
    ))
    return out
