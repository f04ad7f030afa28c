"""K6: dense 27-tap contraction of the submanifold convolution.

Port of `mm2d3d_tpu/ops/pallas/tapsum.py::tapsum`:

    out[v] = sum_k g[k, v] @ w[k]                         -> (V, Co) fp32

for the gathered neighbourhoods `g (K, V, Ci)` of the dense 27-tap path
(`ops.spconv._SubmDense`, forward and input gradient).  CUDA kernel:
`mm2d3d_tpu_torch/csrc/tapsum.cu`; plain version: `tapsum_ref`.

bf16 with Ci % 8 == 0 runs on tensor cores, with the taps split into
groups where the voxel tiles alone would leave SMs idle (`tapsum_plan`);
the groups' fp32 partials go to a scratch the wrapper allocates and are
summed in a fixed order, so the result is the same from call to call.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132  # streaming multiprocessors of an H100 SXM
_TC_BMS = (128, 64)  # voxels per tensor-core block, the tiles of csrc/tapsum.cu
_TC_MAX_BN = 128  # output channels per tensor-core block, at most
_SIMT_BM = 32  # voxels per CUDA-core block (csrc/tapsum.cu kBV)


def _bind(lib):
    lib.tapsum.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p,
    ]
    lib.tapsum.restype = ctypes.c_int


KERNEL = register(Kernel(
    "tapsum", ("tapsum.cu", "common.cuh", "mma.cuh"), _bind,
    replaces="mm2d3d_tpu/ops/pallas/tapsum.py:42",
))


class TapsumPlan(NamedTuple):
    splits: int  # tap groups (grid z); 1 = no split
    bm: int  # voxels per block
    bn: int  # output channels per block


def tensor_cores(dtype: torch.dtype, ci: int) -> bool:
    """The kernel's route: tensor cores for bf16 rows of whole 16-byte
    chunks (Ci % 8 == 0), CUDA cores otherwise (fp32; the input conv's
    Ci = 3)."""
    return dtype == torch.bfloat16 and ci % 8 == 0


def tapsum_plan(k: int, v: int, ci: int, co: int,
                dtype: torch.dtype = torch.bfloat16) -> TapsumPlan:
    """Blocks of the launch: `bm` voxels x `bn` output channels, times
    `splits` tap groups.  On tensor cores bn is Co in 8-wide tiles, an
    even number of them, spread evenly over ceil(Co / 128) column blocks.
    bm is 128 where those tiles alone give the card's SMs a block each
    (long V: fewer, longer blocks moved the bytes faster on the H100), else
    64, and then the taps are split into the fewest groups that give every
    SM a block, when the tiles alone do not (the deep levels)."""
    if not tensor_cores(dtype, ci):
        return TapsumPlan(1, _SIMT_BM, 16 if co <= 16 else 32)
    bn = column_tile(co)
    n_col = -(-co // bn)
    big, small = _TC_BMS
    if -(-v // big) * n_col >= SMS:
        return TapsumPlan(1, big, bn)
    blocks = -(-v // small) * n_col
    splits = min(k, -(-SMS // blocks)) if blocks > 0 else 1
    return TapsumPlan(splits, small, bn)


def column_tile(co: int) -> int:
    """Output channels per tensor-core block: Co in 8-wide tiles, an even
    number of them, spread evenly over ceil(Co / 128) column blocks."""
    tiles8 = max(1, -(-co // 8))
    n_col = -(-tiles8 // (_TC_MAX_BN // 8))
    nt = -(-tiles8 // n_col)
    return 8 * (nt + nt % 2)


def tap_groups(k: int, splits: int) -> List[Tuple[int, int]]:
    """The taps [t0, t1) of each split, as the kernel cuts them."""
    return [(s * k // splits, (s + 1) * k // splits) for s in range(splits)]


def scratch_shape(plan: TapsumPlan, v: int, co: int) -> Tuple[int, ...]:
    """The fp32 partials the wrapper allocates: (splits, V, Co), or
    nothing without a split."""
    return (plan.splits, v, co) if plan.splits > 1 else (0,)


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
    plan = tapsum_plan(k_taps, v, ci, co, g.dtype)
    if tensor_cores(g.dtype, ci) and (g.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("g and w must be 16-byte aligned (cp.async)")
    out = torch.empty((v, co), dtype=torch.float32, device=g.device)
    scratch = torch.empty(scratch_shape(plan, v, co), dtype=torch.float32,
                          device=g.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.tapsum(
        ptr(g), ptr(w), ptr(out), ptr(scratch) if plan.splits > 1 else None,
        k_taps, v, ci, co, _DTYPES[g.dtype], *plan, stream(),
    ))
    return out
