"""The 2D branch's train-form BatchNorm with its epilogue, as one kernel pair
each way.

Replaces no `pallas_call`: it stands for flax's `nn.BatchNorm` in train
mode (`mm2d3d_tpu/models/resnet2d.py:61`, `net2d.py:124`, `:143`), which XLA
fuses on the TPU, with the caller's ReLU or residual add and ReLU after it.
CUDA kernels: `mm2d3d_tpu_torch/csrc/batchnorm2d.cu`; plain versions:
`stats_ref`, `apply_ref`, `grad_sums_ref`, `grad_apply_ref`.

`BatchNormTrain` is the differentiable form.  Forward: `bn_stats` (batch
mean and variance in flax's form, E[x^2] - E[x]^2 clipped at 0, the running
statistics moved in place) and `bn_apply` (y = (x - mean) * scale + bias,
then nothing, a ReLU, or + identity and a ReLU; a bit per element says
where the ReLU passed).  Backward: `bn_grad_sums` (per channel, sum(g) and
sum(g (x - mean)) for g = dy masked by those bits: dbias, dweight and dx's
coefficients) and `bn_grad_apply` (dx in x's type, and d(identity) = g).
It saves x as it came (bf16 on the main path), the (4, C) statistics and
the bits.  Four launches per BatchNorm and train step.

The tensors are NCHW with NHWC memory (`torch.channels_last`): each
pixel's channels contiguous, pixels a row stride apart (`row_stride`), so a
channel slice of a wider tensor, such as one stem's half of the fused
stems' output, is read in place.  The sums run on a grid of `sum_plan(M,
C)`; the applies on `apply_plan(M, C)`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import Kernel, no_grad_inputs, on_cuda, ptr, register, stream
from .tapsum import SMS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {(False, False): 0, (True, False): 1, (True, True): 2}  # (relu, identity)
VEC = 8  # channels per thread: one 16-byte bf16 vector (csrc kVec)
TILE = 64  # channels per block of the sums (csrc kTileVecs * kVec)
SUM_ROW_LANES = 32  # rows a sum block reads at a time (csrc kRowLanes)
SUM_UNROLL = 4  # rows in flight per thread of a sum block (csrc kUnroll)
SUM_BLOCKS = 3 * SMS  # sum blocks to aim for: one wave, three per SM
APPLY_THREADS = 256  # at most, per apply block (csrc kApplyThreads)
APPLY_BLOCKS_PER_SM = 8
MAX_C = VEC * APPLY_THREADS  # one apply block must hold a whole row
LAUNCHES_PER_CALL = 4  # bn_stats and bn_apply forward, the two grads backward


def _bind(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.bn_stats.argtypes = [p, ll, i, ll, i, i, i, p, p, p, p, p, p, f, f, f, p]
    lib.bn_apply.argtypes = [i, p, ll, i, p, ll, p, i, p, p, p, ll, i, i, i, p]
    lib.bn_grad_sums.argtypes = [p, ll, i, p, ll, i, p, ll, i, i, i, p, p, p, p, p, p]
    lib.bn_grad_apply.argtypes = [i, p, ll, i, p, ll, i, p, p, p, p, p, ll, i, i, i, p]
    for fn in (lib.bn_stats, lib.bn_apply, lib.bn_grad_sums, lib.bn_grad_apply):
        fn.restype = ctypes.c_int


KERNEL = register(Kernel(
    "batchnorm2d", ("batchnorm2d.cu", "common.cuh"), _bind,
    replaces="mm2d3d_tpu/models/resnet2d.py:61",
))


class SumPlan(NamedTuple):
    blocks: int  # P: row blocks per channel tile, the partial rows summed last
    rows: int  # rows per block, a multiple of SUM_ROW_LANES
    tiles: int  # 64-channel tiles (grid y)


def sum_plan(m: int, c: int) -> SumPlan:
    """The sums' grid for M rows of C channels: about SUM_BLOCKS blocks in
    all, each given at least one unrolled pass of rows."""
    tiles = -(-c // TILE)
    p = max(1, min(-(-SUM_BLOCKS // tiles), -(-m // (SUM_ROW_LANES * SUM_UNROLL))))
    rows = -(-m // p)
    rows = -(-rows // SUM_ROW_LANES) * SUM_ROW_LANES
    return SumPlan(-(-m // rows), rows, tiles)


class ApplyPlan(NamedTuple):
    blocks: int
    rows_per_iter: int  # rows a block covers at a time: threads = C / 8 * this


def apply_plan(m: int, c: int) -> ApplyPlan:
    """The applies' grid: each thread keeps one 8-channel group, a block
    takes as many whole rows as fit in APPLY_THREADS, and the grid is the
    blocks the SMs hold at once (each block strides over the rows)."""
    vpr = c // VEC
    rpi = max(1, APPLY_THREADS // vpr)
    per_sm = max(1, 2048 // (vpr * rpi))
    return ApplyPlan(max(1, min(-(-m // rpi), SMS * min(per_sm, APPLY_BLOCKS_PER_SM))),
                     rpi)


def row_stride(t: torch.Tensor) -> Optional[int]:
    """The row stride ld of an NCHW tensor whose pixels each hold their C
    channels contiguously, pixels ld elements apart in (n, h, w) order;
    None for any other layout."""
    b, c, h, w = t.shape
    sb, sc, sh, sw = t.stride()
    ld = sw if w > 1 else sh if h > 1 else sb if b > 1 else c
    ok = ((c == 1 or sc == 1) and ld >= c and (w == 1 or sw == ld)
          and (h == 1 or sh == w * ld) and (b == 1 or sb == h * w * ld))
    return ld if ok else None


def _rows(t: torch.Tensor, name: str) -> int:
    """t's row stride for the kernels, which read 16-byte vectors: raises
    for another layout or an unaligned pointer or stride."""
    ld = row_stride(t)
    if ld is None:
        raise ValueError(f"{name} must be NCHW in channels_last (NHWC) memory, "
                         f"got strides {t.stride()} for shape {tuple(t.shape)}")
    if t.data_ptr() % 16 or (ld * t.element_size()) % 16:
        raise ValueError(f"{name} must be 16-byte aligned with a 16-byte row stride")
    return ld


def _nhwc(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient as the kernels read it: x's shape, fp32 or x's dtype;
    autograd may hand over another layout, which is copied to
    channels_last."""
    if t.shape != x.shape or t.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"gradient {t.dtype} {tuple(t.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    ld = row_stride(t)
    if ld is None or t.data_ptr() % 16 or (ld * t.element_size()) % 16:
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _check(x: torch.Tensor) -> Tuple[int, int]:
    """(M, C) of a CUDA input the kernels take; raises for anything else."""
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    b, c, h, w = x.shape
    if c % VEC or c > MAX_C:
        raise ValueError(f"channel count must be a multiple of {VEC} up to {MAX_C}, got {c}")
    if b * h * w == 0:
        raise ValueError("BatchNorm over no pixels")
    return b * h * w, c


def _per_channel(c: int, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 ({c},) tensor")


# One zeroed counter row per (device, stream): the last block of each sum
# kernel finds itself through it and sets it back to zero, so kernels in
# one stream's order share it.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counter(dev: torch.device) -> torch.Tensor:
    key = (dev.index, stream())
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(MAX_C // TILE, dtype=torch.int32, device=dev)
    return _COUNTERS[key]


# --------------------------------------------------------------------------
# plain versions (the CPU route)
# --------------------------------------------------------------------------

def _pc(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def stats_ref(x, weight, running_mean, running_var, eps, momentum):
    """The eager train-form statistics: (4, C) fp32 rows mean, rstd, scale
    (rstd * weight) and keep (1 where the raw variance is >= 0); the
    running statistics moved in place as 0.9 old + 0.1 batch."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    raw = (xf * xf).mean((0, 2, 3)) - mean * mean
    var = torch.clamp(raw, min=0.0)
    running_mean.mul_(momentum).add_((1 - momentum) * mean)
    running_var.mul_(momentum).add_((1 - momentum) * var)
    rstd = torch.rsqrt(var + eps)
    return torch.stack([mean, rstd, rstd * weight, (raw >= 0).float()])


def apply_ref(x, stats, bias, identity, relu, out_dtype):
    """(y, mask): y = (x - mean) * scale + bias [+ identity] [ReLU] in fp32,
    then in out_dtype; mask (bool, x's shape) where the ReLU passed, None
    without one."""
    y = (x.float() - _pc(stats[0])) * _pc(stats[2]) + _pc(bias)
    if identity is not None:
        y = y + identity
    mask = None
    if relu:
        mask = ~(y <= 0)
        y = torch.relu(y)
    return y.to(out_dtype), mask


def _masked(dy: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    g = dy.float()
    return g if mask is None else torch.where(mask, g, torch.zeros((), device=g.device))


def grad_sums_ref(dy, x, mask, stats, weight):
    """(5, C) fp32 rows dweight, dbias and dx's a, b, c in
    dx = a g + b (x - mean) + c (the analytic gradient through flax's
    variance; b is 0 in a channel whose raw variance was clipped)."""
    g = _masked(dy, mask)
    s = g.sum((0, 2, 3))
    q = (g * (x.float() - _pc(stats[0]))).sum((0, 2, 3))
    m = g.numel() // g.shape[1]
    rstd, keep = stats[1], stats[3]
    wr = weight * rstd
    return torch.stack([q * rstd, s, wr, -wr * rstd * rstd * keep * q / m, -wr * s / m])


def grad_apply_ref(dy, x, mask, stats, coef, residual):
    """(dx in x's dtype, d(identity) = g in fp32 or None)."""
    g = _masked(dy, mask)
    dx = _pc(coef[2]) * g + _pc(coef[3]) * (x.float() - _pc(stats[0])) + _pc(coef[4])
    return dx.to(x.dtype), (g if residual else None)


def unpack_mask(bits: torch.Tensor, shape) -> torch.Tensor:
    """The kernels' ReLU bits, (M, C / 8) uint8 with bit j of byte v for
    channel 8 v + j, as the plain versions' bool mask of NCHW `shape` (a
    bool mask, the plain versions' own, comes back as it is)."""
    if bits.dtype == torch.bool:
        return bits
    n, c, h, w = shape
    shifts = torch.arange(VEC, dtype=torch.uint8, device=bits.device)
    flat = ((bits[..., None] >> shifts) & 1).bool().reshape(n, h, w, c)
    return flat.permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# wrappers: a CPU tensor takes the plain version, a CUDA tensor the kernel
# --------------------------------------------------------------------------

def bn_stats(x: torch.Tensor, weight: torch.Tensor, running_mean: torch.Tensor,
             running_var: torch.Tensor, eps: float, momentum: float) -> torch.Tensor:
    """(4, C) mean, rstd, scale, keep of x (N, C, H, W); moves the running
    statistics in place."""
    no_grad_inputs(x, weight)
    if not on_cuda(x, weight, running_mean, running_var):
        return stats_ref(x, weight, running_mean, running_var, eps, momentum)
    m, c = _check(x)
    ldx = _rows(x, "x")
    _per_channel(c, weight=weight, running_mean=running_mean, running_var=running_var)
    plan = sum_plan(m, c)
    part = torch.empty((plan.blocks, c, 2), dtype=torch.float64, device=x.device)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.bn_stats(
        ptr(x), ldx, _DTYPES[x.dtype], m, c, plan.blocks, plan.rows, ptr(part),
        ptr(_counter(x.device)), ptr(weight), ptr(running_mean), ptr(running_var),
        ptr(stats), eps, momentum, 1 - momentum, stream(),
    ))
    return stats


def bn_apply(x: torch.Tensor, stats: torch.Tensor, bias: torch.Tensor,
             identity: Optional[torch.Tensor], relu: bool,
             out_dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, mask): y (N, C, H, W) channels_last in out_dtype (fp32, or x's
    dtype); mask where the ReLU passed (CUDA: (M, C / 8) uint8 bits), None
    without a ReLU.  An identity needs a ReLU after it."""
    mode = _MODES[(relu, identity is not None)]
    no_grad_inputs(x, bias, identity)
    if not on_cuda(x, stats, bias, identity):
        return apply_ref(x, stats, bias, identity, relu, out_dtype)
    m, c = _check(x)
    ldx = _rows(x, "x")
    _per_channel(c, bias=bias)
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"output dtype {out_dtype} for a {x.dtype} input")
    ldid = 0
    if identity is not None:
        if identity.dtype != torch.float32 or identity.shape != x.shape:
            raise ValueError("identity must be fp32 of x's shape")
        ldid = _rows(identity, "identity")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device,
                    memory_format=torch.channels_last)
    mask = (torch.empty((m, c // VEC), dtype=torch.uint8, device=x.device)
            if relu else None)
    plan = apply_plan(m, c)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.bn_apply(
        mode, ptr(x), ldx, _DTYPES[x.dtype], ptr(identity), ldid, ptr(y),
        _DTYPES[out_dtype], ptr(mask), ptr(stats), ptr(bias), m, c, plan.blocks,
        plan.rows_per_iter, stream(),
    ))
    return y, mask


def bn_grad_sums(dy: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor],
                 stats: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(5, C) dweight, dbias, a, b, c from the output gradient dy."""
    no_grad_inputs(dy, x, weight)
    if not on_cuda(dy, x, stats, weight):
        return grad_sums_ref(dy, x, mask, stats, weight)
    m, c = _check(x)
    dy = _nhwc(dy, x)
    plan = sum_plan(m, c)
    part = torch.empty((plan.blocks, c, 2), dtype=torch.float64, device=x.device)
    coef = torch.empty((5, c), dtype=torch.float32, device=x.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.bn_grad_sums(
        ptr(dy), row_stride(dy), _DTYPES[dy.dtype], ptr(x), _rows(x, "x"),
        _DTYPES[x.dtype], ptr(mask), m, c, plan.blocks, plan.rows, ptr(part),
        ptr(_counter(x.device)), ptr(weight), ptr(stats), ptr(coef), stream(),
    ))
    return coef


def bn_grad_apply(dy: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor],
                  stats: torch.Tensor, coef: torch.Tensor, residual: bool,
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx channels_last in x's dtype, d(identity) fp32 or None)."""
    no_grad_inputs(dy, x)
    if not on_cuda(dy, x, stats, coef):
        return grad_apply_ref(dy, x, mask, stats, coef, residual)
    m, c = _check(x)
    dy = _nhwc(dy, x)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                     memory_format=torch.channels_last)
    did = (torch.empty(x.shape, dtype=torch.float32, device=x.device,
                       memory_format=torch.channels_last) if residual else None)
    mode = _MODES[(mask is not None, residual)]
    plan = apply_plan(m, c)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.bn_grad_apply(
        mode, ptr(dy), row_stride(dy), _DTYPES[dy.dtype], ptr(x), _rows(x, "x"),
        _DTYPES[x.dtype], ptr(mask), ptr(stats), ptr(coef), ptr(dx), ptr(did), m, c,
        plan.blocks, plan.rows_per_iter, stream(),
    ))
    return dx, did


class BatchNormTrain(torch.autograd.Function):
    """Train-form BatchNorm with its epilogue: forward `bn_stats` and
    `bn_apply`, backward `bn_grad_sums` and `bn_grad_apply`.  Arguments: x,
    weight, bias, identity (or None), running_mean, running_var (moved in
    place), relu, out_dtype, eps, momentum."""

    @staticmethod
    def forward(ctx, x, weight, bias, identity, running_mean, running_var, relu,
                out_dtype, eps, momentum):
        stats = bn_stats(x, weight, running_mean, running_var, eps, momentum)
        y, mask = bn_apply(x, stats, bias, identity, relu, out_dtype)
        ctx.save_for_backward(x, weight, stats, mask)
        ctx.residual = identity is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats, mask = ctx.saved_tensors
        coef = bn_grad_sums(dy, x, mask, stats, weight)
        dx, did = bn_grad_apply(dy, x, mask, stats, coef, ctx.residual)
        return dx, coef[0], coef[1], did, None, None, None, None, None, None
