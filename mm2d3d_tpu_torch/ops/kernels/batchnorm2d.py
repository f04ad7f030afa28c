"""The train-form BatchNorm with its epilogue, as one kernel pair each way:
the 2D branch's over NHWC pixels and, with a row mask, the 3D branch's over
the valid voxel rows.

Replaces no `pallas_call`: it stands for flax's `nn.BatchNorm` in train
mode (`mm2d3d_tpu/models/resnet2d.py:61`, `net2d.py:124`, `:143`) and the
sparse U-Net's masked BatchNorm (`mm2d3d_tpu/models/sparse_unet.py`), which
XLA fuses on the TPU, with the caller's ReLU or residual add and ReLU after
it.  CUDA kernels: `mm2d3d_tpu_torch/csrc/batchnorm2d.cu`; plain versions:
`stats_ref` (the masked form's `masked_stats_ref`), `apply_ref`,
`grad_sums_ref`, `grad_apply_ref`.

`BatchNormTrain` is the differentiable form.  Forward: `bn_stats` (batch
mean and variance in flax's form, E[x^2] - E[x]^2 clipped at 0, the running
statistics moved in place) and `bn_apply` (y = (x - mean) * scale + bias,
then nothing, a ReLU, or + identity and a ReLU; a bit per element says
where the ReLU passed).  Backward: `bn_grad_sums` (per channel, sum(g) and
sum(g (x - mean)) for g = dy masked by those bits: dbias, dweight and dx's
coefficients) and `bn_grad_apply` (dx in x's type, and d(identity) = g).
It saves x as it came (bf16 on the main path), the (4, C) statistics and
the bits.  Four launches per BatchNorm and train step.

The masked form (`valid`, a (V,) bool row mask, given to the four passes):
the statistics over the valid rows only, n = max(sum(valid), 1) of them,
counted on the device, and the variance as the sparse U-Net's two-pass
eager form gives it (a sum of squares: no clamp, keep 1); the statistics
gain a fifth row, n.  The apply covers every row.  The gradient's sums run
over every row too (y depends on the weight, the bias and the statistics at
each row), and dx's mean and variance terms fall at the valid rows only.
The plain versions of the masked form are the eager masked form's own ops:
the two-pass mean and variance of `masked_stats_ref` and y = (x - mean) *
rstd * weight + bias in that order (`apply_ref` given `weight`).

The tensors are NCHW with NHWC memory (`torch.channels_last`): each
pixel's channels contiguous, pixels a row stride apart (`row_stride`), so a
channel slice of a wider tensor, such as one stem's half of the fused
stems' output, is read in place; or (V, C) rows, channels contiguous.  The
sums run on a grid of `sum_plan(M, C)`; the applies on `apply_plan(M, C)`.
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
    lib.bn_stats.argtypes = [p, ll, i, ll, i, i, i, p, p, p, p, p, p, f, f, f, p, p, p]
    lib.bn_apply.argtypes = [i, p, ll, i, p, ll, p, i, p, p, p, ll, i, i, i, p]
    lib.bn_grad_sums.argtypes = [p, ll, i, p, ll, i, p, ll, i, i, i, p, p, p, p, p, i, p]
    lib.bn_grad_apply.argtypes = [i, p, ll, i, p, ll, i, p, p, p, p, p, ll, i, i, i, p, p]
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
    channels contiguously, pixels ld elements apart in (n, h, w) order, or
    of (M, C) rows whose channels are contiguous; None for any other
    layout."""
    if t.dim() == 2:
        m, c = t.shape
        ld = t.stride(0) if m > 1 else c
        return ld if (c == 1 or t.stride(1) == 1) and ld >= c else None
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
        raise ValueError(f"{name} must be NCHW in channels_last (NHWC) memory or "
                         f"(M, C) rows, got strides {t.stride()} for shape "
                         f"{tuple(t.shape)}")
    if t.data_ptr() % 16 or (ld * t.element_size()) % 16:
        raise ValueError(f"{name} must be 16-byte aligned with a 16-byte row stride")
    return ld


def _like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An empty tensor of x's shape in the kernels' layout: channels_last
    for NCHW, contiguous rows for (M, C)."""
    if x.dim() == 2:
        return torch.empty(x.shape, dtype=dtype, device=x.device)
    return torch.empty(x.shape, dtype=dtype, device=x.device,
                       memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient as the kernels read it: x's shape, fp32 or bf16;
    autograd may hand over another layout, which is copied to
    channels_last (contiguous rows for (M, C))."""
    if t.shape != x.shape or t.dtype not in _DTYPES:
        raise ValueError(f"gradient {t.dtype} {tuple(t.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    ld = row_stride(t)
    if ld is None or t.data_ptr() % 16 or (ld * t.element_size()) % 16:
        return t.contiguous(memory_format=torch.channels_last if t.dim() == 4
                            else torch.contiguous_format)
    return t


def _check(x: torch.Tensor) -> Tuple[int, int]:
    """(M, C) of a CUDA input the kernels take; raises for anything else."""
    if x.dim() not in (2, 4):
        raise ValueError(f"expected NCHW or (M, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    c = x.shape[1]
    m = x.numel() // c if c else 0
    if c % VEC or c > MAX_C or c == 0:
        raise ValueError(f"channel count must be a multiple of {VEC} up to {MAX_C}, got {c}")
    if m == 0:
        raise ValueError("BatchNorm over no pixels")
    return m, c


def _valid(valid: Optional[torch.Tensor], m: int) -> None:
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (m,)
                              or not valid.is_contiguous()):
        raise ValueError(f"the row mask must be a contiguous bool ({m},) tensor")


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

def _pc(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel row, shaped to broadcast over x."""
    return v.view(1, -1, 1, 1) if x.dim() == 4 else v


def _channel_sum(t: torch.Tensor) -> torch.Tensor:
    return t.sum((0, 2, 3)) if t.dim() == 4 else t.sum(0)


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


def masked_stats_ref(x, valid, weight, running_mean, running_var, eps, momentum):
    """The masked form's statistics as the eager masked form computes them
    (BN over active sites, like scn.BatchNorm*: the biased mean and the
    two-pass variance of the valid rows): (5, C) fp32 rows mean, rstd,
    scale, keep (1) and n = max(sum(valid), 1), over the valid rows of x
    (V, C); the running statistics moved in place as 0.9 old + 0.1 batch."""
    f32 = x.float()
    m = valid[:, None].float()
    n = torch.clamp(m.sum(), min=1.0)
    mean = (f32 * m).sum(0) / n
    var = ((f32 - mean).square() * m).sum(0) / n
    running_mean.mul_(momentum).add_((1 - momentum) * mean)
    running_var.mul_(momentum).add_((1 - momentum) * var)
    rstd = torch.rsqrt(var + eps)
    return torch.stack([mean, rstd, rstd * weight, torch.ones_like(mean),
                        n.expand_as(mean)])


def apply_ref(x, stats, bias, identity, relu, out_dtype, weight=None):
    """(y, mask): y = (x - mean) * scale + bias [+ identity] [ReLU] in fp32,
    then in out_dtype; given `weight` (the masked form), y = (x - mean) *
    rstd * weight + bias in x's dtype, in the eager masked form's order,
    before the epilogue.  mask (bool, x's shape) where the ReLU passed,
    None without one."""
    if weight is None:
        y = (x.float() - _pc(stats[0], x)) * _pc(stats[2], x) + _pc(bias, x)
    else:
        y = ((x.float() - stats[0]) * stats[1] * weight + bias).to(x.dtype)
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


def grad_sums_ref(dy, x, mask, stats, weight, valid=None):
    """(5, C) fp32 rows dweight, dbias and dx's a, b, c in
    dx = a g + b (x - mean) + c (the analytic gradient through flax's
    variance; b is 0 in a channel whose raw variance was clipped).  The
    sums run over every row; with a row mask the statistics' count is
    their n (stats row 4)."""
    g = _masked(dy, mask)
    s = _channel_sum(g)
    q = _channel_sum(g * (x.float() - _pc(stats[0], x)))
    m = g.numel() // g.shape[1] if valid is None else stats[4]
    rstd, keep = stats[1], stats[3]
    wr = weight * rstd
    return torch.stack([q * rstd, s, wr, -wr * rstd * rstd * keep * q / m, -wr * s / m])


def grad_apply_ref(dy, x, mask, stats, coef, residual, valid=None):
    """(dx in x's dtype, d(identity) = g in fp32 or None); with a row mask,
    dx = a g alone at the rows it drops."""
    g = _masked(dy, mask)
    ag = _pc(coef[2], x) * g
    dx = ag + _pc(coef[3], x) * (x.float() - _pc(stats[0], x)) + _pc(coef[4], x)
    if valid is not None:
        dx = torch.where(valid[:, None], dx, ag)
    return dx.to(x.dtype), (g if residual else None)


def unpack_mask(bits: torch.Tensor, shape) -> torch.Tensor:
    """The kernels' ReLU bits, (M, C / 8) uint8 with bit j of byte v for
    channel 8 v + j, as the plain versions' bool mask of NCHW or (M, C)
    `shape` (a bool mask, the plain versions' own, comes back as it is)."""
    if bits.dtype == torch.bool:
        return bits
    shifts = torch.arange(VEC, dtype=torch.uint8, device=bits.device)
    flat = ((bits[..., None] >> shifts) & 1).bool()
    if len(shape) == 2:
        return flat.reshape(shape)
    n, c, h, w = shape
    return flat.reshape(n, h, w, c).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# wrappers: a CPU tensor takes the plain version, a CUDA tensor the kernel
# --------------------------------------------------------------------------

def bn_stats(x: torch.Tensor, weight: torch.Tensor, running_mean: torch.Tensor,
             running_var: torch.Tensor, eps: float, momentum: float,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(4, C) mean, rstd, scale, keep of x (N, C, H, W) or (M, C); with a
    row mask `valid` (M,) over its valid rows, (5, C) with n.  Moves the
    running statistics in place."""
    no_grad_inputs(x, weight)
    if not on_cuda(x, weight, running_mean, running_var, valid):
        if valid is None:
            return stats_ref(x, weight, running_mean, running_var, eps, momentum)
        return masked_stats_ref(x, valid, weight, running_mean, running_var, eps, momentum)
    m, c = _check(x)
    ldx = _rows(x, "x")
    _valid(valid, m)
    _per_channel(c, weight=weight, running_mean=running_mean, running_var=running_var)
    plan = sum_plan(m, c)
    part = torch.empty((plan.blocks, c, 2), dtype=torch.float64, device=x.device)
    kept = (None if valid is None else
            torch.empty(plan.tiles * plan.blocks, dtype=torch.int32, device=x.device))
    stats = torch.empty((4 if valid is None else 5, c), dtype=torch.float32,
                        device=x.device)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.bn_stats(
        ptr(x), ldx, _DTYPES[x.dtype], m, c, plan.blocks, plan.rows, ptr(part),
        ptr(_counter(x.device)), ptr(weight), ptr(running_mean), ptr(running_var),
        ptr(stats), eps, momentum, 1 - momentum, ptr(valid), ptr(kept), stream(),
    ))
    return stats


def bn_apply(x: torch.Tensor, stats: torch.Tensor, bias: torch.Tensor,
             identity: Optional[torch.Tensor], relu: bool, out_dtype: torch.dtype,
             weight: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, mask): y of x's shape (channels_last, or contiguous rows) in
    out_dtype (fp32 or bf16); mask where the ReLU passed (CUDA: (M, C / 8)
    uint8 bits), None without a ReLU.  An identity needs a ReLU after it.
    `weight` marks the masked form, whose plain version applies it as the
    eager masked form did; the kernel reads the scale either way."""
    mode = _MODES[(relu, identity is not None)]
    no_grad_inputs(x, bias, identity, weight)
    if not on_cuda(x, stats, bias, identity):
        return apply_ref(x, stats, bias, identity, relu, out_dtype, weight)
    m, c = _check(x)
    ldx = _rows(x, "x")
    _per_channel(c, bias=bias)
    if out_dtype not in _DTYPES:
        raise TypeError(f"output dtype {out_dtype} for a {x.dtype} input")
    ldid = 0
    if identity is not None:
        if identity.dtype != torch.float32 or identity.shape != x.shape:
            raise ValueError("identity must be fp32 of x's shape")
        ldid = _rows(identity, "identity")
    y = _like(x, out_dtype)
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
                 stats: torch.Tensor, weight: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(5, C) dweight, dbias, a, b, c from the output gradient dy; `valid`,
    the forward's row mask, says the statistics are the masked form's."""
    no_grad_inputs(dy, x, weight)
    if not on_cuda(dy, x, stats, weight, valid):
        return grad_sums_ref(dy, x, mask, stats, weight, valid)
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
        ptr(_counter(x.device)), ptr(weight), ptr(stats), ptr(coef),
        int(valid is not None), stream(),
    ))
    return coef


def bn_grad_apply(dy: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor],
                  stats: torch.Tensor, coef: torch.Tensor, residual: bool,
                  valid: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx in x's layout and dtype, d(identity) fp32 or None)."""
    no_grad_inputs(dy, x)
    if not on_cuda(dy, x, stats, coef, valid):
        return grad_apply_ref(dy, x, mask, stats, coef, residual, valid)
    m, c = _check(x)
    _valid(valid, m)
    dy = _nhwc(dy, x)
    dx = _like(x, x.dtype)
    did = _like(x, torch.float32) if residual else None
    mode = _MODES[(mask is not None, residual)]
    plan = apply_plan(m, c)
    lib = KERNEL.lib()
    KERNEL.launches += 1
    KERNEL.check(lib.bn_grad_apply(
        mode, ptr(dy), row_stride(dy), _DTYPES[dy.dtype], ptr(x), _rows(x, "x"),
        _DTYPES[x.dtype], ptr(mask), ptr(stats), ptr(coef), ptr(dx), ptr(did), m, c,
        plan.blocks, plan.rows_per_iter, ptr(valid), stream(),
    ))
    return dx, did


class BatchNormTrain(torch.autograd.Function):
    """Train-form BatchNorm with its epilogue: forward `bn_stats` and
    `bn_apply`, backward `bn_grad_sums` and `bn_grad_apply`.  Arguments: x,
    weight, bias, identity (or None), running_mean, running_var (moved in
    place), relu, out_dtype, eps, momentum, and the row mask `valid` of
    the masked form (or None)."""

    @staticmethod
    def forward(ctx, x, weight, bias, identity, running_mean, running_var, relu,
                out_dtype, eps, momentum, valid=None):
        stats = bn_stats(x, weight, running_mean, running_var, eps, momentum, valid)
        y, mask = bn_apply(x, stats, bias, identity, relu, out_dtype,
                           None if valid is None else weight)
        ctx.save_for_backward(x, weight, stats, mask, valid)
        ctx.residual = identity is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats, mask, valid = ctx.saved_tensors
        coef = bn_grad_sums(dy, x, mask, stats, weight, valid)
        dx, did = bn_grad_apply(dy, x, mask, stats, coef, ctx.residual, valid)
        return dx, coef[0], coef[1], did, None, None, None, None, None, None, None
