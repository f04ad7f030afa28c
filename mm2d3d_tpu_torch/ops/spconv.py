"""Sparse convolution ops and their adjoints (port of `mm2d3d_tpu/ops/spconv.py`).

Each convolution gathers the rows its slot tables name and hands them to the
K1 kernel (`ops.kernels.bandmm.slot_conv_apply`), which contracts them with
the per-tap weights into fp32:

- submanifold 3^3 over the 3-tier, 2-tier or 1-tier slot tables of a level;
- the stride-2 down convolution (per-tap product + segment sum over the
  Morton-sorted parent ids) and the stride-2 transposed convolution.

A level without slot tables takes the dense 27-tap submanifold conv
(`_SubmDense`): all 27 neighbour rows gathered by the level's `nbr` table
and contracted by the K6 kernel (`ops.kernels.tapsum.tapsum`).

Each form is a `torch.autograd.Function` whose backward mirrors the JAX
package's custom VJP line for line.  The input gradient is K1 again over the
same tables: with the flipped, transposed weights `W[::-1].swapaxes(1, 2)`
for the submanifold conv (tap k pairs with 26 - k), with the transposed
weights for the strided ones (which are each other's transposes).  The
weight gradient is K2 (`ops.kernels.bandmm_dw.slot_conv_dw`) over the
gathered rows the forward keeps.  The dense form's input gradient is K6
with the flipped weights; its weight gradient is a plain product of the
kept gather and the output gradient, which the JAX package also leaves to
XLA (`dot_general`).  Inputs are cast to `compute_dtype`;
outputs are fp32; the gradients are cast to the compute dtype where JAX
casts them, and autograd casts them back to the fp32 parameters.
"""

from __future__ import annotations

import torch

from .hierarchy import GridLevel, LevelTransition
from .kernels.bandmm import slot_conv_apply
from .kernels.bandmm_dw import slot_conv_dw
from .kernels.tapsum import tapsum


def _pad_zero_row(feats: torch.Tensor) -> torch.Tensor:
    return torch.cat([feats, feats.new_zeros((1, feats.shape[-1]))])


def _masked(feats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None], feats, torch.zeros((), dtype=feats.dtype,
                                                          device=feats.device))


def _take(padded: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of `padded` (V + 1, C) at int32 indices in [0, V]."""
    return padded[idx.long()]


def _scatter_add_rows(out: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] += rows[i]; idx == V (the pad) contributes nothing."""
    v = out.shape[0]
    padded = _pad_zero_row(out)
    padded.index_add_(0, torch.clamp(idx, max=v).long(), rows)
    return padded[:v]


def _gather_add_rows(out: torch.Tensor, inv: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """out[v] += rows[inv[v]]; inv == len(rows) contributes nothing."""
    return out + _take(_pad_zero_row(rows), inv)


def _flip(weight: torch.Tensor) -> torch.Tensor:
    """The adjoint's weights `weight[::-1].swapaxes(1, 2)`, contiguous."""
    return weight.flip(0).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# submanifold 3x3x3
# ---------------------------------------------------------------------------

class _SubmSlots3(torch.autograd.Function):
    """3-tier slot form (`_subm_apply_slots3`; backward `_subm_slots3_bwd`)."""

    @staticmethod
    def forward(ctx, feats, weight, level: GridLevel):
        padded = _pad_zero_row(feats)
        xc = _masked(feats, level.valid)
        x1 = _take(padded, level.slot_src)  # (h1, V, Ci)
        out = slot_conv_apply(xc, x1, level.slot_tap, weight)
        xm = _take(padded, level.slot_srcm)  # (Hm, Vm, Ci)
        out = _gather_add_rows(out, level.slot_invm,
                               slot_conv_apply(None, xm, level.slot_tapm, weight))
        xh = _take(padded, level.slot_src2)  # (Hh, Vh, Ci)
        out = _scatter_add_rows(out, level.slot_idx,
                                slot_conv_apply(None, xh, level.slot_tap2, weight))
        ctx.save_for_backward(weight)
        ctx.res = (xc, x1, xm, xh, level)
        return out

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        xc, x1, xm, xh, lev = ctx.res
        g = g.to(xc.dtype).contiguous()  # a slice when the output was concatenated
        w_flip = _flip(weight)
        g_pad = _pad_zero_row(g)
        d_feats = slot_conv_apply(_masked(g, lev.valid), _take(g_pad, lev.slot_src),
                                  lev.slot_tap, w_flip)
        d_feats = _gather_add_rows(d_feats, lev.slot_invm, slot_conv_apply(
            None, _take(g_pad, lev.slot_srcm), lev.slot_tapm, w_flip))
        d_feats = _scatter_add_rows(d_feats, lev.slot_idx, slot_conv_apply(
            None, _take(g_pad, lev.slot_src2), lev.slot_tap2, w_flip))
        g_m = _take(g_pad, lev.slot_idxm)  # (Vm, Co)
        g_h = _take(g_pad, lev.slot_idx)  # (Vh, Co)
        d_weight = (slot_conv_dw(xc, x1, lev.slot_tap, g)
                    + slot_conv_dw(None, xm, lev.slot_tapm, g_m)
                    + slot_conv_dw(None, xh, lev.slot_tap2, g_h))
        return d_feats.to(xc.dtype), d_weight.to(weight.dtype), None


class _SubmSlots2(torch.autograd.Function):
    """2-tier slot form (`_subm_apply_slots2`; backward `_subm_slots2_bwd`)."""

    @staticmethod
    def forward(ctx, feats, weight, level: GridLevel):
        padded = _pad_zero_row(feats)
        xc = _masked(feats, level.valid)
        x1 = _take(padded, level.slot_src)  # (h_lo, V, Ci)
        out = slot_conv_apply(xc, x1, level.slot_tap, weight)
        x2 = _take(padded, level.slot_src2)  # (H2, Vh, Ci)
        out = _scatter_add_rows(out, level.slot_idx,
                                slot_conv_apply(None, x2, level.slot_tap2, weight))
        ctx.save_for_backward(weight)
        ctx.res = (xc, x1, x2, level)
        return out

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        xc, x1, x2, lev = ctx.res
        g = g.to(xc.dtype).contiguous()  # a slice when the output was concatenated
        w_flip = _flip(weight)
        g_pad = _pad_zero_row(g)
        d_feats = slot_conv_apply(_masked(g, lev.valid), _take(g_pad, lev.slot_src),
                                  lev.slot_tap, w_flip)
        d2 = slot_conv_apply(None, _take(g_pad, lev.slot_src2), lev.slot_tap2,
                             w_flip)  # (Vh, Ci)
        d_feats = _scatter_add_rows(d_feats, lev.slot_idx, d2)
        g_hi = _take(g_pad, lev.slot_idx)  # (Vh, Co)
        d_weight = (slot_conv_dw(xc, x1, lev.slot_tap, g)
                    + slot_conv_dw(None, x2, lev.slot_tap2, g_hi))
        return d_feats.to(xc.dtype), d_weight.to(weight.dtype), None


class _SubmSlots1(torch.autograd.Function):
    """1-tier slot form (`_subm_apply_slots`; backward `_subm_slots_bwd`)."""

    @staticmethod
    def forward(ctx, feats, weight, level: GridLevel):
        xc = _masked(feats, level.valid)
        x1 = _take(_pad_zero_row(feats), level.slot_src)  # (H, V, Ci)
        ctx.save_for_backward(weight)
        ctx.res = (xc, x1, level)
        return slot_conv_apply(xc, x1, level.slot_tap, weight)

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        xc, x1, lev = ctx.res
        g = g.to(xc.dtype).contiguous()  # a slice when the output was concatenated
        d_feats = slot_conv_apply(_masked(g, lev.valid),
                                  _take(_pad_zero_row(g), lev.slot_src),
                                  lev.slot_tap, _flip(weight))
        d_weight = slot_conv_dw(xc, x1, lev.slot_tap, g)
        return d_feats.to(xc.dtype), d_weight.to(weight.dtype), None


class _SubmDense(torch.autograd.Function):
    """Dense 27-tap form (`_subm_apply`; `_subm_fwd` / `_subm_bwd`)."""

    @staticmethod
    def forward(ctx, feats, weight, level: GridLevel):
        # the gathered neighbourhoods are the residual: the weight gradient
        # needs exactly this tensor, as in JAX
        gathered = _take(_pad_zero_row(feats), level.nbr)  # (27, V, Ci)
        ctx.save_for_backward(weight)
        ctx.res = (gathered, level)
        return tapsum(gathered, weight)

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        gathered, lev = ctx.res
        g = g.to(gathered.dtype).contiguous()  # a slice when the output was concatenated
        # the dense table is symmetric: tap k of v pairs with tap 26 - k
        d_feats = tapsum(_take(_pad_zero_row(g), lev.nbr), _flip(weight))
        d_weight = torch.einsum("kvi,vo->kio", gathered, g)  # (27, Ci, Co)
        return d_feats.to(gathered.dtype), d_weight.to(weight.dtype), None


def subm_conv3(feats: torch.Tensor, level: GridLevel, weight: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Submanifold 3x3x3 convolution over the level's slot tables, or over
    its dense 27-neighbour table where it has none.

    feats (V, Cin), weight (27, Cin, Cout) in `hierarchy.OFFSETS_27` tap
    order -> (V, Cout) fp32."""
    fn = (_SubmDense if level.slot_src is None
          else _SubmSlots3 if level.slot_srcm is not None
          else _SubmSlots2 if level.slot_src2 is not None else _SubmSlots1)
    return fn.apply(feats.to(compute_dtype),
                    weight.to(compute_dtype).contiguous(), level)


# ---------------------------------------------------------------------------
# stride-2 down conv / deconv (mutual transposes)
# ---------------------------------------------------------------------------

def _per_tap_matmul(x: torch.Tensor, off_id: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """y[v] = x[v] @ weight[off_id[v]] -> (V, Co) fp32 (K1 with H = 1, K = 8)."""
    return slot_conv_apply(None, x[None].contiguous(), off_id[None].contiguous(),
                           weight)


def _up_apply_raw(coarse: torch.Tensor, weight: torch.Tensor,
                  parent: torch.Tensor, off_id: torch.Tensor) -> torch.Tensor:
    """out[f] = coarse[parent[f]] @ weight[off_id[f]] (dumped parents -> 0)."""
    vc = coarse.shape[0]
    xg = _take(_pad_zero_row(coarse), torch.clamp(parent, max=vc))
    return _per_tap_matmul(xg, off_id, weight)


def _down_seg_raw(fine: torch.Tensor, weight: torch.Tensor,
                  parent: torch.Tensor, off_id: torch.Tensor,
                  vc: int) -> torch.Tensor:
    """out[c] = sum over children f of c of fine[f] @ weight[off_id[f]]."""
    y = _per_tap_matmul(fine, off_id, weight)
    out = y.new_zeros((vc + 1, y.shape[1]))
    out.index_add_(0, parent.long(), y)  # dumped rows land on row vc
    return out[:vc]


def _down_dw(fine: torch.Tensor, off_id: torch.Tensor,
             gp: torch.Tensor) -> torch.Tensor:
    """d_weight[k] = sum over fine rows with off_id == k of fine x g[parent]."""
    return slot_conv_dw(None, fine[None].contiguous(), off_id[None].contiguous(),
                        gp, k_taps=8)


class _Down(torch.autograd.Function):
    """Strided down conv (`_down_apply`; backward `_down_bwd`)."""

    @staticmethod
    def forward(ctx, fine, weight, trans: LevelTransition, vc: int):
        ctx.save_for_backward(fine, weight)
        ctx.res = (trans, vc)
        return _down_seg_raw(fine, weight, trans.parent, trans.off_id, vc)

    @staticmethod
    def backward(ctx, g):
        fine, weight = ctx.saved_tensors
        trans, vc = ctx.res
        g = g.to(fine.dtype).contiguous()
        # transpose of down conv = deconv through (parent, off_id)
        d_fine = _up_apply_raw(g, weight.transpose(1, 2).contiguous(),
                               trans.parent, trans.off_id)
        gp = _take(_pad_zero_row(g), torch.clamp(trans.parent, max=vc))
        d_weight = _down_dw(fine, trans.off_id, gp)
        return d_fine.to(fine.dtype), d_weight.to(weight.dtype), None, None


class _Up(torch.autograd.Function):
    """Transposed stride-2 conv (`_up_apply`; backward `_up_bwd`)."""

    @staticmethod
    def forward(ctx, coarse, weight, trans: LevelTransition):
        ctx.save_for_backward(coarse, weight)
        ctx.trans = trans
        return _up_apply_raw(coarse, weight, trans.parent, trans.off_id)

    @staticmethod
    def backward(ctx, g):
        coarse, weight = ctx.saved_tensors
        trans = ctx.trans
        vc = coarse.shape[0]
        g = g.to(coarse.dtype).contiguous()
        # transpose of deconv = down conv through (parent, off_id)
        d_coarse = _down_seg_raw(g, weight.transpose(1, 2).contiguous(),
                                 trans.parent, trans.off_id, vc)
        gp = _take(_pad_zero_row(coarse), torch.clamp(trans.parent, max=vc))
        d_weight = _down_dw(gp, trans.off_id, g)
        return d_coarse.to(coarse.dtype), d_weight.to(weight.dtype), None


def down_conv2(fine_feats: torch.Tensor, trans: LevelTransition,
               weight: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Strided down convolution (filter 2, stride 2): fine -> coarse sites.

    out[c] = sum over children f of c of fine[f] @ weight[off_id[f]];
    weight (8, Cin, Cout) in `hierarchy.OFFSETS_8` order."""
    return _Down.apply(fine_feats.to(compute_dtype),
                       weight.to(compute_dtype).contiguous(), trans,
                       trans.child.shape[0])


def up_conv2(coarse_feats: torch.Tensor, trans: LevelTransition,
             weight: torch.Tensor,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Transposed stride-2 convolution back onto the fine site set:
    out[f] = coarse[parent[f]] @ weight[off_id[f]] (dumped parents -> 0)."""
    return _Up.apply(coarse_feats.to(compute_dtype),
                     weight.to(compute_dtype).contiguous(), trans)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def masked_batch_norm_stats(feats: torch.Tensor, valid: torch.Tensor):
    """fp32 (mean, biased var) of shape (C,) over the valid rows only (BN
    over active sites, like scn.BatchNorm*); differentiable."""
    f32 = feats.float()
    m = valid[:, None].float()
    n = torch.clamp(m.sum(), min=1.0)
    mean = (f32 * m).sum(0) / n
    var = ((f32 - mean).square() * m).sum(0) / n
    return mean, var
