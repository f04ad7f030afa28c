"""Sparse convolution ops and their adjoints (port of `mm2d3d_tpu/ops/spconv.py`).

Each convolution gathers the rows its slot tables name
(`ops.kernels.slot_gather`: an id past the rows gives zeros, so no padded
copy of the map is made) and hands them to the K1 kernel
(`ops.kernels.bandmm.slot_conv_apply`), which contracts them with the
per-tap weights into fp32:

- submanifold 3^3 over the slot plan of a level (`GridLevel.slot_tiers`:
  tier 1, then the compacted mid and heavy tiers where the level has them);
- the stride-2 down convolution (per-tap product + segment sum over the
  Morton-sorted parent ids) and the stride-2 transposed convolution, or,
  where the hierarchy packed the child tables into slots
  (`hierarchy.build_child_slots`), the down convolution as K1 over the child
  slots' plan (`LevelTransition.child_tiers`, K = 8) and the transposed
  convolution's input gradient likewise.

Every slot form applies its plan through `_apply_tiers` (K1 a tier, tiers
2-3 merged into tier 1's rows in order) and takes its weight gradient
through `_dw_tiers` (K2 a tier, summed in tier order).

A level without slot tables takes the dense 27-tap submanifold conv
(`_SubmDense`): all 27 neighbour rows gathered by the level's `nbr` table
and contracted by the K6 kernel (`ops.kernels.tapsum.tapsum`).  The 5^3
submanifold conv (`subm_conv5`, a stem over level 0's 125-neighbour table
`nbr5`) is the same dense form with 125 taps.

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
from .kernels.slot_gather import slot_gather
from .kernels.tapsum import tapsum

# Fault injection for the flagship learning check
# (`tools/check_flagship_learning.py --mutate`), as in the JAX package: when
# True, the 3-tier submanifold conv's backward drops the mid and heavy
# tiers from the input and the weight gradients.  The forward stays exact;
# the gradients lose those tiers' terms, the fault the check's per-step
# loss gate must catch.  Never set outside that check.
_DEBUG_DROP_COMPACT_TIERS_BWD = False


def _masked(feats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None], feats, torch.zeros((), dtype=feats.dtype,
                                                          device=feats.device))


def _scatter_add_rows(out: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] += rows[i]; idx == V (the pad) contributes nothing.

    A tier's slot table names each voxel at most once, so no two rows meet
    at one real index: each sum has a single term, and the card's atomics
    (only the dropped pad row takes many) give the same bits every run."""
    v = out.shape[0]
    padded = torch.cat([out, out.new_zeros((1, out.shape[1]))])
    padded.index_add_(0, torch.clamp(idx, max=v).long(), rows)
    return padded[:v]


def _gather_add_rows(out: torch.Tensor, inv: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """out[v] += rows[inv[v]]; inv == len(rows) contributes nothing."""
    return out + slot_gather(rows, inv)


def _flip(weight: torch.Tensor) -> torch.Tensor:
    """The adjoint's weights `weight[::-1].swapaxes(1, 2)`, contiguous."""
    return weight.flip(0).transpose(1, 2).contiguous()


def _apply_tiers(centre, x, tiers, weight, keep: bool = True):
    """K1 over a slot plan (`GridLevel.slot_tiers`, `LevelTransition
    .child_tiers`): each tier's rows of x gathered and contracted, the
    centre (or None) on tier 1 only, tiers 2-3 merged in order into tier
    1's output, by a gather through `inv` or a scatter at `rows` ->
    (out (V, Co) fp32, the gathered rows of each tier, or () without
    `keep`).  Each tier's temporaries go before the next is gathered."""
    out, kept = None, []
    for t in tiers:
        xt = slot_gather(x, t.src)  # (H, Vt, Ci)
        y = slot_conv_apply(centre, xt, t.tap, weight)
        out = (y if t.rows is None else _gather_add_rows(out, t.inv, y)
               if t.inv is not None else _scatter_add_rows(out, t.rows, y))
        if keep:
            kept.append(xt)
        centre = xt = y = None
    return out, tuple(kept)


def _dw_tiers(centre, gathered, tiers, g, k_taps: int = 27):
    """K2 over a slot plan: each tier's weight gradient from its gathered
    rows and the output gradient at its rows (tier 1: g itself, with the
    centre), summed left to right in tier order."""
    d_weight = None
    for t, xt in zip(tiers, gathered):
        gt = g if t.rows is None else slot_gather(g, t.rows)  # (Vt, Co)
        dw = slot_conv_dw(centre if t.rows is None else None, xt, t.tap, gt,
                          k_taps=k_taps)
        d_weight = dw if d_weight is None else d_weight + dw
    return d_weight


# ---------------------------------------------------------------------------
# submanifold 3x3x3
# ---------------------------------------------------------------------------

class _SubmSlots(torch.autograd.Function):
    """Slot form over the level's 1, 2 or 3 tiers (`_subm_apply_slots`,
    `_subm_apply_slots2`, `_subm_apply_slots3`; backward `_subm_slots_bwd`,
    `_subm_slots2_bwd`, `_subm_slots3_bwd`)."""

    @staticmethod
    def forward(ctx, feats, weight, level: GridLevel):
        tiers = level.slot_tiers()
        xc = _masked(feats, level.valid)
        out, gathered = _apply_tiers(xc, feats, tiers, weight)
        ctx.save_for_backward(weight)
        ctx.res = (xc, gathered, level)
        return out

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        xc, gathered, lev = ctx.res
        tiers = lev.slot_tiers()
        if _DEBUG_DROP_COMPACT_TIERS_BWD and len(tiers) == 3:
            tiers = tiers[:1]
        g = g.to(xc.dtype).contiguous()  # a slice when the output was concatenated
        d_feats, _ = _apply_tiers(_masked(g, lev.valid), g, tiers, _flip(weight),
                                  keep=False)
        d_weight = _dw_tiers(xc, gathered, tiers, g)
        return d_feats.to(xc.dtype), d_weight.to(weight.dtype), None


class _SubmDense(torch.autograd.Function):
    """Dense K-tap form over a (K, V) neighbour table (`_subm_apply`;
    `_subm_fwd` / `_subm_bwd`): K = 27 over `nbr`, K = 125 over `nbr5`."""

    @staticmethod
    def forward(ctx, feats, weight, nbr: torch.Tensor):
        # the gathered neighbourhoods are the residual: the weight gradient
        # needs exactly this tensor, as in JAX
        gathered = slot_gather(feats, nbr)  # (K, V, Ci)
        ctx.save_for_backward(weight)
        ctx.res = (gathered, nbr)
        return tapsum(gathered, weight)

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        gathered, nbr = ctx.res
        g = g.to(gathered.dtype).contiguous()  # a slice when the output was concatenated
        # the dense table is symmetric: tap k of v pairs with tap K - 1 - k
        d_feats = tapsum(slot_gather(g, nbr), _flip(weight))
        d_weight = torch.einsum("kvi,vo->kio", gathered, g)  # (K, Ci, Co)
        return d_feats.to(gathered.dtype), d_weight.to(weight.dtype), None


def subm_conv3(feats: torch.Tensor, level: GridLevel, weight: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Submanifold 3x3x3 convolution over the level's slot tables, or over
    its dense 27-neighbour table where it has none.

    feats (V, Cin), weight (27, Cin, Cout) in `hierarchy.OFFSETS_27` tap
    order -> (V, Cout) fp32."""
    feats = feats.to(compute_dtype)
    weight = weight.to(compute_dtype).contiguous()
    if not level.slot_tiers():
        return _SubmDense.apply(feats, weight, level.nbr)
    return _SubmSlots.apply(feats, weight, level)


def subm_conv5(feats: torch.Tensor, level: GridLevel, weight: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Submanifold 5x5x5 convolution over the level's 125-neighbour table
    (`level.nbr5`, built by `build_topology(..., stem_kernel=5)`): the dense
    form, its 125 taps' rows gathered and contracted by K6, forward and
    input gradient (flipped taps, k <-> 124 - k); the weight gradient a
    product of the kept gather and the output gradient.

    feats (V, Cin), weight (125, Cin, Cout) in `hierarchy.OFFSETS_125` tap
    order -> (V, Cout) fp32."""
    if level.nbr5 is None:
        raise ValueError("the level has no 125-neighbour table: build the "
                         "topology with stem_kernel=5 for a 5^3 convolution")
    return _SubmDense.apply(feats.to(compute_dtype),
                            weight.to(compute_dtype).contiguous(), level.nbr5)


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
    return _per_tap_matmul(slot_gather(coarse, parent), off_id, weight)


def _down_seg_raw(fine: torch.Tensor, weight: torch.Tensor,
                  trans: LevelTransition) -> torch.Tensor:
    """out[c] = sum over children f of c of fine[f] @ weight[off_id[f]].

    No two children of a parent share an `off_id`, so the child table
    (`trans.child`, (Vc, 8), a missing child = Vf) names each term once: the
    sum over its 8 columns runs in a fixed order, which is the key order of
    the JAX package's sorted segment sum (off_id is the Morton order of the
    2x2x2 cell); no atomics."""
    y = _per_tap_matmul(fine, trans.off_id, weight)
    return slot_gather(y, trans.child).sum(1)


def _down_dw(fine: torch.Tensor, off_id: torch.Tensor,
             gp: torch.Tensor) -> torch.Tensor:
    """d_weight[k] = sum over fine rows with off_id == k of fine x g[parent]."""
    return slot_conv_dw(None, fine[None].contiguous(), off_id[None].contiguous(),
                        gp, k_taps=8)


class _Down(torch.autograd.Function):
    """Strided down conv (`_down_apply`; backward `_down_bwd`)."""

    @staticmethod
    def forward(ctx, fine, weight, trans: LevelTransition):
        ctx.save_for_backward(fine, weight)
        ctx.trans = trans
        return _down_seg_raw(fine, weight, trans)

    @staticmethod
    def backward(ctx, g):
        fine, weight = ctx.saved_tensors
        trans = ctx.trans
        g = g.to(fine.dtype).contiguous()
        # transpose of down conv = deconv through (parent, off_id)
        d_fine = _up_apply_raw(g, weight.transpose(1, 2).contiguous(),
                               trans.parent, trans.off_id)
        gp = slot_gather(g, trans.parent)
        d_weight = _down_dw(fine, trans.off_id, gp)
        return d_fine.to(fine.dtype), d_weight.to(weight.dtype), None


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
        g = g.to(coarse.dtype).contiguous()
        # transpose of deconv = down conv through (parent, off_id)
        d_coarse = _down_seg_raw(g, weight.transpose(1, 2).contiguous(), trans)
        gp = slot_gather(coarse, trans.parent)
        d_weight = _down_dw(gp, trans.off_id, g)
        return d_coarse.to(coarse.dtype), d_weight.to(weight.dtype), None


class _DownSlots(torch.autograd.Function):
    """Strided down conv over the child slots (`_down_apply_slots`;
    backward `_down_slots_bwd`): K1 over the h_lo slots of every parent and
    over the compacted heavy tier, whose rows add to theirs (each parent at
    most once, so each sum has one term)."""

    @staticmethod
    def forward(ctx, fine, weight, trans: LevelTransition):
        out, gathered = _apply_tiers(None, fine, trans.child_tiers(), weight)
        ctx.save_for_backward(weight)
        ctx.res = (gathered, trans)
        return out

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        gathered, trans = ctx.res
        dtype = gathered[0].dtype
        g = g.to(dtype).contiguous()
        # transpose of down conv = deconv through (parent, off_id), as dense
        d_fine = _up_apply_raw(g, weight.transpose(1, 2).contiguous(),
                               trans.parent, trans.off_id)
        d_weight = _dw_tiers(None, gathered, trans.child_tiers(), g, k_taps=8)
        return d_fine.to(dtype), d_weight.to(weight.dtype), None


class _UpSlots(_Up):
    """Transposed stride-2 conv whose input gradient runs over the child
    slots (`_up_apply_slots`; backward `_up_slots_bwd`): the forward and
    the weight gradient are `_Up`'s."""

    @staticmethod
    def backward(ctx, g):
        coarse, weight = ctx.saved_tensors
        trans = ctx.trans
        g = g.to(coarse.dtype).contiguous()
        # transpose of deconv = down conv through the child slots
        d_coarse, _ = _apply_tiers(None, g, trans.child_tiers(),
                                   weight.transpose(1, 2).contiguous(), keep=False)
        gp = slot_gather(coarse, trans.parent)
        d_weight = _down_dw(gp, trans.off_id, g)
        return d_coarse.to(coarse.dtype), d_weight.to(weight.dtype), None


def down_conv2(fine_feats: torch.Tensor, trans: LevelTransition,
               weight: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Strided down convolution (filter 2, stride 2): fine -> coarse sites.

    out[c] = sum over children f of c of fine[f] @ weight[off_id[f]];
    weight (8, Cin, Cout) in `hierarchy.OFFSETS_8` order.  Over the child
    slots where the transition has them (`trans.child_tiers()`)."""
    fn = _DownSlots if trans.child_tiers() else _Down
    return fn.apply(fine_feats.to(compute_dtype),
                    weight.to(compute_dtype).contiguous(), trans)


def up_conv2(coarse_feats: torch.Tensor, trans: LevelTransition,
             weight: torch.Tensor,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Transposed stride-2 convolution back onto the fine site set:
    out[f] = coarse[parent[f]] @ weight[off_id[f]] (dumped parents -> 0);
    the input gradient runs over the child slots where the transition has
    them (`trans.child_tiers()`)."""
    fn = _UpSlots if trans.child_tiers() else _Up
    return fn.apply(coarse_feats.to(compute_dtype),
                    weight.to(compute_dtype).contiguous(), trans)

