"""Sparse convolution forward ops (port of `mm2d3d_tpu/ops/spconv.py`).

Each convolution gathers the rows its slot tables name and hands them to the
K1 kernel (`ops.kernels.bandmm.slot_conv_apply`), which contracts them with
the per-tap weights into fp32:

- submanifold 3^3 over the 3-tier, 2-tier or 1-tier slot tables of a level;
- the stride-2 down convolution (per-tap product + segment sum over the
  Morton-sorted parent ids) and the stride-2 transposed convolution.

Inputs are cast to `compute_dtype`; outputs are fp32, as in the JAX package.
Forward only: the adjoints come with the train step.
"""

from __future__ import annotations

import torch

from .hierarchy import GridLevel, LevelTransition
from .kernels.bandmm import slot_conv_apply


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


def subm_conv3(feats: torch.Tensor, level: GridLevel, weight: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Submanifold 3x3x3 convolution over the level's slot tables.

    feats (V, Cin), weight (27, Cin, Cout) in `hierarchy.OFFSETS_27` tap
    order -> (V, Cout) fp32."""
    if level.slot_src is None:
        raise NotImplementedError("the dense 27-tap path is not ported")
    x = feats.to(compute_dtype)
    w = weight.to(compute_dtype).contiguous()
    padded = _pad_zero_row(x)
    out = slot_conv_apply(_masked(x, level.valid), _take(padded, level.slot_src),
                          level.slot_tap, w)
    if level.slot_srcm is not None:
        om = slot_conv_apply(None, _take(padded, level.slot_srcm),
                             level.slot_tapm, w)
        out = _gather_add_rows(out, level.slot_invm, om)
    if level.slot_src2 is not None:
        oh = slot_conv_apply(None, _take(padded, level.slot_src2),
                             level.slot_tap2, w)
        out = _scatter_add_rows(out, level.slot_idx, oh)
    return out


def _per_tap_matmul(x: torch.Tensor, off_id: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """y[v] = x[v] @ weight[off_id[v]] -> (V, Co) fp32 (K1 with H = 1, K = 8)."""
    return slot_conv_apply(None, x[None].contiguous(), off_id[None].contiguous(),
                           weight)


def down_conv2(fine_feats: torch.Tensor, trans: LevelTransition,
               weight: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Strided down convolution (filter 2, stride 2): fine -> coarse sites.

    out[c] = sum over children f of c of fine[f] @ weight[off_id[f]];
    weight (8, Cin, Cout) in `hierarchy.OFFSETS_8` order."""
    vc = trans.child.shape[0]
    y = _per_tap_matmul(fine_feats.to(compute_dtype), trans.off_id,
                        weight.to(compute_dtype).contiguous())
    out = y.new_zeros((vc + 1, y.shape[1]))
    out.index_add_(0, trans.parent.long(), y)  # dumped rows land on row vc
    return out[:vc]


def up_conv2(coarse_feats: torch.Tensor, trans: LevelTransition,
             weight: torch.Tensor,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Transposed stride-2 convolution back onto the fine site set:
    out[f] = coarse[parent[f]] @ weight[off_id[f]] (dumped parents -> 0)."""
    vc = coarse_feats.shape[0]
    padded = _pad_zero_row(coarse_feats.to(compute_dtype))
    xg = _take(padded, torch.clamp(trans.parent, max=vc))
    return _per_tap_matmul(xg, trans.off_id, weight.to(compute_dtype).contiguous())
