"""Segmentation loss (port of `mm2d3d_tpu/train/losses.py::weighted_cross_entropy`).

The masked-mean form of `F.cross_entropy(pred, gt, weight=w)` with
ignore_index -100: each valid point contributes weight w[label]."""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           valid: Optional[torch.Tensor] = None,
                           class_weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """logits (M, C), labels (M,) int, valid (M,) bool -> () fp32."""
    mask = labels != IGNORE_INDEX
    if valid is not None:
        mask = mask & valid
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = (class_weights.float()[safe] if class_weights is not None
         else torch.ones_like(nll))
    w = w * mask.float()
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-12)
