"""Segmentation metrics (port of `mm2d3d_tpu/train/metrics.py`): confusion
matrix -> per-class IoU; classes absent from both prediction and ground
truth score `absent_score` (torchmetrics' default 0)."""

from __future__ import annotations

import torch

from .losses import IGNORE_INDEX


def confusion_matrix_update(cm: torch.Tensor, preds: torch.Tensor,
                            labels: torch.Tensor, valid: torch.Tensor
                            ) -> torch.Tensor:
    """cm (C, C) [gt, pred] + one batch of (M,) predictions -> new cm."""
    mask = (labels != IGNORE_INDEX) & valid
    gt = torch.where(mask, labels, 0).long()
    pr = torch.where(mask, preds, 0).long()
    return cm.index_put((gt, pr), mask.to(cm.dtype), accumulate=True)


def iou_per_class(cm: torch.Tensor, absent_score: float = 0.0) -> torch.Tensor:
    cm = cm.float()
    tp = torch.diag(cm)
    union = cm.sum(1) + cm.sum(0) - tp
    absent = union == 0
    iou = tp / torch.where(absent, torch.ones_like(union), union)
    return torch.where(absent, torch.full_like(iou, absent_score), iou)


def mean_iou(cm: torch.Tensor) -> torch.Tensor:
    return iou_per_class(cm).mean()
