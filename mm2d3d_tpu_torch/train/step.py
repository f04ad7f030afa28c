"""The eval forward of the cross-modal task (port of the eval part of
`mm2d3d_tpu/train/step.py`).

`MM2D3DTask` holds the two networks.  `forward` is the fused 2D+3D forward
with the softmax ensemble that `__graft_entry__.entry` returns; `eval_step`
adds the eval losses and the 2D / 3D / ensemble confusion-matrix updates with
the JAX package's log keys.  Both run under `torch.inference_mode()`.
Training (optimizers, losses across domains, the adjoints) comes later.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..models.convert import from_flax
from ..models.net2d import Net2DSeg
from ..models.resnet2d import BatchNorm2d
from ..models.sparse_unet import DownConv, MaskedBatchNorm, Net3DSeg, SubmConv, UpConv
from .batch import PointBatch, build_topology, flatten_points, prepare_device_batch
from .losses import IGNORE_INDEX, weighted_cross_entropy
from .metrics import confusion_matrix_update


@dataclass
class EvalMetrics:
    """Confusion-matrix accumulators [gt, pred] for 2D / 3D / ensemble."""

    cm_2d: torch.Tensor
    cm_3d: torch.Tensor
    cm_avg: torch.Tensor

    @classmethod
    def create(cls, num_classes: int, device="cpu") -> "EvalMetrics":
        def z():
            return torch.zeros((num_classes, num_classes), dtype=torch.int32,
                               device=device)

        return cls(cm_2d=z(), cm_3d=z(), cm_avg=z())


def _init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: He-normal sparse kernels (fan-in = taps * Cin), LeCun-
    normal dense kernels, zero biases, identity batch norms."""

    def normal_(p: torch.Tensor, fan_in: int, gain: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * math.sqrt(gain / fan_in))

    for m in module.modules():
        if isinstance(m, (SubmConv, DownConv, UpConv)):
            k, ci, _ = m.weight.shape
            normal_(m.weight, k * ci, 2.0)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            normal_(m.weight, m.weight[0].numel(), 1.0)
        elif isinstance(m, nn.ConvTranspose2d):
            ci, _, kh, kw = m.weight.shape
            normal_(m.weight, ci * kh * kw, 1.0)
        elif isinstance(m, (MaskedBatchNorm, BatchNorm2d)):
            m.weight.fill_(1.0)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()


class MM2D3DTask:
    """Static task configuration + the two networks."""

    def __init__(self, num_classes: int, class_weights=None,
                 full_scale: int = 4096, num_planes: int = 7, m: int = 16,
                 block_reps: int = 1, in_channels_3d: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16, device="cpu"):
        self.num_classes = num_classes
        self.full_scale = full_scale
        self.num_planes = num_planes
        self.device = torch.device(device)
        self.class_weights = (
            None if class_weights is None
            else torch.tensor(class_weights, dtype=torch.float32, device=self.device)
        )
        self.model2d = Net2DSeg(num_classes, compute_dtype)
        self.model3d = Net3DSeg(num_classes, in_channels=in_channels_3d, m=m,
                                block_reps=block_reps, num_planes=num_planes,
                                compute_dtype=compute_dtype)
        for net in (self.model2d, self.model3d):
            net.requires_grad_(False).eval()

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from a seeded CPU generator, then to the device."""
        with torch.no_grad():
            for net in (self.model2d, self.model3d):
                net.to("cpu")
                _init_(net, generator)
        self._to_device()

    def load_flax(self, params2d: Mapping, stats2d: Mapping,
                  params3d: Mapping, stats3d: Mapping) -> None:
        """Weights of the JAX package's task (nested dicts of numpy arrays)."""
        sd2, sd3 = from_flax(params2d, stats2d, params3d, stats3d)
        self.model2d.load_state_dict(sd2, strict=True)
        self.model3d.load_state_dict(sd3, strict=True)
        self._to_device()

    def _to_device(self) -> None:
        self.model2d.to(self.device, memory_format=torch.channels_last)
        self.model3d.to(self.device)

    # -- forward ---------------------------------------------------------

    def _forward(self, batch: PointBatch):
        batch = prepare_device_batch(batch)
        topo = build_topology(batch, self.full_scale, self.num_planes)
        _, feats, labels, mask, _ = flatten_points(batch)
        p2, _, _ = self.model2d(batch.img, batch.depth, batch.img_indices,
                                batch.point_mask)
        p3, _, _ = self.model3d(feats, *topo)
        flat2 = p2["seg_logit"].reshape(-1, self.num_classes).float()
        flat3 = p3["seg_logit"].float()
        ens = (torch.softmax(flat2, -1) + torch.softmax(flat3, -1)) / 2
        return topo, p2, flat2, flat3, ens, labels, mask

    @torch.inference_mode()
    def forward(self, batch: PointBatch) -> Dict[str, torch.Tensor]:
        """{"seg_logit_2d": (B, N, nc) lifted 2D logits, "seg_logit_3d":
        (B*N, nc), "ensemble": (B*N, nc) mean of the two softmaxes}."""
        _, p2, flat2, flat3, ens, _, _ = self._forward(batch)
        return {"seg_logit_2d": p2["seg_logit"], "seg_logit_3d": flat3,
                "ensemble": ens}

    def seg_loss_weight(self, labels: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        """Sum of per-point class weights over valid points (the masked-mean
        loss's own denominator)."""
        valid = ((labels != IGNORE_INDEX) & mask).float()
        if self.class_weights is None:
            return valid.sum()
        w = self.class_weights[torch.where(valid > 0, labels, 0).long()]
        return (w * valid).sum()

    @torch.inference_mode()
    def eval_step(self, batch: PointBatch, metrics: Optional[EvalMetrics] = None,
                  ) -> Tuple[EvalMetrics, Dict[str, torch.Tensor]]:
        """One eval batch: losses + confusion-matrix updates."""
        if metrics is None:
            metrics = EvalMetrics.create(self.num_classes, self.device)
        (grid, hier), _, flat2, flat3, ens, labels, mask = self._forward(batch)
        new = EvalMetrics(
            cm_2d=confusion_matrix_update(metrics.cm_2d, flat2.argmax(-1), labels, mask),
            cm_3d=confusion_matrix_update(metrics.cm_3d, flat3.argmax(-1), labels, mask),
            cm_avg=confusion_matrix_update(metrics.cm_avg, ens.argmax(-1), labels, mask),
        )
        logs = {
            "loss_segmentation": weighted_cross_entropy(
                flat2, labels, mask, self.class_weights),
            "loss_segmentation_3d": weighted_cross_entropy(
                flat3, labels, mask, self.class_weights),
            "valid_weight": self.seg_loss_weight(labels, mask),
            "nbr_slot_overflow": sum(
                lvl.slot_overflow.float() for lvl in hier.levels
            ) + torch.zeros((), device=self.device),
        }
        return new, logs
