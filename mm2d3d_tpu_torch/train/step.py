"""The cross-modal UDA task (port of `mm2d3d_tpu/train/step.py`).

`MM2D3DTask` holds the two networks and their optimizers.  `train_step` is
one step of the reference's recipe: both branches forward on the source and
the target batch in train mode, weighted CE on the source, cross-modal KL on
both domains, the backward through the sparse-conv adjoints, and one
optimizer step per branch.  `forward` is the fused 2D+3D forward with the
softmax ensemble that `__graft_entry__.entry` returns; `eval_step` adds the
eval losses and the 2D / 3D / ensemble confusion-matrix updates;
`viz_forward` gives the qualitative figures' predictions and
`point_predictions` the pseudo-label generator's.  All four run in eval
mode under `torch.inference_mode()`, through the task's own topology (its
slot profile).  Log keys are the JAX package's.

Every entry point runs on the CUDA device unless the caller passes
`device="cpu"`; without a CUDA device it raises instead of carrying on on
the CPU.  `train_step`, `train_inputs`, `forward` and `eval_step` take a
precomputed topology (`train.batch.build_topology`), as the JAX package's
`train_step` / `eval_step` do: with `slot_caps=None` it reaches the dense
27-tap submanifold convolution (K6) on every level.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..models.convert import from_flax
from ..models.net2d import Net2DSeg
from ..models.resnet2d import BatchNorm2d
from ..models.sparse_unet import (
    Conv1x1, DownConv, MaskedBatchNorm, Net3DSeg, ResidualBlock, SubmConv, UpConv,
)
from ..utils import profiling
from ..utils.profiling import span
from .batch import PointBatch, build_topology, flatten_points, prepare_device_batch
from .losses import IGNORE_INDEX, kl_consistency, weighted_cross_entropy
from .metrics import confusion_matrix_update
from .optim import make_optimizer, make_schedule


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; refuses a CUDA device where none exists."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


@dataclass
class EvalMetrics:
    """Confusion-matrix accumulators [gt, pred] for 2D / 3D / ensemble."""

    cm_2d: torch.Tensor
    cm_3d: torch.Tensor
    cm_avg: torch.Tensor

    @classmethod
    def create(cls, num_classes: int, device="cuda") -> "EvalMetrics":
        device = resolve_device(device)

        def z():
            return torch.zeros((num_classes, num_classes), dtype=torch.int32,
                               device=device)

        return cls(cm_2d=z(), cm_3d=z(), cm_avg=z())


def slot_overflow(hier) -> torch.Tensor:
    """Hits a hierarchy's slot tables dropped: the submanifold tiers' and
    the child slots' (0 = healthy; a drop voids the convolutions)."""
    return sum(t.float() for t in
               [lvl.slot_overflow for lvl in hier.levels]
               + [tr.cslot_overflow for tr in hier.transitions]
               if t is not None)


def _init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: He-normal sparse kernels (fan-in = taps * Cin), residual
    shortcuts and 1x1 convolutions (fan-in = Cin), LeCun-normal dense
    kernels, zero biases, identity batch norms (the frozen ones too)."""

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
        elif isinstance(m, ResidualBlock) and m.nin_kernel is not None:
            normal_(m.nin_kernel, m.nin_kernel.shape[0], 2.0)
        elif isinstance(m, Conv1x1):
            normal_(m.weight, m.weight.shape[0], 2.0)
        if getattr(m, "bn_scale", None) is not None:  # a frozen BatchNorm
            m.bn_scale.fill_(1.0)
            m.bn_bias.zero_()
            m.bn_mean.zero_()
            m.bn_var.fill_(1.0)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()


class MM2D3DTask:
    """Static task configuration, the two networks and their optimizers.

    `optimizer_2d` / `optimizer_3d` are reference-style configs for
    `optim.make_optimizer` (default AdamW, lr 1e-3, constant); the
    optimizers start afresh whenever weights are loaded (`init_params`,
    `load_flax`), as a new JAX `TrainState` does.  `model2d` / `model3d`
    replace the default networks, as in the JAX task (for example
    `Net2DSeg(..., fused_head=True)`, the fused head through K5).
    `slot_profile` is the slot-cap plan of every topology the task builds:
    "default" (32-beam nuScenes-style scans) or "dense" (64-beam
    KITTI-family scans; `train.batch.default_slot_caps`).
    `residual_blocks` and `frozen_batch_norm` shape the default networks,
    as in JAX; a 3D network that declares its topology (`num_levels`,
    `stem_kernel`: `models.sparse_unet.GatedTrunk`) gets that many levels,
    and level 0's 125-neighbour table where its stem is 5^3; an optimizer
    config's `accumulate_steps` k > 1 averages the
    gradients of k train steps per update (`optim.MultiSteps`), while the
    running statistics and `step` (and with it the dropout stream) move on
    every train step.  `group` is the process group of a data-parallel run
    (`parallel.mesh`), the counterpart of the JAX task's
    `axis_name="data"`: the train step then averages the gradients, the
    running statistics and the logs over its ranks; None trains alone."""

    def __init__(self, num_classes: int, class_weights=None,
                 loss_composer=None, lambda_xm_src: float = 1.0,
                 lambda_xm_trg: float = 0.1,
                 full_scale: int = 4096, num_planes: int = 7, m: int = 16,
                 block_reps: int = 1, residual_blocks: bool = False,
                 in_channels_3d: int = 3, frozen_batch_norm: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 optimizer_2d: Optional[Dict[str, Any]] = None,
                 optimizer_3d: Optional[Dict[str, Any]] = None,
                 model2d: Optional[nn.Module] = None,
                 model3d: Optional[nn.Module] = None, device="cuda",
                 slot_profile: str = "default", group=None):
        self.num_classes = num_classes
        self.group = group
        self.slot_profile = slot_profile
        self.loss_composer = loss_composer
        self.lambda_xm_src = lambda_xm_src
        self.lambda_xm_trg = lambda_xm_trg
        self.full_scale = full_scale
        self.device = resolve_device(device)
        self.class_weights = (
            None if class_weights is None
            else torch.tensor(class_weights, dtype=torch.float32, device=self.device)
        )
        self.model2d = (Net2DSeg(num_classes, compute_dtype,
                                 frozen_batch_norm=frozen_batch_norm)
                        if model2d is None else model2d)
        self.model3d = (Net3DSeg(num_classes, in_channels=in_channels_3d, m=m,
                                 block_reps=block_reps, num_planes=num_planes,
                                 compute_dtype=compute_dtype,
                                 residual_blocks=residual_blocks)
                        if model3d is None else model3d)
        self.num_planes = getattr(self.model3d, "num_levels", num_planes)
        self.stem_kernel = getattr(self.model3d, "stem_kernel", 3)
        for net in (self.model2d, self.model3d):
            net.eval()
        self.optimizer_2d = optimizer_2d or {"name": "adamw", "lr": 1e-3}
        self.optimizer_3d = optimizer_3d or {"name": "adamw", "lr": 1e-3}
        self.lr_schedule_2d = make_schedule(self.optimizer_2d.get("lr_scheduler"),
                                            self.optimizer_2d.get("lr", 1e-3))
        self.lr_schedule_3d = make_schedule(self.optimizer_3d.get("lr_scheduler"),
                                            self.optimizer_3d.get("lr", 1e-3))
        self._reset_optimizers()

    def current_lrs(self, step: int) -> Dict[str, float]:
        def at(s):
            return float(s(step)) if callable(s) else float(s)

        return {"lr/net2d": at(self.lr_schedule_2d), "lr/net3d": at(self.lr_schedule_3d)}

    def _reset_optimizers(self) -> None:
        self.step = 0
        self.opt2d, self.sched2d = make_optimizer(self.model2d.parameters(),
                                                  **self.optimizer_2d)
        self.opt3d, self.sched3d = make_optimizer(self.model3d.parameters(),
                                                  **self.optimizer_3d)

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
        self.load_state_dicts(*from_flax(params2d, stats2d, params3d, stats3d))

    def load_state_dicts(self, state2d: Mapping, state3d: Mapping) -> None:
        """Both networks' weights and running statistics, then to the
        device, with fresh optimizers."""
        self.model2d.load_state_dict(state2d, strict=True)
        self.model3d.load_state_dict(state3d, strict=True)
        self._to_device()

    def _to_device(self) -> None:
        self.model2d.to(self.device, memory_format=torch.channels_last)
        self.model3d.to(self.device)
        self._reset_optimizers()

    def build_topology(self, batch: PointBatch):
        """The batch's default topology under the task's slot profile, with
        the levels and tables the 3D network declares."""
        return build_topology(batch, self.full_scale, self.num_planes,
                              slot_profile=self.slot_profile,
                              stem_kernel=self.stem_kernel)

    # -- forward ---------------------------------------------------------

    def _forward(self, batch: PointBatch, topo=None):
        self.model2d.eval()
        self.model3d.eval()
        with span("prepare"):
            batch = prepare_device_batch(batch)
            _, feats, labels, mask, _ = flatten_points(batch)
        if topo is None:
            with span("topology"):
                topo = self.build_topology(batch)
        with span("net2d"):
            p2, _, _ = self.model2d(batch.img, batch.depth, batch.img_indices,
                                    batch.point_mask, with_features=False)
        with span("net3d"):
            p3, _, _ = self.model3d(feats, *topo)
        with span("metrics"):
            flat2 = p2["seg_logit"].reshape(-1, self.num_classes).float()
            flat3 = p3["seg_logit"].float()
            ens = (torch.softmax(flat2, -1) + torch.softmax(flat3, -1)) / 2
        return topo, p2, p3, flat2, flat3, ens, labels, mask

    @torch.inference_mode()
    def forward(self, batch: PointBatch, topo=None) -> Dict[str, torch.Tensor]:
        """{"seg_logit_2d": (B, N, nc) lifted 2D logits, "seg_logit_3d":
        (B*N, nc), "ensemble": (B*N, nc) mean of the two softmaxes}.
        `topo` is a precomputed (grid, hierarchy) of this batch, or None to
        build the default one."""
        _, p2, _, flat2, flat3, ens, _, _ = self._forward(batch, topo)
        return {"seg_logit_2d": p2["seg_logit"], "seg_logit_3d": flat3,
                "ensemble": ens}

    @torch.inference_mode()
    def viz_forward(self, batch: PointBatch, topo=None) -> Dict[str, torch.Tensor]:
        """The qualitative figure's predictions (JAX `viz_forward`):
        {"pred_2d_dense": (B, H, W) argmax of the dense 2D logits,
        "pred_2d_points", "pred_3d_points": (B, N) point argmaxes,
        "confidence": (B, N) the 3D branch's gate}."""
        _, p2, p3, flat2, flat3, _, _, _ = self._forward(batch, topo)
        b, n = batch.point_mask.shape
        return {"pred_2d_dense": p2["seg_logit_2d"].argmax(-1),
                "pred_2d_points": flat2.argmax(-1).reshape(b, n),
                "pred_3d_points": flat3.argmax(-1).reshape(b, n),
                "confidence": p3["confidence"].float().reshape(b, n)}

    @torch.inference_mode()
    def point_predictions(self, batch: PointBatch,
                          topo=None) -> Dict[str, torch.Tensor]:
        """Per point of the 2D and 3D softmaxes and their mean, the top
        probability and its class (the pseudo-label schema's keys,
        `probs_{2d,3d,ensemble}` and `pseudo_label_{...}`, each (B, N)),
        and "slot_overflow": the hits the slot tables dropped."""
        (_, hier), _, _, flat2, flat3, ens, _, _ = self._forward(batch, topo)
        b, n = batch.point_mask.shape
        out = {}
        for key, probs in (("2d", torch.softmax(flat2, -1)),
                           ("3d", torch.softmax(flat3, -1)), ("ensemble", ens)):
            top, label = probs.max(-1)
            out[f"probs_{key}"] = top.reshape(b, n)
            out[f"pseudo_label_{key}"] = label.reshape(b, n)
        out["slot_overflow"] = slot_overflow(hier) + torch.zeros((), device=flat2.device)
        return out

    def _seg_loss(self, logits, labels, mask):
        """The config's composed `losses:` list when a LossComposer is
        attached, else plain weighted CE."""
        if self.loss_composer is not None:
            return self.loss_composer("segmentation", logits, labels, mask)
        return weighted_cross_entropy(logits, labels, mask, self.class_weights)

    def seg_loss_weight(self, labels: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        """Sum of per-point class weights over valid points (the masked-mean
        loss's own denominator)."""
        cw = (self.loss_composer.class_weights("segmentation")
              if self.loss_composer is not None else self.class_weights)
        valid = ((labels != IGNORE_INDEX) & mask).float()
        if cw is None:
            return valid.sum()
        cw = torch.as_tensor(cw, dtype=torch.float32, device=labels.device)
        w = cw[torch.where(valid > 0, labels, 0).long()]
        return (w * valid).sum()

    # -- train -----------------------------------------------------------

    def train_inputs(self, src: PointBatch, trg: PointBatch, topo_src=None,
                     topo_trg=None):
        """The batches prepared and both topologies built (unless given):
        the first stage of `train_step` -> (src, trg, topo_src, topo_trg)."""
        with span("prepare"):
            src = prepare_device_batch(src)
            trg = prepare_device_batch(trg)
        # not inference_mode: the backward reads the tables
        with torch.no_grad(), span("topology"):
            if topo_src is None:
                topo_src = self.build_topology(src)
            if topo_trg is None:
                topo_trg = self.build_topology(trg)
        return src, trg, topo_src, topo_trg

    def train_losses(self, src: PointBatch, trg: PointBatch, topo_src, topo_trg,
                     generator: torch.Generator):
        """Both branches forward on both domains in train mode, and the
        losses: the second stage of `train_step` -> (total, losses).  The
        running statistics are threaded src -> trg: each train-mode forward
        moves them."""
        self.model2d.train()
        self.model3d.train()
        nc = self.num_classes
        with span("prepare"):
            _, feats_src, labels_src, mask_src, _ = flatten_points(src)
            _, feats_trg, _, mask_trg, _ = flatten_points(trg)

        # source domain
        with span("net2d"):
            p2s, _, a2s = self.model2d(src.img, src.depth, src.img_indices,
                                       src.point_mask, generator, with_features=False)
        with span("net3d"):
            p3s, _, a3s = self.model3d(feats_src, *topo_src)
        with span("losses"):
            flat2s = p2s["seg_logit"].reshape(-1, nc)
            seg_loss_src_2d = self._seg_loss(flat2s, labels_src, mask_src)
            seg_loss_src_3d = self._seg_loss(p3s["seg_logit"], labels_src, mask_src)
            xm_src_2d = kl_consistency(a2s["seg_logit_avg"].reshape(-1, nc),
                                       p3s["seg_logit"], mask_src)
            xm_src_3d = kl_consistency(a3s["seg_logit_point"], flat2s, mask_src)

        # target domain
        with span("net2d"):
            p2t, _, a2t = self.model2d(trg.img, trg.depth, trg.img_indices,
                                       trg.point_mask, generator, with_features=False)
        with span("net3d"):
            p3t, _, a3t = self.model3d(feats_trg, *topo_trg)
        with span("losses"):
            flat2t = p2t["seg_logit"].reshape(-1, nc)
            xm_trg_2d = kl_consistency(a2t["seg_logit_avg"].reshape(-1, nc),
                                       p3t["seg_logit"], mask_trg)
            xm_trg_3d = kl_consistency(a3t["seg_logit_point"], flat2t, mask_trg)

            loss_2d = (seg_loss_src_2d + self.lambda_xm_src * xm_src_2d
                       + self.lambda_xm_trg * xm_trg_2d)
            loss_3d = (seg_loss_src_3d + self.lambda_xm_src * xm_src_3d
                       + self.lambda_xm_trg * xm_trg_3d)
            total = loss_2d + loss_3d
        return total, {
            "train/loss_segmentation": seg_loss_src_2d,
            "train/loss_segmentation_3d": seg_loss_src_3d,
            "train/xm_loss_src_2d": xm_src_2d,
            "train/xm_loss_tgt_2d": xm_trg_2d,
            "train/xm_loss_src_3d": xm_src_3d,
            "train/xm_loss_tgt_3d": xm_trg_3d,
            "train/loss_total": total,
        }

    @profiling.step("train")
    def train_step(self, src: PointBatch, trg: PointBatch,
                   generator: torch.Generator, topo_src=None, topo_trg=None,
                   ) -> Dict[str, torch.Tensor]:
        """One UDA step on a source and a target batch; updates the weights,
        the running statistics and the optimizers in place and returns the
        logs.  `generator` (on the task's device) feeds the dropout;
        `topo_src` / `topo_trg` are precomputed topologies of the two
        batches, or None to build the default ones."""
        src, trg, topo_src, topo_trg = self.train_inputs(src, trg, topo_src,
                                                         topo_trg)
        total, losses = self.train_losses(src, trg, topo_src, topo_trg, generator)
        with span("optimizer"):
            self.opt2d.zero_grad(set_to_none=True)
            self.opt3d.zero_grad(set_to_none=True)
        with span("backward"):
            total.backward()

        with span("logs"):
            logs = {k: v.detach() for k, v in losses.items()}
            hiers = (topo_src[1], topo_trg[1])
            zero = torch.zeros((), device=self.device)
            # a level at capacity drops voxels; 0 = healthy
            logs["train/voxel_overflow_levels"] = sum(
                (lvl.num_voxels >= lvl.capacity).float()
                for h in hiers for lvl in h.levels) + zero
            # hits dropped by the slot tables (void the gradients); 0 = healthy
            logs["train/nbr_slot_overflow"] = sum(
                slot_overflow(h) for h in hiers) + zero
            if src.n_dropped is not None:
                logs["train/points_dropped"] = (
                    src.n_dropped.sum() + trg.n_dropped.sum()).float()
        if self.group is not None:
            # what the JAX step pmeans, where it does: after both domains'
            # forwards moved the running statistics, before the optimizers
            # (and `MultiSteps`' accumulation) read the gradients
            from ..parallel.mesh import all_mean

            nets = (self.model2d, self.model3d)
            all_mean([p.grad for net in nets for p in net.parameters()
                      if p.grad is not None]
                     + [b for net in nets for name, b in net.named_buffers()
                        if name.endswith(("running_mean", "running_var"))]
                     + list(logs.values()), self.group)

        with span("optimizer"):
            self.opt2d.step()
            self.opt3d.step()
            self.sched2d.step()
            self.sched3d.step()
        self.step += 1
        return logs

    @profiling.step("eval")
    @torch.inference_mode()
    def eval_step(self, batch: PointBatch, metrics: Optional[EvalMetrics] = None,
                  topo=None) -> Tuple[EvalMetrics, Dict[str, torch.Tensor]]:
        """One eval batch: losses + confusion-matrix updates.  `topo` is a
        precomputed topology of the batch, or None to build the default one."""
        (grid, hier), _, _, flat2, flat3, ens, labels, mask = self._forward(batch, topo)
        with span("metrics"):
            if metrics is None:
                metrics = EvalMetrics.create(self.num_classes, self.device)
            new = EvalMetrics(
                cm_2d=confusion_matrix_update(metrics.cm_2d, flat2.argmax(-1), labels, mask),
                cm_3d=confusion_matrix_update(metrics.cm_3d, flat3.argmax(-1), labels, mask),
                cm_avg=confusion_matrix_update(metrics.cm_avg, ens.argmax(-1), labels, mask),
            )
            logs = {
                "loss_segmentation": self._seg_loss(flat2, labels, mask),
                "loss_segmentation_3d": self._seg_loss(flat3, labels, mask),
                "valid_weight": self.seg_loss_weight(labels, mask),
                "nbr_slot_overflow": slot_overflow(hier)
                + torch.zeros((), device=self.device),
            }
        return new, logs
