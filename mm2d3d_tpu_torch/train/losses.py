"""Training losses (port of `mm2d3d_tpu/train/losses.py`).

- `weighted_cross_entropy`: the masked-mean form of
  `F.cross_entropy(pred, gt, weight=w)` with ignore_index -100: each valid
  point contributes weight w[label].
- `kl_consistency`: KL(softmax(teacher) || softmax(student)) per point,
  summed over classes, mean over valid points; the teacher is detached.
- `LossComposer`: the config's `losses:` list (names, weights, targets).
- `l1_masked`, `l2_masked`: depth losses over gt > 0.
"""

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


def kl_consistency(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """KL(softmax(teacher) || softmax(student)), mean over valid points;
    no gradient reaches the teacher."""
    t = teacher_logits.detach().float()
    log_p = torch.log_softmax(t, dim=-1)
    log_q = torch.log_softmax(student_logits.float(), dim=-1)
    per_point = (log_p.exp() * (log_p - log_q)).sum(-1)
    m = valid.float()
    return (per_point * m).sum() / torch.clamp(m.sum(), min=1e-12)


def l1_masked(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean |pred - gt| over gt > 0."""
    mask = (gt > 0).float()
    return ((pred - gt).abs() * mask).sum() / torch.clamp(mask.sum(), min=1e-12)


def l2_masked(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean (pred - gt)^2 over gt > 0."""
    mask = (gt > 0).float()
    return ((pred - gt).square() * mask).sum() / torch.clamp(mask.sum(), min=1e-12)


class LossComposer:
    """Config-driven loss registry and composer.

    `cfg` is a name, a list of names, or a list of {name, weight, target,
    args} dicts; calling with a target sums weight * loss over the entries
    whose target matches.  Registry: cross_entropy (segmentation), l1 and l2
    (depth)."""

    _REGISTRY = {
        "cross_entropy": ("segmentation",),
        "l1": ("depth",),
        "l2": ("depth",),
    }

    def __init__(self, cfg):
        if isinstance(cfg, str):
            cfg = [cfg]
        self._entries = []
        for item in cfg:
            if isinstance(item, str):
                item = {"name": item}
            name = item["name"]
            if name not in self._REGISTRY:
                raise ValueError(f"unknown loss {name!r}")
            self._entries.append({
                "name": name,
                "weight": item.get("weight", 1.0),
                "target": item.get("target", self._REGISTRY[name][0]),
                "args": dict(item.get("args", {})),
            })

    def update_loss_params(self, name: str, target: str, **kwargs):
        """Update the `args` of every entry named `name` for `target` (for
        example `weight=` of the cross entropy)."""
        for e in self._entries:
            if e["name"] == name and e["target"] == target:
                e["args"].update(kwargs)

    def targets(self):
        """The set of loss targets this composer serves."""
        return {e["target"] for e in self._entries}

    def class_weights(self, target: str = "segmentation"):
        for e in self._entries:
            if e["target"] == target and "weight" in e["args"]:
                return e["args"]["weight"]
        return None

    def __call__(self, target: str, pred, gt, valid=None):
        entries = [e for e in self._entries if e["target"] == target]
        if not entries:
            raise RuntimeError(f"no losses for target {target!r}")
        out = 0.0
        for e in entries:
            if e["name"] == "cross_entropy":
                w = e["args"].get("weight")
                loss = weighted_cross_entropy(
                    pred, gt, valid,
                    None if w is None else torch.as_tensor(
                        w, dtype=torch.float32, device=pred.device))
            elif e["name"] == "l1":
                loss = l1_masked(pred, gt)
            else:
                loss = l2_masked(pred, gt)
            out = out + e["weight"] * loss
        return out

    def __repr__(self):
        return "+".join(
            f"{e['weight'] if e['weight'] != 1.0 else ''}{e['name']}"
            for e in self._entries
        )
