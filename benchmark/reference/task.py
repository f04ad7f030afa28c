"""The cross-modal UDA task around the two networks.

Inputs: the wire batch (uint8 image) is taken to [0, 1] as float32(1/255)
times the byte, and the 3D branch's point features are the RGB of each
point's pixel.  Losses: class-weighted cross-entropy on the source labels
(2D and 3D), and the cross-modal KL(softmax(teacher) || softmax(student)),
each branch's auxiliary head the student of the other branch's main head
(detached), on both domains, weighted lambda_xm_src and lambda_xm_trg.  One
train step sums the losses of both domains, back-propagates, and takes one
AdamW step per branch (weight decay from the pre-update weights) at the
one-cycle rate of that step.  Eval: both branches in eval mode, the mean of
the two softmaxes as the ensemble, and the 2D, 3D and ensemble confusion
matrices [label, prediction] over the labelled valid points.  The 3D
network is the configuration's (`models.net3d.name`), found in `arch3d`.

`Reference(config, weights, device, q)`: `q` is the operand precision of
every product (`quant.fp32`, the reference; `quant.fp8`, the control).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.optim.lr_scheduler import OneCycleLR

from . import arch3d, nets
from .quant import fp32
from .voxels import Voxels, voxelize

IGNORE = -100


def prepare(batch: Dict[str, np.ndarray], device, half: bool = False
            ) -> Dict[str, torch.Tensor]:
    """A wire batch on `device`: the float image, the point features
    (B*N, 3), and the raw tables; `half` keeps the first half of the scans
    (the planted fault "half of the batch left out")."""
    t = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if half:
        t = {k: v[: v.shape[0] // 2] for k, v in t.items()}
    img = t["img"].to(torch.float32) * float(np.float32(1.0 / 255.0))
    b, n = t["point_mask"].shape
    idx = t["img_indices"].long()
    feats = img[torch.arange(b, device=img.device)[:, None], idx[..., 0], idx[..., 1]]
    return {**t, "img": img, "feats": feats.reshape(b * n, 3)}


def weighted_ce(logits, labels, valid, class_weights):
    mask = (labels != IGNORE) & valid
    safe = torch.where(mask, labels, 0).long()
    nll = -torch.log_softmax(logits, -1).gather(1, safe[:, None])[:, 0]
    w = class_weights[safe] * mask
    return (w * nll).sum() / w.sum().clamp(min=1e-12)


def kl_xm(student, teacher, valid):
    log_p = torch.log_softmax(teacher.detach(), -1)
    log_q = torch.log_softmax(student, -1)
    per_point = (log_p.exp() * (log_p - log_q)).sum(-1)
    m = valid.float()
    return (per_point * m).sum() / m.sum().clamp(min=1e-12)


def confusion(pred, labels, valid, nc: int) -> torch.Tensor:
    keep = (labels != IGNORE) & valid
    return torch.bincount(labels[keep].long() * nc + pred[keep].long(),
                          minlength=nc * nc).reshape(nc, nc)


def rates(opt_cfg: Dict, n: int) -> List[float]:
    """The learning rate of the first n optimizer steps: torch's
    OneCycleLR (cosine), or the constant `lr`."""
    sched = opt_cfg.get("lr_scheduler")
    if sched is None or sched["name"] == "constant":
        return [float(opt_cfg["lr"])] * n
    if sched["name"] != "one_cycle":
        raise ValueError(f"the reference has no {sched['name']!r} schedule")
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.SGD([p], lr=sched["max_lr"])
    oc = OneCycleLR(opt, max_lr=sched["max_lr"], total_steps=sched["total_steps"],
                    pct_start=sched.get("pct_start", 0.3),
                    div_factor=sched.get("div_factor", 25.0),
                    final_div_factor=sched.get("final_div_factor", 1e4))
    out = []
    for _ in range(n):
        out.append(float(opt.param_groups[0]["lr"]))
        opt.step()
        oc.step()
    return out


class AdamW:
    """Adam with decoupled weight decay: p <- p (1 - lr wd), then
    p <- p - lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict):
        if cfg.get("name", "adamw") != "adamw":
            raise ValueError(f"the reference has no {cfg['name']!r} optimizer")
        self.params = params
        self.wd = cfg.get("weight_decay", 0.01)
        self.b1, self.b2 = cfg.get("b1", 0.9), cfg.get("b2", 0.999)
        self.eps = cfg.get("eps", 1e-8)
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - lr * self.wd)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = sorted(tensors)
    vals = torch.stack([tensors[k].double().norm() for k in keys]).tolist()
    return dict(zip(keys, vals))


class Reference:
    def __init__(self, config: Dict, weights: Dict[str, torch.Tensor], device,
                 q=fp32):
        self.device = torch.device(device)
        self.q = q
        self.nc = config["num_classes"]
        self.config = config
        self.net3d = arch3d.lookup(config)
        b3 = config["models"]["net3d"]["backbone_3d"]
        self.full_scale = b3["full_scale"]
        self.num_planes = b3["num_planes"]
        ce = [e for e in config["losses"] if e["name"] == "cross_entropy"][0]
        self.ce_weight = float(ce.get("weight", 1.0))
        self.class_weights = torch.tensor(ce["args"]["weight"], dtype=torch.float32,
                                          device=self.device)
        params = config["train"]["params"]
        self.lam_src, self.lam_trg = params["lambda_xm_src"], params["lambda_xm_trg"]
        self.opt_cfg = {"2d": config["models"]["net2d"]["optimizer"],
                        "3d": config["models"]["net3d"]["optimizer"]}
        self.W = {}
        for branch in ("2d", "3d"):
            self.W[branch] = {
                n: w.detach().to(self.device, torch.float32).clone().requires_grad_(
                    not nets.is_statistic(n))
                for n, w in weights[branch].items()}

    def params(self, branch: str) -> Dict[str, torch.Tensor]:
        return {n: w for n, w in self.W[branch].items() if not nets.is_statistic(n)}

    def voxels(self, b: Dict[str, torch.Tensor]) -> Voxels:
        return voxelize(b["coords"], b["point_mask"], self.full_scale, self.num_planes)

    def forward(self, b: Dict[str, torch.Tensor], train: bool, gen=None):
        p2 = nets.net2d(self.W["2d"], b["img"], b["depth"], b["img_indices"],
                        b["point_mask"], train, gen, self.q)
        p3 = self.net3d.forward(self.W["3d"], b["feats"], self.voxels(b), self.config,
                                train, self.q)
        return ({k: v.reshape(-1, self.nc) for k, v in p2.items()}, p3)

    def seg_loss(self, logits, labels, valid):
        return self.ce_weight * weighted_ce(logits, labels, valid, self.class_weights)

    def _domain_loss(self, b, gen, source: bool):
        p2, p3 = self.forward(b, True, gen)
        labels = b["seg_label"].reshape(-1)
        valid = b["point_mask"].reshape(-1)
        lam = self.lam_src if source else self.lam_trg
        loss = lam * (kl_xm(p2["seg_logit_avg"], p3["seg_logit"], valid)
                      + kl_xm(p3["seg_logit_point"], p2["seg_logit"], valid))
        if source:
            loss = (loss + self.seg_loss(p2["seg_logit"], labels, valid)
                    + self.seg_loss(p3["seg_logit"], labels, valid))
        return loss

    def train_steps(self, pairs: Sequence, gen: torch.Generator,
                    half: bool = False) -> Dict:
        """Steps over `pairs` of wire batches -> {"losses": [total per step],
        "grad_norms": {leaf: norm of its first gradient}, "change_norms":
        {leaf: norm of its change over all the steps}}; leaves are named
        "2d:<name>" and "3d:<name>".  Each domain's loss is back-propagated
        on its own (the gradient of the sum), which halves the peak."""
        leaves = {f"{br}:{n}": p for br in ("2d", "3d") for n, p in self.params(br).items()}
        start = {k: p.detach().clone() for k, p in leaves.items()}
        opts = {br: AdamW(self.params(br), self.opt_cfg[br]) for br in ("2d", "3d")}
        lrs = {br: rates(self.opt_cfg[br], len(pairs)) for br in ("2d", "3d")}
        losses, grad_norms = [], None
        for s, (src, trg) in enumerate(pairs):
            for p in leaves.values():
                p.grad = None
            total = 0.0
            for batch, source in ((src, True), (trg, False)):
                loss = self._domain_loss(prepare(batch, self.device, half), gen, source)
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            if s == 0:
                grad_norms = _norms({k: p.grad for k, p in leaves.items()})
            for br in ("2d", "3d"):
                opts[br].step(lrs[br][s])
        change_norms = _norms({k: p.detach() - start[k] for k, p in leaves.items()})
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, np.ndarray], half: bool = False) -> Dict:
        """One eval batch -> point logits (valid points' rows), the three
        confusion matrices and the two segmentation losses."""
        b = prepare(batch, self.device, half)
        p2, p3 = self.forward(b, False)
        flat2, flat3 = p2["seg_logit"], p3["seg_logit"]
        ens = (torch.softmax(flat2, -1) + torch.softmax(flat3, -1)) / 2
        labels = b["seg_label"].reshape(-1)
        valid = b["point_mask"].reshape(-1)
        return {
            "logit_2d": flat2, "logit_3d": flat3, "valid": valid,
            "cm_2d": confusion(flat2.argmax(-1), labels, valid, self.nc),
            "cm_3d": confusion(flat3.argmax(-1), labels, valid, self.nc),
            "cm_avg": confusion(ens.argmax(-1), labels, valid, self.nc),
            "loss_segmentation": float(self.seg_loss(flat2, labels, valid)),
            "loss_segmentation_3d": float(self.seg_loss(flat3, labels, valid)),
        }
