"""The system under test, `mm2d3d_tpu_torch`, as the benchmark drives it.

Imported only inside the functions here, after the run has set its cache
directories and checked for a card.  The task is built from the
configuration by the program's own `run.build_task`, as the command line
builds it; weights are the benchmark's (`MM2D3DTask.load_state_dicts`);
batches are the benchmark's wire batches (uint8 image, features gathered on
the card by `prepare_device_batch`).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def build_kernels() -> None:
    """Build (first run of a checkout) or load every kernel library."""
    from mm2d3d_tpu_torch.ops import kernels

    kernels.build_all()


def build_task(config: Dict, weights: Dict[str, Dict[str, torch.Tensor]], device):
    from mm2d3d_tpu_torch.run import build_task as build

    task = build(config, config["num_classes"], device=device)
    task.load_state_dicts(weights["2d"], weights["3d"])
    return task


def point_batch(batch: Dict[str, np.ndarray], device):
    from mm2d3d_tpu_torch.train.batch import PointBatch

    t = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    return PointBatch(img=t["img"], depth=t["depth"], img_indices=t["img_indices"],
                      coords=t["coords"], feats=None, seg_label=t["seg_label"],
                      point_mask=t["point_mask"], coords_sorted=True,
                      feats_from_img=True)


def leaves(task) -> Dict[str, torch.nn.Parameter]:
    """Every trained leaf, named "2d:<name>" / "3d:<name>"."""
    return {f"{br}:{n}": p for br, net in (("2d", task.model2d), ("3d", task.model3d))
            for n, p in net.named_parameters()}


def first_grad_norms(task) -> Dict[str, float]:
    """Each leaf's gradient as its optimizer took it in the first step,
    worked out from the optimizer's state: exp_avg = (1 - beta1) g."""
    out = {}
    for br, net, opt in (("2d", task.model2d, task.opt2d), ("3d", task.model3d, task.opt3d)):
        b1 = opt.param_groups[0]["betas"][0]
        names = [n for n, _ in net.named_parameters()]
        norms = torch.stack([opt.state[p]["exp_avg"].double().norm()
                             for _, p in net.named_parameters()]) / (1 - b1)
        out.update({f"{br}:{n}": v for n, v in zip(names, norms.tolist())})
    return out


def overflow(logs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Voxels and rulebook hits one call dropped (0 = healthy)."""
    keys = ("train/voxel_overflow_levels", "train/nbr_slot_overflow", "nbr_slot_overflow")
    return sum(logs[k].float() for k in keys if k in logs)


def spconv_modules(task, classes: Sequence[str]) -> List[torch.nn.Module]:
    """The 3D network's modules of the `classes` (dotted names of the
    program's classes, as the network's `reference.arch3d` module lists
    them), in the network's order."""
    types = []
    for dotted in classes:
        module, _, name = dotted.rpartition(".")
        types.append(getattr(importlib.import_module(module), name))
    return [m for m in task.model3d.modules() if isinstance(m, tuple(types))]


def layer_modules(task, spconv_classes: Sequence[str]) -> List[Tuple[torch.nn.Module, str]]:
    return ([(task.model2d, "net2d"), (task.model3d, "net3d")]
            + [(m, "spconv") for m in spconv_modules(task, spconv_classes)])


def eval_metrics(task):
    from mm2d3d_tpu_torch.train.step import EvalMetrics

    return EvalMetrics.create(task.num_classes, task.device)
