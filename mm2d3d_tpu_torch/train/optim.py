"""Optimizer and learning-rate schedule factory (port of
`mm2d3d_tpu/train/optim.py`).

Optimizers {adamw, adam, sgd, rmsprop} are stock `torch.optim`; schedules
{step, multi_step_lr, cosine_annealing, cyclic, one_cycle, constant} are the
JAX package's formulas (optax's and the torch-exact OneCycle), evaluated per
optimizer step and applied through a `LambdaLR`.  One optimizer per model,
stepped together, as the reference's HybridOptim.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import torch
from torch.optim.lr_scheduler import LambdaLR

Schedule = Union[float, Callable[[int], float]]


def make_schedule(cfg: Optional[Dict[str, Any]], base_lr: float) -> Schedule:
    """The learning rate at each optimizer step (0 for the first update) for
    a reference-style lr_scheduler config; a constant `base_lr` for None."""
    if cfg is None:
        return base_lr
    name = cfg["name"]
    if name == "one_cycle":
        # torch-exact OneCycleLR (cos anneal): warmup spans pct_start*total - 1
        # steps
        total = cfg["total_steps"]
        max_lr = cfg["max_lr"]
        initial = max_lr / cfg.get("div_factor", 25.0)
        min_lr = initial / cfg.get("final_div_factor", 1e4)
        su = max(float(cfg.get("pct_start", 0.3)) * total - 1, 1.0)
        sd = max(total - su - 1, 1.0)

        def one_cycle(step: int) -> float:
            if step <= su:
                return initial + (max_lr - initial) * 0.5 * (
                    1 - math.cos(math.pi * min(step, su) / su))
            t = min(max((step - su) / sd, 0.0), 1.0)
            return min_lr + (max_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * t))

        return one_cycle
    if name == "step":
        # torch StepLR(step_size, gamma) = optax.exponential_decay(staircase)
        size, gamma = cfg["step_size"], cfg.get("gamma", 0.1)
        return lambda step: base_lr * gamma ** (step // size)
    if name == "multi_step_lr":
        # optax.piecewise_constant_schedule: scaled from each milestone on
        gamma = cfg.get("gamma", 0.1)
        milestones = sorted(int(m) for m in cfg["milestones"])
        return lambda step: base_lr * gamma ** sum(step >= m for m in milestones)
    if name == "cosine_annealing":
        # optax.cosine_decay_schedule(decay_steps=T_max, alpha=eta_min/lr)
        t_max = cfg["T_max"]
        alpha = cfg.get("eta_min", 0.0) / max(base_lr, 1e-12)

        def cosine(step: int) -> float:
            c = 0.5 * (1 + math.cos(math.pi * min(step, t_max) / t_max))
            return base_lr * ((1 - alpha) * c + alpha)

        return cosine
    if name == "cyclic":
        # optax.join_schedules of two linear ramps: base -> peak over `up`
        # steps, then back down to base, where it stays
        base = cfg.get("base_lr", base_lr)
        peak = cfg["max_lr"]
        up = cfg.get("step_size_up", 2000)

        def cyclic(step: int) -> float:
            if step < up:
                return base + (peak - base) * step / up
            return peak + (base - peak) * min(step - up, up) / up

        return cyclic
    if name == "constant":
        return base_lr
    raise ValueError(f"unknown scheduler {name!r}")


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adamw",
                   lr: float = 1e-3,
                   lr_scheduler: Optional[Dict[str, Any]] = None,
                   weight_decay: Optional[float] = None,
                   accumulate_steps: int = 1, **kwargs
                   ) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    """-> (optimizer, its LambdaLR); step both once per train step.

    The update rules equal optax's (AdamW decays from the pre-update
    weights, eps outside the root), except rmsprop: optax adds eps inside
    the square root, torch outside, which differs by about eps / mean(g^2)
    relative."""
    if accumulate_steps > 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    schedule = make_schedule(lr_scheduler, lr)
    # every group starts at lr 1, so the LambdaLR's factor is the rate itself
    if name == "adamw":
        opt = torch.optim.AdamW(
            params, lr=1.0, betas=(kwargs.get("b1", 0.9), kwargs.get("b2", 0.999)),
            eps=kwargs.get("eps", 1e-8),
            weight_decay=0.01 if weight_decay is None else weight_decay)
    elif name == "adam":
        opt = torch.optim.Adam(
            params, lr=1.0, betas=(kwargs.get("b1", 0.9), kwargs.get("b2", 0.999)),
            eps=kwargs.get("eps", 1e-8))
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=1.0, momentum=kwargs.get("momentum", 0.0),
                              nesterov=kwargs.get("nesterov", False))
    elif name == "rmsprop":
        opt = torch.optim.RMSprop(params, lr=1.0, alpha=kwargs.get("alpha", 0.99),
                                  eps=kwargs.get("eps", 1e-8),
                                  momentum=kwargs.get("momentum", 0.0))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    rate = schedule if callable(schedule) else (lambda step: schedule)
    return opt, LambdaLR(opt, rate)
