"""Optimizer and learning-rate schedule factory (port of
`mm2d3d_tpu/train/optim.py`).

Optimizers {adamw, adam, sgd} are stock `torch.optim`, rmsprop is optax's
(`RMSprop` below: torch's adds eps outside the square root); schedules
{step, multi_step_lr, cosine_annealing, cyclic, one_cycle, constant} are the
JAX package's formulas (optax's and the torch-exact OneCycle), evaluated per
optimizer step and applied through a `LambdaLR`.  One optimizer per model,
stepped together, as the reference's HybridOptim.  `accumulate_steps` > 1
wraps the optimizer in `MultiSteps`, the counterpart of `optax.MultiSteps`.
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


class RMSprop(torch.optim.Optimizer):
    """`optax.rmsprop` (not centered, no Nesterov): per element
    nu <- alpha nu + (1 - alpha) g^2 and u = g / sqrt(nu + eps), then the
    learning rate, then momentum as optax's `trace`: m <- lr u + momentum m,
    p <- p - m (without momentum, p <- p - lr u)."""

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop takes no closure")
        for group in self.param_groups:
            lr, alpha, eps, momentum = (group[k] for k in
                                        ("lr", "alpha", "eps", "momentum"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.zeros_like(p)
                    if momentum:
                        state["momentum_buffer"] = torch.zeros_like(p)
                nu = state["square_avg"]
                nu.mul_(alpha).addcmul_(g, g, value=1 - alpha)
                u = g * torch.rsqrt(nu + eps)
                if momentum:
                    m = state["momentum_buffer"]
                    m.mul_(momentum).add_(u, alpha=lr)
                    p.sub_(m)
                else:
                    p.sub_(u, alpha=lr)


class MultiSteps:
    """`optax.MultiSteps(every_k_schedule=k)` around a torch optimizer: each
    `step()` folds the parameters' gradients into their running mean
    (optax's `acc + (g - acc) / (n + 1)`, a missing gradient counting as
    zero), and every k-th applies the inner optimizer, weight decay
    included, to the mean and starts a new one.  On the other calls the
    gradients are cleared and the inner step leaves every parameter
    untouched (torch's optimizers skip a parameter without a gradient).
    `state_dict` holds the inner optimizer's state, the running mean and
    the micro-step count, so a run resumed between micro-steps continues
    bit for bit."""

    def __init__(self, inner: torch.optim.Optimizer, k: int):
        self.inner = inner
        self.k = k
        self.mini_step = 0
        self.params = [p for g in inner.param_groups for p in g["params"]]
        self.acc = [torch.zeros_like(p, memory_format=torch.preserve_format)
                    for p in self.params]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, a in zip(self.params, self.acc):
            if p.grad is not None:
                a.add_((p.grad - a) / (n + 1))
            else:
                a.sub_(a / (n + 1))
        self.mini_step = (n + 1) % self.k
        emit = self.mini_step == 0
        for p, a in zip(self.params, self.acc):
            p.grad = a.clone() if emit else None
            if emit:
                a.zero_()
        self.inner.step()

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, state) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        with torch.no_grad():
            for a, b in zip(self.acc, state["acc"]):
                a.copy_(b)


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adamw",
                   lr: float = 1e-3,
                   lr_scheduler: Optional[Dict[str, Any]] = None,
                   weight_decay: Optional[float] = None,
                   accumulate_steps: int = 1, **kwargs
                   ) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    """-> (optimizer, its LambdaLR); step both once per train step.

    The update rules equal optax's: AdamW decays from the pre-update
    weights, Adam's eps is outside the root, rmsprop's inside.  With
    `accumulate_steps` k > 1 the optimizer is a `MultiSteps` and the
    schedule's rate at micro-step m is the rate of update m // k, so both
    are still stepped once per train step."""
    if not isinstance(accumulate_steps, int) or accumulate_steps < 1:
        raise ValueError(f"accumulate_steps must be an integer >= 1, got "
                         f"{accumulate_steps!r}")
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
        opt = RMSprop(params, lr=1.0, alpha=kwargs.get("alpha", 0.99),
                      eps=kwargs.get("eps", 1e-8),
                      momentum=kwargs.get("momentum", 0.0))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    k = accumulate_steps
    rate = (lambda step: schedule(step // k)) if callable(schedule) else (
        lambda step: schedule)
    sched = LambdaLR(opt, rate)
    return (opt if k == 1 else MultiSteps(opt, k)), sched
