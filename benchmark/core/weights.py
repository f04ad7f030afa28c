"""Seeded weights, made on the device in one draw.

Every weight of a template (`{name: shape}`: the 2D network's
`reference.nets.template2d`, a 3D network's `template` in its module of
`reference.arch3d`) is drawn from one `torch.randn` call on the device's
own generator, in name order, and scaled: sparse kernels (K, Cin, Cout)
He-normal over K * Cin, dense kernels and linear layers LeCun-normal over
their fan-in (a transposed kernel's over Cin * kh * kw, a leaf whose layout
is not (out, in, ...) over the fan-in its network's module gives);
BatchNorm scales 1, biases and running means 0, running variances 1.  The
same seed on the same kind of device gives the same weights, which the
program and the reference are both handed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

Template = Dict[str, Tuple[int, ...]]
FanIn = Callable[[str, Tuple[int, ...]], Optional[int]]


def init_std(name: str, shape: Tuple[int, ...],
             fan_in: Optional[int] = None) -> Optional[float]:
    """The normal's standard deviation, or None for a constant leaf;
    `fan_in` where the leaf's layout does not give it."""
    if name.endswith(("running_mean", "running_var", "bias")) or len(shape) == 1:
        return None
    if len(shape) == 3:  # sparse kernel (K, Cin, Cout)
        return math.sqrt(2.0 / (fan_in or shape[0] * shape[1]))
    if fan_in is None:  # (out, in, ...), a transposed kernel (in, out, ...)
        fan_in = (shape[0] if ".tconv." in name else shape[1]) * math.prod(shape[2:])
    return math.sqrt(1.0 / fan_in)


def make_weights(templates: Dict[str, Template], seed: int, device,
                 fan_in: Optional[Dict[str, Optional[FanIn]]] = None
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{branch: {name: fp32 tensor on `device`}} for each template;
    `fan_in[branch]`, where given, gives a leaf's fan-in where its layout
    does not."""
    device = torch.device(device)
    names = [(br, n) for br in sorted(templates) for n in sorted(templates[br])]
    fan_in = fan_in or {}

    def std_of(br: str, n: str) -> Optional[float]:
        fan, shape = fan_in.get(br), templates[br][n]
        return init_std(n, shape, fan(n, shape) if fan else None)

    stds = {(br, n): std_of(br, n) for br, n in names}
    total = sum(math.prod(templates[br][n]) for br, n in names if stds[br, n] is not None)
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out = {br: {} for br in templates}
    at = 0
    for br, n in names:
        shape = templates[br][n]
        std = stds[br, n]
        if std is not None:
            size = math.prod(shape)
            out[br][n] = pool[at:at + size].view(shape) * std
            at += size
        elif n.endswith("running_var") or (len(shape) == 1 and n.endswith("weight")):
            out[br][n] = torch.ones(shape, device=device)
        else:
            out[br][n] = torch.zeros(shape, device=device)
    return out
