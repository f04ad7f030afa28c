"""Seeded weights, made on the device in one draw.

Every weight of the published layout (`reference.nets.template2d`,
`template3d`) is drawn from one `torch.randn` call on the device's own
generator, in name order, and scaled: sparse kernels (K, Cin, Cout)
He-normal over K * Cin, dense kernels and linear layers LeCun-normal over
their fan-in (a transposed kernel's over Cin * kh * kw); BatchNorm scales 1,
biases and running means 0, running variances 1.  The same seed on the same
kind of device gives the same weights, which the program and the reference
are both handed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

Template = Dict[str, Tuple[int, ...]]


def init_std(name: str, shape: Tuple[int, ...]) -> Optional[float]:
    """The normal's standard deviation, or None for a constant leaf."""
    if name.endswith(("running_mean", "running_var", "bias")) or len(shape) == 1:
        return None
    if len(shape) == 3:  # sparse kernel (K, Cin, Cout)
        return math.sqrt(2.0 / (shape[0] * shape[1]))
    if len(shape) == 4:
        fan_in = (shape[0] if ".tconv." in name else shape[1]) * shape[2] * shape[3]
        return math.sqrt(1.0 / fan_in)
    return math.sqrt(1.0 / shape[1])  # linear (out, in)


def make_weights(templates: Dict[str, Template], seed: int,
                 device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{branch: {name: fp32 tensor on `device`}} for each template."""
    device = torch.device(device)
    names = [(br, n) for br in sorted(templates) for n in sorted(templates[br])]
    drawn = [(br, n) for br, n in names if init_std(n, templates[br][n]) is not None]
    total = sum(math.prod(templates[br][n]) for br, n in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out = {br: {} for br in templates}
    at = 0
    for br, n in names:
        shape = templates[br][n]
        std = init_std(n, shape)
        if std is not None:
            size = math.prod(shape)
            out[br][n] = pool[at:at + size].view(shape) * std
            at += size
        elif n.endswith("running_var") or (len(shape) == 1 and n.endswith("weight")):
            out[br][n] = torch.ones(shape, device=device)
        else:
            out[br][n] = torch.zeros(shape, device=device)
    return out
