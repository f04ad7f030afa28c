"""Operand precision of the reference's products.

`fp32` leaves operands as they are: the reference proper.  `fp8` rounds
every product operand (convolution and sparse-convolution inputs and
weights) to float8 e4m3 with a per-tensor scale, amax -> 448, as fp8
training recipes do, and passes gradients straight through: the control,
the step below the configuration's bf16 compute.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())  # straight-through


PRECISIONS = {"fp32": fp32, "fp8": fp8}
