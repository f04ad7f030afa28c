"""Sparse-depth occlusion filter (port of `mm2d3d_tpu/utils/depth.py`; the
reference's lib/utils/depth.py:5-36).

`filter_depth` removes occluded LiDAR returns from a sparse depth map: a
min-pool over a local window finds the nearest surface; points whose depth
exceeds it by a relative threshold are occluded background leaking through
foreground and get zeroed.  (No shipped config calls it.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def filter_depth(
    depth: torch.Tensor,  # (H, W) or (B, H, W, 1) sparse depth, 0 = no return
    kernel_size: int = 5,
    threshold: float = 0.1,
) -> torch.Tensor:
    squeeze = depth.ndim == 2
    if squeeze:
        depth = depth[None, ..., None]

    big = torch.where(depth > 0, depth, torch.full_like(depth, float("inf")))
    # the window's minimum, windows clipped at the border (-inf padding of
    # the negated map, as the JAX reduce_window)
    nearest = -F.max_pool2d(-big.permute(0, 3, 1, 2), kernel_size, stride=1,
                            padding=kernel_size // 2).permute(0, 2, 3, 1)
    occluded = (depth > 0) & ((depth - nearest) / nearest.clamp_min(1e-6) > threshold)
    out = torch.where(occluded, torch.zeros_like(depth), depth)
    return out[0, ..., 0] if squeeze else out
