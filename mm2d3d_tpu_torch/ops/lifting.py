"""2D -> 3D lifting (port of `mm2d3d_tpu/ops/lifting.py`): gather per-pixel
features at each point's image coordinates; masked points get zeros."""

from __future__ import annotations

import torch


def lift_image_features(feature_map: torch.Tensor, img_indices: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """feature_map (B, H, W, C), img_indices (B, N, 2) (row, col), mask (B, N)
    -> (B, N, C).  Indices are clamped into the image first, as in JAX."""
    b, h, w, _ = feature_map.shape
    rows = img_indices[..., 0].clamp(0, h - 1).long()
    cols = img_indices[..., 1].clamp(0, w - 1).long()
    bidx = torch.arange(b, device=feature_map.device)[:, None]
    out = feature_map[bidx, rows, cols]
    return torch.where(mask[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
