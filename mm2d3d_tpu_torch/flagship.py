"""The flagship task configuration (port of `mm2d3d_tpu/flagship.py`).

nuScenes USA->Singapore: 6 classes with the computed class weights, a
7-plane m=16 sparse U-Net over full_scale 4096, bf16 compute.
"""

from __future__ import annotations

import torch

from .train.step import MM2D3DTask

CLASS_WEIGHTS = [1.9241476, 1.0, 2.16763851, 2.78254323, 1.54875664, 1.85686537]


def flagship_task(compute_dtype=None, device="cpu", **over) -> MM2D3DTask:
    kwargs = dict(
        num_classes=6,
        class_weights=CLASS_WEIGHTS,
        full_scale=4096,
        num_planes=7,
        m=16,
        compute_dtype=compute_dtype or torch.bfloat16,
        device=device,
    )
    kwargs.update(over)
    return MM2D3DTask(**kwargs)
