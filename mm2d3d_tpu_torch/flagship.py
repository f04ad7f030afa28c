"""The flagship task configuration (port of `mm2d3d_tpu/flagship.py`).

nuScenes USA->Singapore: 6 classes with the computed class weights, a
7-plane m=16 sparse U-Net over full_scale 4096, bf16 compute; cross-modal
KL weights 1.0 on the source and 0.1 on the target.
"""

from __future__ import annotations

import torch

from .train.step import MM2D3DTask

CLASS_WEIGHTS = [1.9241476, 1.0, 2.16763851, 2.78254323, 1.54875664, 1.85686537]


def flagship_task(compute_dtype=None, device="cuda", **over) -> MM2D3DTask:
    """The flagship task on `device` (the CUDA device unless the caller
    passes "cpu"; raises where there is none); `over` overrides any
    `MM2D3DTask` argument, such as `model2d`."""
    kwargs = dict(
        num_classes=6,
        class_weights=CLASS_WEIGHTS,
        lambda_xm_src=1.0,
        lambda_xm_trg=0.1,
        full_scale=4096,
        num_planes=7,
        m=16,
        compute_dtype=compute_dtype or torch.bfloat16,
        device=device,
    )
    kwargs.update(over)
    return MM2D3DTask(**kwargs)
