"""Device-side colour jitter (port of `mm2d3d_tpu/ops/image.py`).

The wire format ships uint8 pixels plus a per-sample (4,) parameter vector
[f_brightness, f_contrast, f_saturation, order_index] drawn on the host;
`prepare_device_batch` applies the jitter on the device after the /255.
"""

from __future__ import annotations

import itertools

import torch

# canonical op order (brightness, contrast, saturation); the host encodes the
# applied order as an index into these 6 permutations
JITTER_PERMS = tuple(itertools.permutations(range(3)))

_GRAY = (0.299, 0.587, 0.114)


def _gray(im: torch.Tensor) -> torch.Tensor:
    return _GRAY[0] * im[..., 0] + _GRAY[1] * im[..., 1] + _GRAY[2] * im[..., 2]


def _brightness(im, f):
    return im * f


def _contrast(im, f):
    return im * f + _gray(im).mean() * (1.0 - f)


def _saturation(im, f):
    return im * f + _gray(im)[..., None] * (1.0 - f)


_OPS = (_brightness, _contrast, _saturation)


def _jitter_one(im: torch.Tensor, params: torch.Tensor, order: int) -> torch.Tensor:
    for k in JITTER_PERMS[order]:
        im = _OPS[k](im, params[k])
    return torch.clamp(im, 0.0, 1.0)


def apply_color_jitter(img: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, 3) float32 in [0, 1]; params (B, 4) float32
    [f_brightness, f_contrast, f_saturation, order_index] -> (B, H, W, 3),
    clipped to [0, 1].  The op orders are read on the host (one small copy
    per batch); each sample runs its own order, as `jax.lax.switch` does."""
    orders = params[:, 3].to(torch.int32).tolist()
    return torch.stack([_jitter_one(img[i], params[i], o)
                        for i, o in enumerate(orders)])
