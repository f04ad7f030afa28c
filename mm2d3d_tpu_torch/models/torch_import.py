"""Import reference weights into the port's `Net2DSeg` (port of
`mm2d3d_tpu/models/torch_import.py`): torchvision ResNet-34 weights into
the RGB encoder, and a whole Net2DSeg checkpoint of the reference MM2D3D.

The reference initialises its RGB encoder from torchvision's pretrained
resnet34 and copies conv1's 7x7 kernels into the stride-1 stem.  The port's
modules keep torchvision's layouts (OIHW convs, ConvTranspose2d's
(in, out, kh, kw), BatchNorm weight / bias / running statistics), so both
imports only rename: torchvision's ``conv1`` / ``bn1`` become the encoder's
stem (``stem_rgb`` / ``stem_depth``, which `Net2DSeg` hoists out of the
encoder into its fused dual stem) and ``layer{i}.{b}`` becomes
``<encoder>.layer{i}_{b}``; ``fc`` and ``num_batches_tracked`` have no
counterpart.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import torch

STAGE_SIZES = (3, 4, 6, 3)
_BN = ("weight", "bias", "running_mean", "running_var")


def _encoder_pairs(src: str, stem: str, trunk: str,
                   keys) -> Iterator[Tuple[str, str]]:
    """(port key, source key) of one ResNet-34 encoder whose torchvision
    keys start with `src`; `keys` tells which blocks have a downsample."""

    def conv_bn(dst: str, conv: str, bn: str):
        yield f"{dst}.conv.weight", f"{src}{conv}.weight"
        for leaf in _BN:
            yield f"{dst}.bn.{leaf}", f"{src}{bn}.{leaf}"

    yield from conv_bn(stem, "conv1", "bn1")
    for i, blocks in enumerate(STAGE_SIZES, start=1):
        for b in range(blocks):
            t, name = f"layer{i}.{b}", f"{trunk}.layer{i}_{b}"
            yield from conv_bn(f"{name}.cb1", f"{t}.conv1", f"{t}.bn1")
            yield from conv_bn(f"{name}.cb2", f"{t}.conv2", f"{t}.bn2")
            if f"{src}{t}.downsample.0.weight" in keys:
                yield from conv_bn(f"{name}.downsample", f"{t}.downsample.0",
                                   f"{t}.downsample.1")


def _take(sd: Mapping, pairs) -> Dict[str, torch.Tensor]:
    return {dst: torch.as_tensor(sd[src]).detach().to(torch.float32).clone()
            for dst, src in pairs}


def resnet34_to_net2d(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision resnet34 state_dict -> the entries of a `Net2DSeg`
    state_dict that it initialises (fp32)."""
    return _take(sd, _encoder_pairs("", "stem_rgb", "rgb_backbone", sd))


# reference decoder module -> the port's (`models/net2d.py`)
_UP = (("dec_t_conv_stage5", "up5"), ("dec_t_conv_stage4", "up4"),
       ("dec_t_conv_stage3", "up3"), ("dec_t_conv_stage2", "up2"))
_FUSE = (("dec_conv_stage4", "fuse4"), ("dec_conv_stage3", "fuse3"),
         ("dec_conv_stage2", "fuse2"))
_CONVS = (("dec_conv_stage1", "dec_conv_stage1"), ("con1_1_avg", "head_conv"),
          ("aux.con1_1_avg", "aux_conv"))


def net2dseg_to_port(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A FULL reference Net2DSeg state_dict (tensors or numpy arrays) ->
    the port's `Net2DSeg` state_dict (fp32; counterpart of the JAX
    `net2dseg_state_dict_to_flax`, ``2d_net/model.py:35-180``).

    Covers both encoders (stems into the dual-stem layout; an encoder's
    keys may sit under ``.encoder.``, as the reference Backbone wraps
    torchvision's net), the 4 up/fuse decoder stages, dec_conv_stage1 and
    the two pooled heads.  The reference aux module's unused ``linear``
    layer and the BatchNorms' ``num_batches_tracked`` are skipped; any
    other entry that has no place raises KeyError."""
    pairs: List[Tuple[str, str]] = []
    for trunk, stem in (("rgb_backbone", "stem_rgb"),
                        ("depth_backbone", "stem_depth")):
        src = (f"{trunk}.encoder." if any(k.startswith(f"{trunk}.encoder.")
                                          for k in sd) else f"{trunk}.")
        pairs += _encoder_pairs(src, stem, trunk, sd)
    for ref, port in _UP + _FUSE:
        conv = "tconv" if port.startswith("up") else "conv"
        pairs += [(f"{port}.{conv}.{leaf}", f"{ref}.0.{leaf}")
                  for leaf in ("weight", "bias")]
        pairs += [(f"{port}.bn.{leaf}", f"{ref}.1.{leaf}") for leaf in _BN]
    pairs += [(f"{port}.{leaf}", f"{ref}.{leaf}") for ref, port in _CONVS
              for leaf in ("weight", "bias")]
    placed = {src for _, src in pairs}
    unplaced = [k for k in sd if k not in placed
                and not k.endswith(".num_batches_tracked")
                and not k.startswith("aux.linear.")]
    if unplaced:
        raise KeyError(f"reference Net2DSeg entries with no place in the "
                       f"port's Net2DSeg: {unplaced}")
    return _take(sd, pairs)


def load_pretrained_backbone(checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """Read a local torchvision resnet34 checkpoint (.pth; no download) and
    map it with `resnet34_to_net2d`; load the result with
    `model2d.load_state_dict(sd, strict=False)`."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return resnet34_to_net2d(sd)
