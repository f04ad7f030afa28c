"""MinkUNet34C as the 3D branch of the UDA task.

The network of Choy, Gwak and Savarese, "4D Spatio-Temporal ConvNets:
Minkowski Convolutional Neural Networks" (CVPR 2019), as
`NVIDIA/MinkowskiEngine` `examples/minkunet.py` class `MinkUNet34C` defines
it (`BLOCK = BasicBlock`, `LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)`, `PLANES =
(32, 64, 128, 256, 256, 128, 96, 96)`, `INIT_DIM = 32`), on the port's
sparse convolutions and topology:

- stem `conv0p1s1`: a submanifold 5^3 convolution, in_channels -> 32, over
  level 0's 125-neighbour table, then `bn0` and ReLU (`out_p1`);
- encoder, four times: a 2^3 stride-2 convolution Ci -> Ci (`conv1p1s2`
  ... `conv4p8s2`), BatchNorm, ReLU, a stage of BasicBlocks (`block1` ...
  `block4`: 2 x 32, 3 x 64, 4 x 128, 6 x 256);
- decoder, four times: a 2^3 stride-2 transposed convolution
  (`convtr4p16s2` ... `convtr7p2s2`: 256, 128, 96, 96), BatchNorm, ReLU,
  the concatenation [up, skip] and a stage of 2 BasicBlocks (`block5` ...
  `block8`: 256, 128, 96, 96);
- BasicBlock: relu(norm2(conv2(relu(norm1(conv1(x))))) + shortcut(x)), both
  convolutions submanifold 3^3; the shortcut is x, or where the widths
  differ a 1x1 convolution and a BatchNorm (`downsample`).

No convolution has a bias; every BatchNorm has eps 1e-5 and momentum 0.1
and normalises over the active voxels.  Five levels (strides 1 to 16).
`MinkUNet34CSeg` wraps the trunk in the branch's gate, pooling and heads
(`sparse_unet.GatedTrunk`): the main head `linear` (96 -> classes, with a
bias) is MinkowskiEngine's `final` 1x1 convolution, applied after the
unpool (an unpool is a gather, so the function is the same), and
`aux_linear_point` is xMUDA's cross-modal head on the same 96-wide point
features.  Departures from the published module: the running variance
moves by the batch's biased variance (MinkowskiBatchNorm, a
`torch.nn.BatchNorm1d`, takes the unbiased one), which changes no train
step's output; weights are (taps, Cin, Cout) in `hierarchy.OFFSETS_125` /
`OFFSETS_27` / `OFFSETS_8` tap order; a 1x1 kernel is (Cin, Cout), as
MinkowskiEngine keeps one of a single tap.  Convolutions run in
`compute_dtype` and return fp32, as in `sparse_unet`.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops.hierarchy import GridLevel, Hierarchy
from .sparse_unet import (
    Conv1x1, DownConv, GatedTrunk, MaskedBatchNorm, SubmConv, UpConv,
)

LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
INIT_DIM = 32
NUM_LEVELS = 5
BN_EPS = 1e-5
STEM_KERNEL = 5


class Shortcut(nn.Module):
    """BasicBlock's `downsample`: a 1x1 convolution, then a BatchNorm."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv = Conv1x1(cin, cout, compute_dtype)
        self.bn = MaskedBatchNorm(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), valid)


class BasicBlock(nn.Module):
    """Post-activation residual block of two submanifold 3^3 convolutions."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv1 = SubmConv(cin, cout, compute_dtype)
        self.norm1 = MaskedBatchNorm(cout, eps=BN_EPS)
        self.conv2 = SubmConv(cout, cout, compute_dtype)
        self.norm2 = MaskedBatchNorm(cout, eps=BN_EPS)
        self.downsample = (Shortcut(cin, cout, compute_dtype) if cin != cout
                           else None)

    def forward(self, x: torch.Tensor, level: GridLevel) -> torch.Tensor:
        y = self.norm1(self.conv1(x, level), level.valid, relu=True,
                       out_dtype=self.conv2.compute_dtype)
        shortcut = x if self.downsample is None else self.downsample(x, level.valid)
        return self.norm2(self.conv2(y, level), level.valid, relu=True, identity=shortcut)


def _stage(cin: int, cout: int, blocks: int, compute_dtype) -> nn.ModuleList:
    return nn.ModuleList([BasicBlock(cin if b == 0 else cout, cout, compute_dtype)
                          for b in range(blocks)])


class MinkUNet34C(nn.Module):
    """The trunk: (V0, in_channels) level-0 voxel features -> (V0, 96)."""

    def __init__(self, in_channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv0p1s1 = SubmConv(in_channels, INIT_DIM, compute_dtype,
                                  kernel_size=STEM_KERNEL)
        self.bn0 = MaskedBatchNorm(INIT_DIM, eps=BN_EPS)
        c = INIT_DIM
        for i in range(4):
            self.add_module(f"conv{i + 1}p{1 << i}s2", DownConv(c, c, compute_dtype))
            self.add_module(f"bn{i + 1}", MaskedBatchNorm(c, eps=BN_EPS))
            self.add_module(f"block{i + 1}", _stage(c, PLANES[i], LAYERS[i],
                                                    compute_dtype))
            c = PLANES[i]
        skips = (INIT_DIM,) + PLANES[:3]  # widths of out_p1, out_b1p2, ...
        for j in range(4):
            out = PLANES[4 + j]
            self.add_module(f"convtr{4 + j}p{16 >> j}s2", UpConv(c, out, compute_dtype))
            self.add_module(f"bntr{4 + j}", MaskedBatchNorm(out, eps=BN_EPS))
            self.add_module(f"block{5 + j}", _stage(out + skips[3 - j], out,
                                                    LAYERS[4 + j], compute_dtype))
            c = out

    def forward(self, x: torch.Tensor, hier: Hierarchy) -> torch.Tensor:
        lv, tr = hier.levels, hier.transitions
        m = dict(self.named_children())
        out = self.bn0(self.conv0p1s1(x, lv[0]), lv[0].valid, relu=True)
        skips: List[torch.Tensor] = [out]
        for i in range(4):
            out = m[f"conv{i + 1}p{1 << i}s2"](out, tr[i])
            out = m[f"bn{i + 1}"](out, lv[i + 1].valid, relu=True)
            for block in m[f"block{i + 1}"]:
                out = block(out, lv[i + 1])
            skips.append(out)
        for j in range(4):
            level = 3 - j
            out = m[f"convtr{4 + j}p{16 >> j}s2"](out, tr[level])
            out = m[f"bntr{4 + j}"](out, lv[level].valid, relu=True)
            out = torch.cat([out, skips[level]], dim=-1)
            for block in m[f"block{5 + j}"]:
                out = block(out, lv[level])
        return out


class MinkUNet34CSeg(GatedTrunk):
    """The 3D branch with MinkUNet34C as its trunk: five levels and a 5^3
    stem, which the task's topology provides.  The published sizes are the
    module's constants; the name is the architecture, so there are no width
    knobs."""

    stem_kernel = STEM_KERNEL

    def __init__(self, num_classes: int, in_channels: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(num_classes, in_channels, PLANES[-1],
                         lambda: MinkUNet34C(in_channels, compute_dtype), NUM_LEVELS)
