"""ResNet-34 encoder for the 2D branch, eval forward
(port of `mm2d3d_tpu/models/resnet2d.py`).

Tensors run NCHW in `torch.channels_last` memory, which is NHWC in memory,
so the stem pool hands the K4 kernel an NHWC-contiguous view.  Convolutions
run in `compute_dtype`; every BatchNorm computes in fp32 and returns fp32, as
flax `BatchNorm(dtype=float32)` does.  Dropout is inactive in eval and not
modelled.  Module names follow the flax tree (`layer1_0.cb1.conv`, ...).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.maxpool import maxpool3x3s2


class BatchNorm2d(nn.Module):
    """Eval-form BatchNorm over NCHW: running statistics, fp32 out."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, training=False, eps=self.eps)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride: int,
           padding: int, compute_dtype: torch.dtype) -> torch.Tensor:
    """Convolution with inputs and weights in `compute_dtype`."""
    b = None if bias is None else bias.to(compute_dtype)
    return F.conv2d(x.to(compute_dtype), weight.to(compute_dtype), b,
                    stride=stride, padding=padding)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.stride, self.padding = stride, kernel // 2
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(cin, cout, kernel, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(conv2d(x, self.conv.weight, None, self.stride,
                              self.padding, self.compute_dtype))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.cb1 = ConvBN(cin, cout, 3, stride, compute_dtype)
        self.cb2 = ConvBN(cout, cout, 3, 1, compute_dtype)
        self.downsample = (
            ConvBN(cin, cout, 1, stride, compute_dtype)
            if stride != 1 or cin != cout else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cb2(torch.relu(self.cb1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """The stem max pool through K4, on an NCHW channels_last tensor."""
    y = maxpool3x3s2(x.contiguous(memory_format=torch.channels_last)
                     .permute(0, 2, 3, 1))
    return y.permute(0, 3, 1, 2)


class ResNet34Encoder(nn.Module):
    """5-skip ResNet-34 trunk after the stem (`skip_stem=True` in flax): takes
    the stem's ConvBN output, returns features at strides 1, 2, 4, 8, 16 with
    channels 64, 64, 128, 256, 512."""

    def __init__(self, compute_dtype: torch.dtype,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        cin = 64
        self.block_names = []
        for i, (blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            names = []
            for b in range(blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                name = f"layer{i + 1}_{b}"
                self.add_module(name, BasicBlock(cin, width, stride, compute_dtype))
                names.append(name)
                cin = width
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = torch.relu(x)
        feats = [x]
        x = stem_pool(x)
        for names in self.block_names:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats


class StemParams(nn.Module):
    """One encoder stem's 7x7 kernel and BatchNorm, for the fused dual stem."""

    def __init__(self, cin: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, 64, 7, bias=False)
        self.bn = BatchNorm2d(64)
