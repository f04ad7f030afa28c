"""ResNet-34 encoder for the 2D branch (port of `mm2d3d_tpu/models/resnet2d.py`).

Tensors run NCHW in `torch.channels_last` memory, which is NHWC in memory,
so the stem pool hands the K4 kernel an NHWC-contiguous view.  Convolutions
run in `compute_dtype`; every BatchNorm computes in fp32 and returns fp32, as
flax `BatchNorm(dtype=float32)` does, with batch statistics in train mode
(`nn.Module.train()`).  In train mode each BatchNorm and the ReLU or residual
add and ReLU after it are one `ops.kernels.batchnorm2d.BatchNormTrain`, and a
block's first BatchNorm returns the compute dtype, which the convolution
after it, its only reader, casts to anyway.  Dropout after layer3 and layer4
is active in train mode and draws from the generator the caller passes.
Module names follow the flax tree (`layer1_0.cb1.conv`, ...).  With
`frozen_bn` (the RGB stem and encoder of `Net2DSeg(frozen_batch_norm=True)`)
each BatchNorm takes the flax ConvBN's frozen form instead (`frozen_bn`),
which returns the conv's dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.batchnorm2d import BatchNormTrain
from ..ops.kernels.maxpool import MaxPool3x3s2


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW as flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5,
    dtype=float32)`, fp32 out.  Train mode normalises with the biased batch
    variance in flax's form, mean(x^2) - mean(x)^2 clipped at 0 (which
    loses digits in near-constant channels, such as the depth encoder's over
    a mostly empty depth map, so the port keeps it to stay with the
    reference), and moves the running statistics to 0.9 old + 0.1 batch;
    eval mode uses the running statistics.

    `forward(x, relu, identity, out_dtype)` also applies the caller's
    epilogue: nothing, ReLU(y), or ReLU(y + identity).  In train mode all of
    it is `BatchNormTrain` (the kernels on a CUDA tensor, the eager ops on
    a CPU one), which writes `out_dtype`: fp32, or the compute dtype where a
    convolution, which casts to it anyway, is the only reader.  Eval mode
    runs the same ops as before and returns fp32."""

    momentum = 0.9  # flax's: running = 0.9 old + 0.1 batch

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, relu: bool = False,
                identity: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self.training:
            return BatchNormTrain.apply(x, self.weight, self.bias, identity,
                                        self.running_mean, self.running_var, relu,
                                        out_dtype, self.eps, self.momentum)
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, training=False, eps=self.eps)
        return epilogue(y, relu, identity)


def epilogue(y: torch.Tensor, relu: bool,
             identity: Optional[torch.Tensor]) -> torch.Tensor:
    """ReLU(y + identity), ReLU(y) or y, as eager ops."""
    if identity is not None:
        y = y + identity
    return torch.relu(y) if relu else y


def add_frozen_bn(module: nn.Module, c: int) -> None:
    """The frozen BatchNorm's leaves, named as flax names them beside the
    conv: `bn_scale` and `bn_bias` are parameters (the optimizer updates
    them), `bn_mean` and `bn_var` fixed statistics."""
    module.bn_scale = nn.Parameter(torch.ones(c))
    module.bn_bias = nn.Parameter(torch.zeros(c))
    module.register_buffer("bn_mean", torch.zeros(c))
    module.register_buffer("bn_var", torch.ones(c))


def frozen_bn(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """FrozenBatchNorm2d over NCHW as the flax ConvBN's frozen form:
    (x - mean) * rsqrt(var + 1e-5) * scale + bias in fp32, in train and
    eval mode alike, returned in x's dtype."""
    c = (1, -1, 1, 1)
    y = (x.float() - module.bn_mean.view(c)) * torch.rsqrt(module.bn_var + 1e-5).view(c)
    return (y * module.bn_scale.view(c) + module.bn_bias.view(c)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: where(keep, x / (1 - rate), 0) with keep ~
    Bernoulli(1 - rate), drawn from `generator` (on x's device); rate 0
    returns x."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.empty_like(x).uniform_(generator=generator) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride: int,
           padding: int, compute_dtype: torch.dtype) -> torch.Tensor:
    """Convolution with inputs and weights in `compute_dtype`."""
    b = None if bias is None else bias.to(compute_dtype)
    return F.conv2d(x.to(compute_dtype), weight.to(compute_dtype), b,
                    stride=stride, padding=padding)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 compute_dtype: torch.dtype, frozen: bool = False):
        super().__init__()
        self.stride, self.padding = stride, kernel // 2
        self.compute_dtype = compute_dtype
        self.frozen = frozen
        self.conv = nn.Conv2d(cin, cout, kernel, bias=False)
        if frozen:
            add_frozen_bn(self, cout)
        else:
            self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor, relu: bool = False,
                identity: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """conv, BatchNorm and the epilogue (`BatchNorm2d.forward`); the
        frozen form returns its conv's dtype, as before."""
        y = conv2d(x, self.conv.weight, None, self.stride, self.padding,
                   self.compute_dtype)
        if self.frozen:
            return epilogue(frozen_bn(self, y), relu, identity)
        return self.bn(y, relu, identity, out_dtype)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int,
                 compute_dtype: torch.dtype, frozen_bn: bool = False):
        super().__init__()
        self.cb1 = ConvBN(cin, cout, 3, stride, compute_dtype, frozen_bn)
        self.cb2 = ConvBN(cout, cout, 3, 1, compute_dtype, frozen_bn)
        self.downsample = (
            ConvBN(cin, cout, 1, stride, compute_dtype, frozen_bn)
            if stride != 1 or cin != cout else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        # cb1's output feeds cb2's convolution alone, so it may come in the
        # compute dtype that the convolution casts it to
        h = self.cb1(x, relu=True, out_dtype=self.cb1.compute_dtype)
        return self.cb2(h, relu=True, identity=identity)


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """The stem max pool through K4, on an NCHW channels_last tensor."""
    y = MaxPool3x3s2.apply(x.contiguous(memory_format=torch.channels_last)
                           .permute(0, 2, 3, 1))
    return y.permute(0, 3, 1, 2)


class ResNet34Encoder(nn.Module):
    """5-skip ResNet-34 trunk after the stem (`skip_stem=True` in flax): takes
    the stem's ConvBN output after its ReLU (`StemParams.norm`), returns
    features at strides 1, 2, 4, 8, 16 with channels 64, 64, 128, 256, 512.
    `dropout_rate` is the flax field (0.4): dropout follows layer3 and
    layer4 in train mode."""

    def __init__(self, compute_dtype: torch.dtype,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dropout_rate: float = 0.4, frozen_bn: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        cin = 64
        self.block_names = []
        for i, (blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            names = []
            for b in range(blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                name = f"layer{i + 1}_{b}"
                self.add_module(name, BasicBlock(cin, width, stride, compute_dtype,
                                                 frozen_bn))
                names.append(name)
                cin = width
            self.block_names.append(names)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        feats = [x]
        x = stem_pool(x)
        for i, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            if i >= 2 and self.training:  # dropout after layer3 and layer4
                x = dropout(x, self.dropout_rate, generator)
            feats.append(x)
        return feats


class StemParams(nn.Module):
    """One encoder stem's 7x7 kernel and BatchNorm (or, with `frozen_bn`,
    the frozen form's leaves), for the fused dual stem."""

    def __init__(self, cin: int, frozen_bn: bool = False):
        super().__init__()
        self.frozen = frozen_bn
        self.conv = nn.Conv2d(cin, 64, 7, bias=False)
        if frozen_bn:
            add_frozen_bn(self, 64)
        else:
            self.bn = BatchNorm2d(64)

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        """The stem's BatchNorm of its conv output and the ReLU after it."""
        if self.frozen:
            return torch.relu(frozen_bn(self, x))
        return self.bn(x, relu=True)
