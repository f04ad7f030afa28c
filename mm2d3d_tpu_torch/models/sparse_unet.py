"""SCN-style sparse 3D U-Net and Net3DSeg
(port of `mm2d3d_tpu/models/sparse_unet.py`).

Module and parameter names follow the flax tree (`net_3d.unet.enc_0_0.conv`,
`down_bn_1`, ...) so `models.convert.from_flax` is a mechanical map.  Sparse
kernels keep the JAX layout (K, Cin, Cout).  Convolutions run in
`compute_dtype` and return fp32.  Batch norms take the statistics of the
valid rows in train mode (`nn.Module.train()`) and their running statistics
in eval mode, and apply the ReLU (or residual add and ReLU) after them
themselves; a batch norm whose only reader is a convolution writes the
convolution's compute dtype, which it would cast to at once.  With `residual_blocks` the U-Net's blocks are SCN residual
blocks (`ResidualBlock`) instead of VGG blocks.  `GatedTrunk` is the branch
around any sparse trunk (gate, pool, unpool, heads), which `Net3DSeg` and
`models.minkunet.MinkUNet34CSeg` share.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.hierarchy import GridLevel, Hierarchy, LevelTransition
from ..ops.kernels.batchnorm2d import BatchNormTrain
from ..ops.spconv import down_conv2, subm_conv3, subm_conv5, up_conv2
from ..ops.voxelize import VoxelGrid, pool_features, unpool_features
from .resnet2d import epilogue


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows only (eps 1e-4 unless given).  Train
    mode: the biased mean and variance of the valid rows, and the running
    statistics move to 0.9 old + 0.1 batch; eval mode: the running
    statistics.

    `forward(x, valid, relu, identity, out_dtype)` also applies the caller's
    epilogue: nothing, ReLU(y), or ReLU(y + identity).  In train mode all of
    it is `BatchNormTrain` with the row mask (the kernels on a CUDA tensor;
    on a CPU one the eager masked form's ops, then the epilogue's, with an
    analytic backward), which writes `out_dtype`: fp32, or the compute
    dtype where a convolution, which casts to it anyway, is the only
    reader.  Eval mode runs the same ops as before and returns the input's
    dtype, as the flax module does."""

    momentum = 0.9  # flax's: running = 0.9 old + 0.1 batch

    def __init__(self, c: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, valid: torch.Tensor, relu: bool = False,
                identity: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self.training:
            return BatchNormTrain.apply(x, self.weight, self.bias, identity,
                                        self.running_mean, self.running_var, relu,
                                        out_dtype, self.eps, self.momentum, valid)
        y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return epilogue((y * self.weight + self.bias).to(x.dtype), relu, identity)


class SubmConv(nn.Module):
    """Submanifold convolution: 3x3x3, weight (27, cin, cout), over the
    level's slot or 27-neighbour tables; or with `kernel_size` 5 a 5x5x5
    one, weight (125, cin, cout), over its 125-neighbour table
    (`GridLevel.nbr5`)."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype,
                 kernel_size: int = 3):
        super().__init__()
        if kernel_size not in (3, 5):
            raise ValueError(f"kernel_size must be 3 or 5, got {kernel_size}")
        self.compute_dtype = compute_dtype
        self.conv = subm_conv3 if kernel_size == 3 else subm_conv5
        self.weight = nn.Parameter(torch.empty(kernel_size ** 3, cin, cout))

    def forward(self, x: torch.Tensor, level: GridLevel) -> torch.Tensor:
        return self.conv(x, level, self.weight, self.compute_dtype)


class DownConv(nn.Module):
    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(8, cin, cout))

    def forward(self, x: torch.Tensor, trans: LevelTransition) -> torch.Tensor:
        return down_conv2(x, trans, self.weight, self.compute_dtype)


class UpConv(nn.Module):
    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(8, cin, cout))

    def forward(self, x: torch.Tensor, trans: LevelTransition) -> torch.Tensor:
        return up_conv2(x, trans, self.weight, self.compute_dtype)


class Conv1x1(nn.Module):
    """A 1x1 convolution over the voxels, weight (cin, cout): one product,
    in `compute_dtype`, fp32 out."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(self.compute_dtype) @ self.weight.to(self.compute_dtype)).float()


class VGGBlock(nn.Module):
    """Pre-activation block: BN -> ReLU -> SubmConv."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.bn = MaskedBatchNorm(cin)
        self.conv = SubmConv(cin, cout, compute_dtype)

    def forward(self, x: torch.Tensor, level: GridLevel) -> torch.Tensor:
        return self.conv(self.bn(x, level.valid, relu=True,
                                 out_dtype=self.conv.compute_dtype), level)


class ResidualBlock(nn.Module):
    """SCN residual block: shortcut + (BN -> ReLU -> SubmConv) x 2; the
    shortcut is the input, or its 1x1 product with `nin_kernel` (cin, cout)
    where the widths differ."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        if cin != cout:
            self.nin_kernel = nn.Parameter(torch.empty(cin, cout))
        else:
            self.register_parameter("nin_kernel", None)
        self.bn1 = MaskedBatchNorm(cin)
        self.conv1 = SubmConv(cin, cout, compute_dtype)
        self.bn2 = MaskedBatchNorm(cout)
        self.conv2 = SubmConv(cout, cout, compute_dtype)

    def forward(self, x: torch.Tensor, level: GridLevel) -> torch.Tensor:
        shortcut = x if self.nin_kernel is None else x @ self.nin_kernel
        y = self.conv1(self.bn1(x, level.valid, relu=True,
                                out_dtype=self.conv1.compute_dtype), level)
        y = self.conv2(self.bn2(y, level.valid, relu=True,
                                out_dtype=self.conv2.compute_dtype), level)
        return shortcut + y


class SparseUNet(nn.Module):
    """Encoder: per level, VGG (or residual) blocks, then BN-ReLU + stride-2
    conv down.  Decoder: BN-ReLU + deconv up, concat [enc_l, up], blocks."""

    def __init__(self, planes: Sequence[int], reps: int,
                 compute_dtype: torch.dtype, residual: bool = False):
        super().__init__()
        self.planes = list(planes)
        self.reps = reps
        self.compute_dtype = compute_dtype
        block = ResidualBlock if residual else VGGBlock
        n = len(planes)
        for l in range(n):
            if l > 0:
                self.add_module(f"down_bn_{l}", MaskedBatchNorm(planes[l - 1]))
                self.add_module(f"down_{l}",
                                DownConv(planes[l - 1], planes[l], compute_dtype))
            for r in range(reps):
                self.add_module(f"enc_{l}_{r}",
                                block(planes[l], planes[l], compute_dtype))
        for l in range(n - 2, -1, -1):
            self.add_module(f"up_bn_{l}", MaskedBatchNorm(planes[l + 1]))
            self.add_module(f"up_{l}", UpConv(planes[l + 1], planes[l], compute_dtype))
            for r in range(reps):
                cin = 2 * planes[l] if r == 0 else planes[l]
                self.add_module(f"dec_{l}_{r}", block(cin, planes[l], compute_dtype))

    def forward(self, x: torch.Tensor, hier: Hierarchy) -> torch.Tensor:
        n = len(self.planes)
        m = dict(self.named_children())
        enc = []
        for l in range(n):
            if l > 0:
                y = m[f"down_bn_{l}"](x, hier.levels[l - 1].valid, relu=True,
                                      out_dtype=self.compute_dtype)
                x = m[f"down_{l}"](y, hier.transitions[l - 1])
            for r in range(self.reps):
                x = m[f"enc_{l}_{r}"](x, hier.levels[l])
            enc.append(x)
        x = enc[-1]
        for l in range(n - 2, -1, -1):
            y = m[f"up_bn_{l}"](x, hier.levels[l + 1].valid, relu=True,
                                out_dtype=self.compute_dtype)
            up = m[f"up_{l}"](y, hier.transitions[l])
            x = torch.cat([enc[l], up], dim=-1)
            for r in range(self.reps):
                x = m[f"dec_{l}_{r}"](x, hier.levels[l])
        return x


class UNetSCN3D(nn.Module):
    """Input conv -> sparse U-Net -> BN-ReLU (the In/OutputLayer live in
    `ops.voxelize`)."""

    def __init__(self, in_channels: int, m: int, block_reps: int,
                 num_planes: int, compute_dtype: torch.dtype,
                 residual_blocks: bool = False):
        super().__init__()
        planes = [(i + 1) * m for i in range(num_planes)]
        self.input_conv = SubmConv(in_channels, m, compute_dtype)
        self.unet = SparseUNet(planes, block_reps, compute_dtype, residual_blocks)
        self.out_bn = MaskedBatchNorm(m)

    def forward(self, voxel_feats: torch.Tensor, hier: Hierarchy) -> torch.Tensor:
        x = self.input_conv(voxel_feats, hier.levels[0])
        x = self.unet(x, hier)
        return self.out_bn(x, hier.levels[0].valid, relu=True)


class GatedTrunk(nn.Module):
    """3D branch around a sparse trunk (`make_trunk()`, voxel features of
    `width` channels from the hierarchy): sigmoid-gated RGB point feats ->
    mean pool -> trunk -> unpool -> main and auxiliary linear heads; the
    gate is returned as the per-point "confidence".  `num_levels` and
    `stem_kernel` declare the topology the trunk needs, which the task
    builds (`MM2D3DTask.build_topology`): that many levels, and level 0's
    125-neighbour table where the stem is 5^3."""

    stem_kernel = 3

    def __init__(self, num_classes: int, in_channels: int, width: int,
                 make_trunk: Callable[[], nn.Module], num_levels: int):
        super().__init__()
        self.num_levels = num_levels
        self.linear_rgb_mask = nn.Linear(in_channels, 1)
        self.net_3d = make_trunk()
        self.linear = nn.Linear(width, num_classes)
        self.aux_linear_point = nn.Linear(width, num_classes)

    def forward(self, point_feats: torch.Tensor, grid: VoxelGrid,
                hier: Hierarchy) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                          Dict[str, torch.Tensor]]:
        gate = torch.sigmoid(self.linear_rgb_mask(point_feats.float()))
        gated = point_feats * gate
        trunk = self.net_3d(pool_features(grid, gated), hier)
        point_out = unpool_features(grid, trunk)
        preds = {"seg_logit": self.linear(point_out), "confidence": gate}
        aux = {"feats": point_out,
               "seg_logit_point": self.aux_linear_point(point_out)}
        return preds, point_out, aux


class Net3DSeg(GatedTrunk):
    """The SCN U-Net branch: `GatedTrunk` around `UNetSCN3D` (m channels,
    `num_planes` levels, a 3^3 input convolution)."""

    def __init__(self, num_classes: int, in_channels: int = 3, m: int = 16,
                 block_reps: int = 1, num_planes: int = 7,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 residual_blocks: bool = False):
        super().__init__(num_classes, in_channels, m, lambda: UNetSCN3D(
            in_channels, m, block_reps, num_planes, compute_dtype, residual_blocks),
            num_planes)
