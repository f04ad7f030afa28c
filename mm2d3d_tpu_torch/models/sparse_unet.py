"""SCN-style sparse 3D U-Net and Net3DSeg
(port of `mm2d3d_tpu/models/sparse_unet.py`).

Module and parameter names follow the flax tree (`net_3d.unet.enc_0_0.conv`,
`down_bn_1`, ...) so `models.convert.from_flax` is a mechanical map.  Sparse
kernels keep the JAX layout (K, Cin, Cout).  Convolutions run in
`compute_dtype` and return fp32.  Batch norms take the statistics of the
valid rows in train mode (`nn.Module.train()`) and their running statistics
in eval mode.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..ops.hierarchy import GridLevel, Hierarchy, LevelTransition
from ..ops.spconv import down_conv2, masked_batch_norm_stats, subm_conv3, up_conv2
from ..ops.voxelize import VoxelGrid, pool_features, unpool_features


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows only (eps 1e-4).  Train mode: the
    biased mean and variance of the valid rows, differentiable, and the
    running statistics move to 0.9 old + 0.1 batch; eval mode: the running
    statistics.  Returns the input's dtype, as the flax module does."""

    momentum = 0.9  # flax's: running = 0.9 old + 0.1 batch

    def __init__(self, c: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = masked_batch_norm_stats(x, valid)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class SubmConv(nn.Module):
    """Submanifold 3x3x3 convolution, weight (27, cin, cout)."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(27, cin, cout))

    def forward(self, x: torch.Tensor, level: GridLevel) -> torch.Tensor:
        return subm_conv3(x, level, self.weight, self.compute_dtype)


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


class VGGBlock(nn.Module):
    """Pre-activation block: BN -> ReLU -> SubmConv."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.bn = MaskedBatchNorm(cin)
        self.conv = SubmConv(cin, cout, compute_dtype)

    def forward(self, x: torch.Tensor, level: GridLevel) -> torch.Tensor:
        return self.conv(torch.relu(self.bn(x, level.valid)), level)


class SparseUNet(nn.Module):
    """Encoder: per level, VGG blocks, then BN-ReLU + stride-2 conv down.
    Decoder: BN-ReLU + deconv up, concat [enc_l, up], VGG blocks."""

    def __init__(self, planes: Sequence[int], reps: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.planes = list(planes)
        self.reps = reps
        n = len(planes)
        for l in range(n):
            if l > 0:
                self.add_module(f"down_bn_{l}", MaskedBatchNorm(planes[l - 1]))
                self.add_module(f"down_{l}",
                                DownConv(planes[l - 1], planes[l], compute_dtype))
            for r in range(reps):
                self.add_module(f"enc_{l}_{r}",
                                VGGBlock(planes[l], planes[l], compute_dtype))
        for l in range(n - 2, -1, -1):
            self.add_module(f"up_bn_{l}", MaskedBatchNorm(planes[l + 1]))
            self.add_module(f"up_{l}", UpConv(planes[l + 1], planes[l], compute_dtype))
            for r in range(reps):
                cin = 2 * planes[l] if r == 0 else planes[l]
                self.add_module(f"dec_{l}_{r}", VGGBlock(cin, planes[l], compute_dtype))

    def forward(self, x: torch.Tensor, hier: Hierarchy) -> torch.Tensor:
        n = len(self.planes)
        m = dict(self.named_children())
        enc = []
        for l in range(n):
            if l > 0:
                y = torch.relu(m[f"down_bn_{l}"](x, hier.levels[l - 1].valid))
                x = m[f"down_{l}"](y, hier.transitions[l - 1])
            for r in range(self.reps):
                x = m[f"enc_{l}_{r}"](x, hier.levels[l])
            enc.append(x)
        x = enc[-1]
        for l in range(n - 2, -1, -1):
            y = torch.relu(m[f"up_bn_{l}"](x, hier.levels[l + 1].valid))
            up = m[f"up_{l}"](y, hier.transitions[l])
            x = torch.cat([enc[l], up], dim=-1)
            for r in range(self.reps):
                x = m[f"dec_{l}_{r}"](x, hier.levels[l])
        return x


class UNetSCN3D(nn.Module):
    """Input conv -> sparse U-Net -> BN-ReLU (the In/OutputLayer live in
    `ops.voxelize`)."""

    def __init__(self, in_channels: int, m: int, block_reps: int,
                 num_planes: int, compute_dtype: torch.dtype):
        super().__init__()
        planes = [(i + 1) * m for i in range(num_planes)]
        self.input_conv = SubmConv(in_channels, m, compute_dtype)
        self.unet = SparseUNet(planes, block_reps, compute_dtype)
        self.out_bn = MaskedBatchNorm(m)

    def forward(self, voxel_feats: torch.Tensor, hier: Hierarchy) -> torch.Tensor:
        x = self.input_conv(voxel_feats, hier.levels[0])
        x = self.unet(x, hier)
        return torch.relu(self.out_bn(x, hier.levels[0].valid))


class Net3DSeg(nn.Module):
    """3D branch: sigmoid-gated RGB point feats -> mean pool -> sparse U-Net
    -> unpool -> main and auxiliary linear heads; the gate is returned as
    the per-point "confidence"."""

    def __init__(self, num_classes: int, in_channels: int = 3, m: int = 16,
                 block_reps: int = 1, num_planes: int = 7,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.linear_rgb_mask = nn.Linear(in_channels, 1)
        self.net_3d = UNetSCN3D(in_channels, m, block_reps, num_planes,
                                compute_dtype)
        self.linear = nn.Linear(m, num_classes)
        self.aux_linear_point = nn.Linear(m, num_classes)

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
