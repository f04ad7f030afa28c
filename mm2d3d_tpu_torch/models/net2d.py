"""Dual-encoder 2D U-Net (RGB + sparse depth) with 2D -> 3D lifting
(port of `mm2d3d_tpu/models/net2d.py`, `with_features=False`).

Public layout is the JAX package's: images (B, H, W, C), logits
(B, H, W, nc) and lifted (B, N, nc).  Inside, tensors are NCHW in
`torch.channels_last` memory.  The head keeps `dec_conv_stage1`, `head_conv`
and `aux_conv` as separate parameters and composes them in forward
(`w12 = dec_k @ k_heads`), as the JAX package does, then crops the padding
and applies the 5x5 `count_include_pad` average pool.  With `fused_head`,
the counterpart of the JAX net's `pallas_head`, the head's conv, bias, crop
and pool run in the K5 kernel (`ops.kernels.head2d.HeadPool`) on the three
decoder-tail pieces, which are then never concatenated; wherever
`head2d.supports` refuses the shapes, the unfused head runs, as in JAX.
Train and eval mode follow `nn.Module.train()`; in train mode both
encoders' dropout draws from the generator passed to `forward`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import head2d
from ..ops.lifting import lift_image_features
from .resnet2d import BatchNorm2d, ResNet34Encoder, StemParams, conv2d


class UpStage(nn.Module):
    """ConvTranspose(k2, s2) + BN + ReLU."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.tconv = nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        y = F.conv_transpose2d(x.to(cd), self.tconv.weight.to(cd),
                               self.tconv.bias.to(cd), stride=2)
        return torch.relu(self.bn(y))


class FuseStage(nn.Module):
    """3x3 conv + BN + ReLU over [depth skip, up, rgb skip]."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(cin, cout, 3)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, self.conv.weight, self.conv.bias, 1, 1, self.compute_dtype)
        return torch.relu(self.bn(y))


class Net2DSeg(nn.Module):
    def __init__(self, num_classes: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fused_head: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.fused_head = fused_head
        cd = compute_dtype
        self.stem_rgb = StemParams(3)
        self.stem_depth = StemParams(1)
        self.rgb_backbone = ResNet34Encoder(cd)
        self.depth_backbone = ResNet34Encoder(cd)
        self.up5 = UpStage(1024, 256, cd)
        self.fuse4 = FuseStage(3 * 256, 256, cd)
        self.up4 = UpStage(256, 128, cd)
        self.fuse3 = FuseStage(3 * 128, 128, cd)
        self.up3 = UpStage(128, 64, cd)
        self.fuse2 = FuseStage(3 * 64, 64, cd)
        self.up2 = UpStage(64, 64, cd)
        self.dec_conv_stage1 = nn.Conv2d(3 * 64, 64, 3)
        self.head_conv = nn.Conv2d(64, num_classes, 1)
        self.aux_conv = nn.Conv2d(64, num_classes, 1)

    def _stems(self, img: torch.Tensor, depth: torch.Tensor):
        """Both 7x7 stem convolutions as ONE block-diagonal conv over the
        4-channel concat (the cross blocks are zero), then each stem's BN."""
        cd = self.compute_dtype
        k = img.new_zeros((128, 4, 7, 7), dtype=cd)
        k[:64, :3] = self.stem_rgb.conv.weight.to(cd)
        k[64:, 3:] = self.stem_depth.conv.weight.to(cd)
        x4 = torch.cat([img, depth], 1).to(cd)
        out = F.conv2d(x4.contiguous(memory_format=torch.channels_last), k,
                       padding=3)
        return self.stem_rgb.bn(out[:, :64]), self.stem_depth.bn(out[:, 64:])

    def forward(self, img: torch.Tensor, depth: torch.Tensor,
                img_indices: torch.Tensor, point_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[Dict[str, torch.Tensor], None, Dict[str, torch.Tensor]]:
        """img (B, H, W, 3), depth (B, H, W, 1) float; img_indices (B, N, 2)
        int32; point_mask (B, N) bool; `generator` (on the device) feeds the
        dropout in train mode."""
        h, w = img.shape[1], img.shape[2]
        pad_h, pad_w = (-h) % 16, (-w) % 16
        img = F.pad(img.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h))
        depth = F.pad(depth.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h))

        rgb_stem, depth_stem = self._stems(img, depth)
        rgb = self.rgb_backbone(rgb_stem, generator)
        dep = self.depth_backbone(depth_stem, generator)

        x = self.up5(torch.cat([dep[4], rgb[4]], 1))
        x = self.fuse4(torch.cat([dep[3], x, rgb[3]], 1))
        x = self.up4(x)
        x = self.fuse3(torch.cat([dep[2], x, rgb[2]], 1))
        x = self.up3(x)
        x = self.fuse2(torch.cat([dep[1], x, rgb[1]], 1))
        x = self.up2(x)

        # conv3x3(cat, Wd) @ Kh == conv3x3(cat, Wd @ Kh): compose the heads
        nc = self.num_classes
        k_heads = torch.cat([self.head_conv.weight[:, :, 0, 0],
                             self.aux_conv.weight[:, :, 0, 0]]).T  # (64, 2nc)
        w12 = torch.einsum("ochw,od->dchw", self.dec_conv_stage1.weight, k_heads)
        b12 = self.dec_conv_stage1.bias @ k_heads
        cd = self.compute_dtype
        if self.fused_head and head2d.supports(img.shape[2], img.shape[3], h, w,
                                               2 * nc):
            # NHWC views of the channels_last pieces; HWIO weights
            pieces = [t.permute(0, 2, 3, 1).contiguous() for t in (dep[0], x, rgb[0])]
            y = head2d.HeadPool.apply(h, w, cd, w12.permute(2, 3, 1, 0), b12,
                                      *pieces)  # (B, h, w, 2nc)
        else:
            x_cat = torch.cat([dep[0], x, rgb[0]], 1)
            y = conv2d(x_cat, w12, None, 1, 1, cd).float() + b12[None, :, None, None]
            # pooled in NCHW layout: CUDA's avg_pool2d backward gives wrong
            # gradients for channels_last input (torch 2.11 on an H100, held
            # against the CPU's in tests/test_torch_kernels_cuda.py)
            y = F.avg_pool2d(y[:, :, :h, :w].contiguous(), 5, stride=1, padding=2,
                             count_include_pad=True)
            y = y.permute(0, 2, 3, 1)  # (B, h, w, 2nc)

        seg_logit_2d = y[..., :nc] + self.head_conv.bias
        seg_logit_avg_2d = y[..., nc:] + self.aux_conv.bias
        preds = {
            "seg_logit": lift_image_features(seg_logit_2d, img_indices, point_mask),
            "seg_logit_2d": seg_logit_2d,
        }
        aux = {
            "seg_logit_avg": lift_image_features(seg_logit_avg_2d, img_indices,
                                                 point_mask),
            "seg_logit_avg_2d": seg_logit_avg_2d,
        }
        return preds, None, aux
