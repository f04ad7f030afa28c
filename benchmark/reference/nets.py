"""The 2D network of the MM2D3D task, and the pieces every 3D network
shares, as plain functions of a weight dict.

2D: two ResNet-34 encoders (RGB and sparse depth; 7x7 stride-1 stems, a
3x3 stride-2 max pool, stages of 3, 4, 6, 3 basic blocks, dropout 0.4 after
the third and fourth stages in training), a U-Net decoder of 2x2 stride-2
transposed convolutions and 3x3 fusions over [depth skip, up, RGB skip], a
3x3 convolution to 64 channels, cropped to the image, a 5x5 average pool
(zero padding counted), and two 1x1 heads (segmentation and the auxiliary
cross-modal head); point logits are gathered at each point's pixel.
BatchNorms normalise with the batch's biased statistics in training and
with the running statistics in eval mode.  Weight names are those of the
published layout (`template2d`), so one weight dict serves the reference
and the program.

3D: each network's layout, forward and work count live in its own module
of `arch3d`, found by the configuration's `models.net3d.name`.  Here are
what they share: the submanifold, stride-2 and transposed sparse
convolutions over the reference's voxelisation, and the program's
`Net3DSeg` wrapper around a trunk (a sigmoid gate on the RGB point
features and mean pooling into level-0 voxels, `pool_points`; the voxel
features scattered back to the points and two linear heads,
`point_heads`).  `q` is the operand precision of every product (`quant`).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from .voxels import Level, Transition, Voxels

Q = Callable[[torch.Tensor], torch.Tensor]
STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
DROPOUT = 0.4


def bn_names(prefix: str, c: int) -> Dict[str, Tuple[int, ...]]:
    return {f"{prefix}.{k}": (c,) for k in
            ("weight", "bias", "running_mean", "running_var")}


def template2d(num_classes: int) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every 2D weight and running statistic."""
    t = {}
    for stem, cin in (("stem_rgb", 3), ("stem_depth", 1)):
        t[f"{stem}.conv.weight"] = (64, cin, 7, 7)
        t.update(bn_names(f"{stem}.bn", 64))
    for enc in ("rgb_backbone", "depth_backbone"):
        cin = 64
        for i, (blocks, width) in enumerate(STAGES):
            for b in range(blocks):
                n = f"{enc}.layer{i + 1}_{b}"
                stride = 2 if (b == 0 and i > 0) else 1
                t[f"{n}.cb1.conv.weight"] = (width, cin, 3, 3)
                t.update(bn_names(f"{n}.cb1.bn", width))
                t[f"{n}.cb2.conv.weight"] = (width, width, 3, 3)
                t.update(bn_names(f"{n}.cb2.bn", width))
                if stride != 1 or cin != width:
                    t[f"{n}.downsample.conv.weight"] = (width, cin, 1, 1)
                    t.update(bn_names(f"{n}.downsample.bn", width))
                cin = width
    for up, cin, cout in (("up5", 1024, 256), ("up4", 256, 128),
                          ("up3", 128, 64), ("up2", 64, 64)):
        t[f"{up}.tconv.weight"] = (cin, cout, 2, 2)
        t[f"{up}.tconv.bias"] = (cout,)
        t.update(bn_names(f"{up}.bn", cout))
    for fuse, c in (("fuse4", 256), ("fuse3", 128), ("fuse2", 64)):
        t[f"{fuse}.conv.weight"] = (c, 3 * c, 3, 3)
        t[f"{fuse}.conv.bias"] = (c,)
        t.update(bn_names(f"{fuse}.bn", c))
    t["dec_conv_stage1.weight"] = (64, 192, 3, 3)
    t["dec_conv_stage1.bias"] = (64,)
    for head in ("head_conv", "aux_conv"):
        t[f"{head}.weight"] = (num_classes, 64, 1, 1)
        t[f"{head}.bias"] = (num_classes,)
    return t


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------

def _bn2d(x, W, name, train):
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
    else:
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    c = (1, -1, 1, 1)
    return ((x - mean.view(c)) * torch.rsqrt(var + 1e-5).view(c)
            * W[f"{name}.weight"].view(c) + W[f"{name}.bias"].view(c))


def _conv(x, w, q, bias=None, stride=1, padding=0):
    return F.conv2d(q(x), q(w), bias, stride=stride, padding=padding)


def _dropout(x, gen):
    """Keep with probability 1 - rate, drawn from `gen` over a tensor laid
    out as the program lays out its feature maps (NHWC in memory)."""
    keep_prob = 1.0 - DROPOUT
    u = torch.empty_like(x, memory_format=torch.channels_last)
    keep = u.uniform_(generator=gen) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), device=x.device))


def _encoder(x, W, prefix, train, gen, q):
    x = torch.relu(x)
    feats = [x]
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    cin = 64
    for i, (blocks, width) in enumerate(STAGES):
        for b in range(blocks):
            n = f"{prefix}.layer{i + 1}_{b}"
            stride = 2 if (b == 0 and i > 0) else 1
            y = _bn2d(_conv(x, W[f"{n}.cb1.conv.weight"], q, stride=stride, padding=1),
                      W, f"{n}.cb1.bn", train)
            y = _bn2d(_conv(torch.relu(y), W[f"{n}.cb2.conv.weight"], q, padding=1),
                      W, f"{n}.cb2.bn", train)
            if stride != 1 or cin != width:
                idt = _bn2d(_conv(x, W[f"{n}.downsample.conv.weight"], q, stride=stride),
                            W, f"{n}.downsample.bn", train)
            else:
                idt = x
            x = torch.relu(y + idt)
            cin = width
        if i >= 2 and train:
            x = _dropout(x, gen)
        feats.append(x)
    return feats


def lift(fmap: torch.Tensor, img_indices: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) at each point's (row, col), clamped into the image;
    points outside the mask get zeros -> (B, N, C)."""
    b, h, w, _ = fmap.shape
    rows = img_indices[..., 0].long().clamp(0, h - 1)
    cols = img_indices[..., 1].long().clamp(0, w - 1)
    out = fmap[torch.arange(b, device=fmap.device)[:, None], rows, cols]
    return torch.where(mask[..., None], out, torch.zeros((), device=out.device))


def net2d(W: Dict[str, torch.Tensor], img: torch.Tensor, depth: torch.Tensor,
          img_indices: torch.Tensor, point_mask: torch.Tensor, train: bool,
          gen, q: Q) -> Dict[str, torch.Tensor]:
    """img (B, H, W, 3), depth (B, H, W, 1) fp32 -> {"seg_logit",
    "seg_logit_avg"}: (B, N, nc) point logits of the two heads."""
    h, w = img.shape[1], img.shape[2]
    pad = (0, (-w) % 16, 0, (-h) % 16)
    # NCHW-contiguous throughout: on the card, PyTorch's avg_pool2d
    # backward is wrong for channels_last input (torch 2.11, H100)
    x_img = F.pad(img.permute(0, 3, 1, 2).contiguous(), pad)
    x_dep = F.pad(depth.permute(0, 3, 1, 2).contiguous(), pad)
    rgb = _encoder(_bn2d(_conv(x_img, W["stem_rgb.conv.weight"], q, padding=3),
                         W, "stem_rgb.bn", train), W, "rgb_backbone", train, gen, q)
    dep = _encoder(_bn2d(_conv(x_dep, W["stem_depth.conv.weight"], q, padding=3),
                         W, "stem_depth.bn", train), W, "depth_backbone", train, gen, q)

    def up(x, name):
        y = F.conv_transpose2d(q(x), q(W[f"{name}.tconv.weight"]),
                               W[f"{name}.tconv.bias"], stride=2)
        return torch.relu(_bn2d(y, W, f"{name}.bn", train))

    def fuse(x, name):
        y = _conv(x, W[f"{name}.conv.weight"], q, W[f"{name}.conv.bias"], padding=1)
        return torch.relu(_bn2d(y, W, f"{name}.bn", train))

    x = up(torch.cat([dep[4], rgb[4]], 1), "up5")
    x = up(fuse(torch.cat([dep[3], x, rgb[3]], 1), "fuse4"), "up4")
    x = up(fuse(torch.cat([dep[2], x, rgb[2]], 1), "fuse3"), "up3")
    x = up(fuse(torch.cat([dep[1], x, rgb[1]], 1), "fuse2"), "up2")
    dec = _conv(torch.cat([dep[0], x, rgb[0]], 1), W["dec_conv_stage1.weight"], q,
                W["dec_conv_stage1.bias"], padding=1)[:, :, :h, :w].contiguous()
    pooled = F.avg_pool2d(dec, 5, stride=1, padding=2, count_include_pad=True)
    out = {}
    for key, head in (("seg_logit", "head_conv"), ("seg_logit_avg", "aux_conv")):
        logits = torch.einsum("bdhw,cd->bhwc", q(pooled), q(W[f"{head}.weight"][:, :, 0, 0]))
        out[key] = lift(logits + W[f"{head}.bias"], img_indices, point_mask)
    return out


# ---------------------------------------------------------------------------
# 3D building blocks
# ---------------------------------------------------------------------------

def subm_conv(x: torch.Tensor, level: Level, w: torch.Tensor, q: Q) -> torch.Tensor:
    """out[v] = sum over taps k of x[v + offset_k] @ w[k]."""
    xq, wq = q(x), q(w)
    out = x.new_zeros(level.num_voxels, w.shape[2])
    for k, (rows_out, rows_in) in enumerate(level.pairs):
        if rows_out.numel():
            out = out.index_add(0, rows_out, xq[rows_in] @ wq[k])
    return out


def down_conv(x: torch.Tensor, tr: Transition, num_coarse: int, w: torch.Tensor,
              q: Q) -> torch.Tensor:
    """out[c] = sum over the children f of c of x[f] @ w[tap(f)]."""
    xq, wq = q(x), q(w)
    out = x.new_zeros(num_coarse, w.shape[2])
    for t, rows in enumerate(tr.rows_by_tap()):
        if rows.numel():
            out = out.index_add(0, tr.parent[rows], xq[rows] @ wq[t])
    return out


def up_conv(x: torch.Tensor, tr: Transition, w: torch.Tensor, q: Q) -> torch.Tensor:
    """out[f] = x[parent(f)] @ w[tap(f)]."""
    xq, wq = q(x), q(w)
    out = x.new_zeros(tr.parent.shape[0], w.shape[2])
    for t, rows in enumerate(tr.rows_by_tap()):
        if rows.numel():
            out = out.index_add(0, rows, xq[tr.parent[rows]] @ wq[t])
    return out


def pool_points(W: Dict[str, torch.Tensor], feats: torch.Tensor,
                vox: Voxels) -> torch.Tensor:
    """The program's `Net3DSeg` input: feats (P, C) fp32 point features
    gated by the sigmoid of `linear_rgb_mask`, mean-pooled into the
    level-0 voxels -> (V0, C)."""
    gate = torch.sigmoid(feats @ W["linear_rgb_mask.weight"].T + W["linear_rgb_mask.bias"])
    gated = feats * gate
    ok = vox.point_voxel >= 0
    v0 = vox.levels[0].num_voxels
    return gated.new_zeros(v0, gated.shape[1]).index_add(
        0, vox.point_voxel[ok], gated[ok]) / vox.counts.clamp(min=1)[:, None].to(gated.dtype)


def point_heads(W: Dict[str, torch.Tensor], x: torch.Tensor,
                vox: Voxels) -> Dict[str, torch.Tensor]:
    """The program's `Net3DSeg` output: the (V0, m) voxel features scattered
    back to the points (zeros for a point in no voxel) -> {"seg_logit",
    "seg_logit_point"}: (P, nc) logits of the main and the auxiliary head."""
    ok = vox.point_voxel >= 0
    v0 = vox.levels[0].num_voxels
    padded = torch.cat([x, x.new_zeros(1, x.shape[1])])
    point_out = padded[torch.where(ok, vox.point_voxel, v0)]
    return {key: point_out @ W[f"{head}.weight"].T + W[f"{head}.bias"]
            for key, head in (("seg_logit", "linear"),
                              ("seg_logit_point", "aux_linear_point"))}
