"""`toy3d`: the reference module of the toy 3D network that
`test_bench_arch3d.py` registers with the program: gate and pool, one
submanifold 3x3x3 convolution to m channels, BatchNorm and ReLU, unpool,
both heads.  The tests put this directory on `reference.arch3d`'s path, as
if the file had been added there."""

from __future__ import annotations

import torch

from ..nets import bn_names, point_heads, pool_points, subm_conv

SPCONV_MODULES = ("mm2d3d_tpu_torch.models.sparse_unet.SubmConv",)


def _sizes(config):
    b3 = config["models"]["net3d"]["backbone_3d"]
    return config["num_classes"], b3.get("in_channels", 3), b3["m"]


def template(config):
    nc, cin, m = _sizes(config)
    t = {"linear_rgb_mask.weight": (1, cin), "linear_rgb_mask.bias": (1,),
         "conv.weight": (27, cin, m), **bn_names("bn", m)}
    for head in ("linear", "aux_linear_point"):
        t[f"{head}.weight"] = (nc, m)
        t[f"{head}.bias"] = (nc,)
    return t


def forward(W, feats, vox, config, train, q):
    x = subm_conv(pool_points(W, feats, vox), vox.levels[0], W["conv.weight"], q)
    if train:
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
    else:
        mean, var = W["bn.running_mean"], W["bn.running_var"]
    x = torch.relu((x - mean) * torch.rsqrt(var + 1e-4) * W["bn.weight"] + W["bn.bias"])
    return point_heads(W, x, vox)


def convs(vox, config):
    _, cin, m = _sizes(config)
    v0 = vox.levels[0].num_voxels
    return [(vox.levels[0].num_pairs(), v0, v0, cin, m, 27)]


def dense_flops(vox, points, config):
    nc, cin, m = _sizes(config)
    return 2 * points * cin + 2 * 2 * points * m * nc
