"""`net3d`: the SCN U-Net of the program's `Net3DSeg`, in both of its forms.

A submanifold 3x3x3 input convolution to m channels, a sparse U-Net over
`num_planes` levels of m, 2m, ... channels (`backbone_3d`), each level
`block_reps` blocks, the levels joined by BatchNorm, ReLU and a stride-2
convolution down and a transposed one up, the decoder's first block of a
level over [encoder skip, up]; a last BatchNorm and ReLU.  A block is
pre-activation (BatchNorm, ReLU, submanifold convolution), or with
`residual_blocks` SCN's residual block: the input (or its 1x1 product with
`nin_kernel` (Cin, Cout) where the widths differ) plus (BatchNorm, ReLU,
submanifold convolution) twice.  Its BatchNorms have eps 1e-4 and
normalise over the active voxels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..nets import Q, bn_names, down_conv, point_heads, pool_points, subm_conv, up_conv
from ..voxels import Level, Voxels

EPS = 1e-4
U = "net_3d.unet"
SPCONV_MODULES = tuple(f"mm2d3d_tpu_torch.models.sparse_unet.{c}"
                       for c in ("SubmConv", "DownConv", "UpConv"))


def _sizes(config: Dict):
    b3 = config["models"]["net3d"]["backbone_3d"]
    m, n = b3["m"], b3["num_planes"]
    return (config["num_classes"], m, [(i + 1) * m for i in range(n)],
            b3.get("block_reps", 1), b3.get("in_channels", 3),
            b3.get("residual_blocks", False))


def _blocks(planes: List[int], reps: int):
    """(name, level, Cin, Cout) of every block, in the order of the forward."""
    out = []
    for l in range(len(planes)):
        out += [(f"enc_{l}_{r}", l, planes[l], planes[l]) for r in range(reps)]
    for l in range(len(planes) - 2, -1, -1):
        out += [(f"dec_{l}_{r}", l, 2 * planes[l] if r == 0 else planes[l], planes[l])
                for r in range(reps)]
    return out


def template(config: Dict) -> Dict[str, Tuple[int, ...]]:
    nc, m, planes, reps, cin0, residual = _sizes(config)
    t = {"linear_rgb_mask.weight": (1, cin0), "linear_rgb_mask.bias": (1,),
         "net_3d.input_conv.weight": (27, cin0, m)}
    for l in range(1, len(planes)):
        t.update(bn_names(f"{U}.down_bn_{l}", planes[l - 1]))
        t[f"{U}.down_{l}.weight"] = (8, planes[l - 1], planes[l])
    for l in range(len(planes) - 1):
        t.update(bn_names(f"{U}.up_bn_{l}", planes[l + 1]))
        t[f"{U}.up_{l}.weight"] = (8, planes[l + 1], planes[l])
    for name, _, cin, cout in _blocks(planes, reps):
        b = f"{U}.{name}"
        if not residual:
            t.update(bn_names(f"{b}.bn", cin))
            t[f"{b}.conv.weight"] = (27, cin, cout)
            continue
        if cin != cout:
            t[f"{b}.nin_kernel"] = (cin, cout)
        t.update(bn_names(f"{b}.bn1", cin))
        t[f"{b}.conv1.weight"] = (27, cin, cout)
        t.update(bn_names(f"{b}.bn2", cout))
        t[f"{b}.conv2.weight"] = (27, cout, cout)
    t.update(bn_names("net_3d.out_bn", m))
    for head in ("linear", "aux_linear_point"):
        t[f"{head}.weight"] = (nc, m)
        t[f"{head}.bias"] = (nc,)
    return t


def fan_in(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    return shape[0] if name.endswith(".nin_kernel") else None


def _bn(x, W, name, train):
    if train:
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
    else:
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    return (x - mean) * torch.rsqrt(var + EPS) * W[f"{name}.weight"] + W[f"{name}.bias"]


def _block(x: torch.Tensor, W, b: str, level: Level, residual: bool, train: bool,
           q: Q) -> torch.Tensor:
    if not residual:
        return subm_conv(torch.relu(_bn(x, W, f"{b}.bn", train)), level,
                         W[f"{b}.conv.weight"], q)
    nin = W.get(f"{b}.nin_kernel")
    shortcut = x if nin is None else q(x) @ q(nin)
    y = subm_conv(torch.relu(_bn(x, W, f"{b}.bn1", train)), level, W[f"{b}.conv1.weight"], q)
    y = subm_conv(torch.relu(_bn(y, W, f"{b}.bn2", train)), level, W[f"{b}.conv2.weight"], q)
    return shortcut + y


def forward(W: Dict[str, torch.Tensor], feats: torch.Tensor, vox: Voxels, config: Dict,
            train: bool, q: Q) -> Dict[str, torch.Tensor]:
    _, _, planes, reps, _, residual = _sizes(config)
    x = subm_conv(pool_points(W, feats, vox), vox.levels[0], W["net_3d.input_conv.weight"], q)
    enc = []
    for l in range(len(planes)):
        if l > 0:
            y = torch.relu(_bn(x, W, f"{U}.down_bn_{l}", train))
            x = down_conv(y, vox.transitions[l - 1], vox.levels[l].num_voxels,
                          W[f"{U}.down_{l}.weight"], q)
        for r in range(reps):
            x = _block(x, W, f"{U}.enc_{l}_{r}", vox.levels[l], residual, train, q)
        enc.append(x)
    for l in range(len(planes) - 2, -1, -1):
        y = torch.relu(_bn(x, W, f"{U}.up_bn_{l}", train))
        x = torch.cat([enc[l], up_conv(y, vox.transitions[l], W[f"{U}.up_{l}.weight"], q)], 1)
        for r in range(reps):
            x = _block(x, W, f"{U}.dec_{l}_{r}", vox.levels[l], residual, train, q)
    x = torch.relu(_bn(x, W, "net_3d.out_bn", train))
    return point_heads(W, x, vox)


def convs(vox: Voxels, config: Dict) -> List[Tuple[int, int, int, int, int, int]]:
    _, m, planes, reps, cin0, residual = _sizes(config)
    v = [lv.num_voxels for lv in vox.levels]
    p = [lv.num_pairs() for lv in vox.levels]

    def block(l, cin, cout):
        subm = [(p[l], v[l], v[l], cin, cout, 27)]
        return subm + [(p[l], v[l], v[l], cout, cout, 27)] if residual else subm

    out = [(p[0], v[0], v[0], cin0, m, 27)]
    for l in range(len(planes)):
        if l > 0:
            out.append((v[l - 1], v[l - 1], v[l], planes[l - 1], planes[l], 8))
        for r in range(reps):
            out += block(l, planes[l], planes[l])
    for l in range(len(planes) - 2, -1, -1):
        out.append((v[l], v[l + 1], v[l], planes[l + 1], planes[l], 8))
        for r in range(reps):
            out += block(l, 2 * planes[l] if r == 0 else planes[l], planes[l])
    return out


def dense_flops(vox: Voxels, points: int, config: Dict) -> int:
    nc, m, planes, reps, cin0, residual = _sizes(config)
    nin = sum(2 * vox.levels[l].num_voxels * cin * cout
              for _, l, cin, cout in _blocks(planes, reps) if residual and cin != cout)
    return 2 * points * cin0 + 2 * 2 * points * m * nc + nin
