"""`minkunet34c`: MinkUNet34C (Choy, Gwak and Savarese, CVPR 2019;
`NVIDIA/MinkowskiEngine` `examples/minkunet.py`, class `MinkUNet34C`) as the
3D branch, in the program's `Net3DSeg` wrapper (gate, pool, unpool, heads).

The published sizes: `LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)`, `PLANES = (32, 64,
128, 256, 256, 128, 96, 96)`, `INIT_DIM = 32`, BasicBlocks; five levels.
A submanifold 5x5x5 stem (in_channels -> 32, 125 taps over the offsets
{-2..2}^3 in lexicographic order, pairs searched here, since `voxels`
holds the 27 of a 3x3x3 kernel), BatchNorm and ReLU (`out_p1`); four times
a 2^3 stride-2 convolution Ci -> Ci, BatchNorm, ReLU and a stage of
BasicBlocks; four times a 2^3 stride-2 transposed convolution, BatchNorm,
ReLU, the concatenation [up, skip] and a stage of two BasicBlocks.  A
BasicBlock is relu(bn2(conv2(relu(bn1(conv1(x))))) + shortcut(x)) with
submanifold 3x3x3 convolutions; the shortcut is x, or where the widths
differ a 1x1 convolution (weight (Cin, Cout)) and a BatchNorm.  No
convolution has a bias; BatchNorms have eps 1e-5 and normalise over the
active voxels.  The heads are linear layers on the 96-wide point features:
`linear` is MinkowskiEngine's `final` 1x1 convolution applied after the
unpool (an unpool is a gather, so the function is the same),
`aux_linear_point` the cross-modal head.  Departures from the published
module: the layouts above, and the running variance, which the program
moves by the biased variance (MinkowskiBatchNorm by the unbiased one); no
train step's output depends on it.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import torch

from ..nets import Q, bn_names, down_conv, point_heads, pool_points, subm_conv, up_conv
from ..voxels import Level, Voxels, _decode, _key

LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
INIT_DIM = 32
EPS = 1e-5
T = "net_3d"
OFFSETS_125 = list(itertools.product(range(-2, 3), repeat=3))
SPCONV_MODULES = tuple(f"mm2d3d_tpu_torch.models.sparse_unet.{c}"
                       for c in ("SubmConv", "DownConv", "UpConv"))


def _sizes(config: Dict):
    b3 = config["models"]["net3d"]["backbone_3d"]
    return config["num_classes"], b3.get("in_channels", 3)


def _stages():
    """(stage name, level, Cin of its first block, Cout, blocks) in the
    order of the forward; level l has stride 2^l."""
    out, c = [], INIT_DIM
    for i in range(4):
        out.append((f"block{i + 1}", i + 1, c, PLANES[i], LAYERS[i]))
        c = PLANES[i]
    skips = (INIT_DIM,) + PLANES[:3]
    for j in range(4):
        out.append((f"block{5 + j}", 3 - j, PLANES[4 + j] + skips[3 - j], PLANES[4 + j],
                    LAYERS[4 + j]))
    return out


def _blocks():
    """(name, level, Cin, Cout) of every BasicBlock, in the forward's order."""
    return [(f"{T}.{s}.{b}", lvl, cin if b == 0 else cout, cout)
            for s, lvl, cin, cout, n in _stages() for b in range(n)]


def _strided():
    """(name of the conv, name of its BatchNorm, fine level, Cin, Cout, up)
    of the four stride-2 and the four transposed convolutions."""
    out, c = [], INIT_DIM
    for i in range(4):
        out.append((f"{T}.conv{i + 1}p{1 << i}s2", f"{T}.bn{i + 1}", i, c, c, False))
        c = PLANES[i]
    for j in range(4):
        out.append((f"{T}.convtr{4 + j}p{16 >> j}s2", f"{T}.bntr{4 + j}", 3 - j, c,
                    PLANES[4 + j], True))
        c = PLANES[4 + j]
    return out


def template(config: Dict) -> Dict[str, Tuple[int, ...]]:
    nc, cin0 = _sizes(config)
    t = {"linear_rgb_mask.weight": (1, cin0), "linear_rgb_mask.bias": (1,),
         f"{T}.conv0p1s1.weight": (125, cin0, INIT_DIM), **bn_names(f"{T}.bn0", INIT_DIM)}
    for conv, bn, _, cin, cout, _ in _strided():
        t[f"{conv}.weight"] = (8, cin, cout)
        t.update(bn_names(bn, cout))
    for b, _, cin, cout in _blocks():
        t[f"{b}.conv1.weight"] = (27, cin, cout)
        t.update(bn_names(f"{b}.norm1", cout))
        t[f"{b}.conv2.weight"] = (27, cout, cout)
        t.update(bn_names(f"{b}.norm2", cout))
        if cin != cout:
            t[f"{b}.downsample.conv.weight"] = (cin, cout)
            t.update(bn_names(f"{b}.downsample.bn", cout))
    for head in ("linear", "aux_linear_point"):
        t[f"{head}.weight"] = (nc, PLANES[-1])
        t[f"{head}.bias"] = (nc,)
    return t


def fan_in(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """A 1x1 shortcut's (Cin, Cout) weight is drawn over Cin; every other
    leaf's layout gives its fan-in."""
    return shape[0] if name.endswith(".downsample.conv.weight") else None


def stem_level(level: Level) -> Level:
    """Level 0 with the pairs of the 5x5x5 kernel (125 offsets) in place of
    those of the 3x3x3 one."""
    scan, coords = _decode(level.keys, level.full_scale)
    fs, v = level.full_scale, level.num_voxels
    pairs = []
    for off in OFFSETS_125:
        q = coords + torch.tensor(off, device=level.keys.device)
        inside = ((q >= 0) & (q < fs)).all(1)
        qk = _key(scan, q.clamp(0, fs - 1), fs)
        pos = torch.searchsorted(level.keys, qk).clamp(max=v - 1)
        hit = inside & (level.keys[pos] == qk)
        pairs.append((torch.nonzero(hit)[:, 0], pos[hit]))
    return Level(keys=level.keys, coords=coords, full_scale=fs, pairs=pairs)


def _bn(x, W, name, train):
    if train:
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
    else:
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    return (x - mean) * torch.rsqrt(var + EPS) * W[f"{name}.weight"] + W[f"{name}.bias"]


def _block(x, W, b: str, level: Level, train: bool, q: Q) -> torch.Tensor:
    y = torch.relu(_bn(subm_conv(x, level, W[f"{b}.conv1.weight"], q), W, f"{b}.norm1",
                       train))
    y = _bn(subm_conv(y, level, W[f"{b}.conv2.weight"], q), W, f"{b}.norm2", train)
    nin = W.get(f"{b}.downsample.conv.weight")
    if nin is not None:
        x = _bn(q(x) @ q(nin), W, f"{b}.downsample.bn", train)
    return torch.relu(y + x)


def forward(W: Dict[str, torch.Tensor], feats: torch.Tensor, vox: Voxels, config: Dict,
            train: bool, q: Q) -> Dict[str, torch.Tensor]:
    lv = vox.levels
    x = subm_conv(pool_points(W, feats, vox), stem_level(lv[0]),
                  W[f"{T}.conv0p1s1.weight"], q)
    x = torch.relu(_bn(x, W, f"{T}.bn0", train))
    skips = [x]
    strided, stages = _strided(), _stages()
    for i in range(8):
        conv, bn, fine, _, _, up = strided[i]
        stage, level, _, _, n = stages[i]
        if up:
            x = up_conv(x, vox.transitions[fine], W[f"{conv}.weight"], q)
        else:
            x = down_conv(x, vox.transitions[fine], lv[fine + 1].num_voxels,
                          W[f"{conv}.weight"], q)
        x = torch.relu(_bn(x, W, bn, train))
        if up:
            x = torch.cat([x, skips[level]], 1)
        for b in range(n):
            x = _block(x, W, f"{T}.{stage}.{b}", lv[level], train, q)
        if not up:
            skips.append(x)
    return point_heads(W, x, vox)


def convs(vox: Voxels, config: Dict) -> List[Tuple[int, int, int, int, int, int]]:
    _, cin0 = _sizes(config)
    v = [lv.num_voxels for lv in vox.levels]
    p = [lv.num_pairs() for lv in vox.levels]
    out = [(stem_level(vox.levels[0]).num_pairs(), v[0], v[0], cin0, INIT_DIM, 125)]
    blocks = _blocks()
    strided = _strided()
    for i, (stage, level, _, _, _) in enumerate(_stages()):
        _, _, fine, cin, cout, up = strided[i]
        out.append((v[fine], v[fine + 1] if up else v[fine], v[fine] if up else v[fine + 1],
                    cin, cout, 8))
        for name, lvl, bcin, bcout in blocks:
            if name.startswith(f"{T}.{stage}."):
                out += [(p[lvl], v[lvl], v[lvl], bcin, bcout, 27),
                        (p[lvl], v[lvl], v[lvl], bcout, bcout, 27)]
    return out


def dense_flops(vox: Voxels, points: int, config: Dict) -> int:
    nc, cin0 = _sizes(config)
    shortcuts = sum(2 * vox.levels[lvl].num_voxels * cin * cout
                    for _, lvl, cin, cout in _blocks() if cin != cout)
    return 2 * points * cin0 + 2 * 2 * points * PLANES[-1] * nc + shortcuts
