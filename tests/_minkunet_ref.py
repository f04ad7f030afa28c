"""Plain PyTorch reference of the MinkUNet34C branch (`models.minkunet`).

Float32 `torch` operations alone: it imports nothing of the port's ops,
kernels or topology.  It voxelises the points itself, builds its own
neighbour pairs from the voxel coordinates, and runs the gate, the mean
pool, the trunk, the unpool and both heads, from a weight dict named as
`MinkUNet34CSeg.state_dict()`.

- Voxels: level 0 holds one voxel per distinct (scan, x, y, z) among the
  valid points inside [0, full_scale)^3; level l + 1 the distinct
  (scan, x >> 1, y >> 1, z >> 1) of level l.
- A submanifold convolution of kernel size s pairs every voxel v with the
  voxel at v + d for each offset d of {-(s // 2) .. s // 2}^3, taps in
  lexicographic order: out[v] = sum_d x[v + d] @ W[d].
- The stride-2 convolution: out[c] = sum over the children f of c of
  x[f] @ W[(x & 1) * 4 + (y & 1) * 2 + (z & 1) of f]; the transposed one
  out[f] = x[parent(f)] @ W[that tap of f].
- BatchNorm over the voxels of the level (eps 1e-5): the batch's mean and
  biased variance in training, the running statistics in eval.

Departures from the published `MinkUNet34C`, shared with the program: the
main head is `final` applied to the unpooled point features (the same
function, since an unpool is a gather); the weights of the 1x1 shortcuts
are (Cin, Cout) and of the other convolutions (taps, Cin, Cout); the
running statistics are not updated here (MinkowskiBatchNorm's running
variance would move by the unbiased variance, the program's by the
biased one).  `forward` turns TF32 off, so products on a GPU stay fp32.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import torch

LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
INIT_DIM = 32
NUM_LEVELS = 5
EPS = 1e-5
T = "net_3d"

Pairs = List[Tuple[torch.Tensor, torch.Tensor]]  # per tap: (rows out, rows in)


def _key(scan, c, fs):
    return ((scan * fs + c[:, 0]) * fs + c[:, 1]) * fs + c[:, 2]


def _decode(keys, fs):
    z, y, x = keys % fs, (keys // fs) % fs, (keys // (fs * fs)) % fs
    return keys // fs ** 3, torch.stack([x, y, z], 1)


def neighbour_pairs(keys: torch.Tensor, fs: int, kernel_size: int) -> Pairs:
    """Per offset of the kernel (lexicographic): the rows v whose voxel at
    v + d exists, and those voxels' rows."""
    scan, coords = _decode(keys, fs)
    r = kernel_size // 2
    out = []
    for d in itertools.product(range(-r, r + 1), repeat=3):
        q = coords + torch.tensor(d, device=keys.device)
        inside = ((q >= 0) & (q < fs)).all(1)
        qk = _key(scan, q.clamp(0, fs - 1), fs)
        pos = torch.searchsorted(keys, qk).clamp(max=max(keys.shape[0] - 1, 0))
        hit = inside & (keys[pos] == qk)
        out.append((torch.nonzero(hit)[:, 0], pos[hit]))
    return out


def voxelize(coords: torch.Tensor, point_mask: torch.Tensor, full_scale: int,
             num_levels: int = NUM_LEVELS) -> Dict:
    """coords (B, N, 3), point_mask (B, N) -> {"keys": [(V_l,) per level],
    "fs": [grid width per level], "parent": [(V_l,) row in level l + 1],
    "tap": [(V_l,) child tap], "point_voxel": (B * N,) level-0 row or -1,
    "counts": (V0,) points per voxel}."""
    b, n = point_mask.shape
    c = coords.reshape(-1, 3).long()
    scan = torch.arange(b, device=c.device).repeat_interleave(n)
    ok = point_mask.reshape(-1) & ((c >= 0) & (c < full_scale)).all(1)
    keys, inv = torch.unique(_key(scan[ok], c[ok], full_scale), return_inverse=True)
    point_voxel = torch.full((b * n,), -1, dtype=torch.int64, device=c.device)
    point_voxel[ok] = inv
    vox = {"keys": [keys], "fs": [full_scale], "parent": [], "tap": [],
           "point_voxel": point_voxel,
           "counts": torch.bincount(inv, minlength=keys.shape[0])}
    fs = full_scale
    for _ in range(1, num_levels):
        scan_l, coords_l = _decode(vox["keys"][-1], fs)
        fs //= 2
        parent_keys, parent = torch.unique(_key(scan_l, coords_l >> 1, fs),
                                           return_inverse=True)
        rel = coords_l & 1
        vox["parent"].append(parent)
        vox["tap"].append(rel[:, 0] * 4 + rel[:, 1] * 2 + rel[:, 2])
        vox["keys"].append(parent_keys)
        vox["fs"].append(fs)
    return vox


def subm_conv(x: torch.Tensor, pairs: Pairs, w: torch.Tensor) -> torch.Tensor:
    out = x.new_zeros(x.shape[0], w.shape[2])
    for k, (rows_out, rows_in) in enumerate(pairs):
        out = out.index_add(0, rows_out, x[rows_in] @ w[k])
    return out


def down_conv(x, parent, tap, num_coarse, w):
    out = x.new_zeros(num_coarse, w.shape[2])
    for t in range(8):
        rows = torch.nonzero(tap == t)[:, 0]
        out = out.index_add(0, parent[rows], x[rows] @ w[t])
    return out


def up_conv(x, parent, tap, w):
    out = x.new_zeros(parent.shape[0], w.shape[2])
    for t in range(8):
        rows = torch.nonzero(tap == t)[:, 0]
        out = out.index_add(0, rows, x[parent[rows]] @ w[t])
    return out


def batch_norm(x, W, name, train):
    if train:
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
    else:
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    return (x - mean) * torch.rsqrt(var + EPS) * W[f"{name}.weight"] + W[f"{name}.bias"]


def basic_block(x, W, name, pairs, train):
    y = torch.relu(batch_norm(subm_conv(x, pairs, W[f"{name}.conv1.weight"]), W,
                              f"{name}.norm1", train))
    y = batch_norm(subm_conv(y, pairs, W[f"{name}.conv2.weight"]), W, f"{name}.norm2",
                   train)
    if f"{name}.downsample.conv.weight" in W:
        x = batch_norm(x @ W[f"{name}.downsample.conv.weight"], W,
                       f"{name}.downsample.bn", train)
    return torch.relu(y + x)


def trunk(x: torch.Tensor, W: Dict[str, torch.Tensor], vox: Dict,
          train: bool) -> torch.Tensor:
    """(V0, Cin) level-0 features -> (V0, 96)."""
    keys, fs = vox["keys"], vox["fs"]
    pairs = [neighbour_pairs(keys[l], fs[l], 3) for l in range(NUM_LEVELS)]
    stem = neighbour_pairs(keys[0], fs[0], 5)
    out = torch.relu(batch_norm(subm_conv(x, stem, W[f"{T}.conv0p1s1.weight"]), W,
                                f"{T}.bn0", train))
    skips = [out]
    for i in range(4):
        out = down_conv(out, vox["parent"][i], vox["tap"][i], keys[i + 1].shape[0],
                        W[f"{T}.conv{i + 1}p{1 << i}s2.weight"])
        out = torch.relu(batch_norm(out, W, f"{T}.bn{i + 1}", train))
        for b in range(LAYERS[i]):
            out = basic_block(out, W, f"{T}.block{i + 1}.{b}", pairs[i + 1], train)
        skips.append(out)
    for j in range(4):
        level = 3 - j
        out = up_conv(out, vox["parent"][level], vox["tap"][level],
                      W[f"{T}.convtr{4 + j}p{16 >> j}s2.weight"])
        out = torch.relu(batch_norm(out, W, f"{T}.bntr{4 + j}", train))
        out = torch.cat([out, skips[level]], 1)
        for b in range(LAYERS[4 + j]):
            out = basic_block(out, W, f"{T}.block{5 + j}.{b}", pairs[level], train)
    return out


def forward(W: Dict[str, torch.Tensor], feats: torch.Tensor, coords: torch.Tensor,
            point_mask: torch.Tensor, full_scale: int,
            train: bool) -> Dict[str, torch.Tensor]:
    """feats (B * N, C) point features, coords (B, N, 3), point_mask (B, N)
    -> {"seg_logit", "seg_logit_point": (B * N, nc) logits of the main and
    the auxiliary head, "confidence": (B * N, 1) the gate}.  A point in no
    voxel gets zero trunk features."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vox = voxelize(coords, point_mask, full_scale)
    gate = torch.sigmoid(feats @ W["linear_rgb_mask.weight"].T + W["linear_rgb_mask.bias"])
    gated = feats * gate
    ok = vox["point_voxel"] >= 0
    v0 = vox["keys"][0].shape[0]
    pooled = gated.new_zeros(v0, gated.shape[1]).index_add(
        0, vox["point_voxel"][ok], gated[ok]) / vox["counts"].clamp(min=1)[:, None]
    x = trunk(pooled, W, vox, train)
    point_out = torch.cat([x, x.new_zeros(1, x.shape[1])])[
        torch.where(ok, vox["point_voxel"], v0)]
    return {"seg_logit": point_out @ W["linear.weight"].T + W["linear.bias"],
            "seg_logit_point": point_out @ W["aux_linear_point.weight"].T
            + W["aux_linear_point.bias"],
            "confidence": gate}
