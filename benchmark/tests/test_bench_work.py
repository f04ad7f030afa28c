"""The FLOP and byte counters against hand-worked cases and against
PyTorch's own FLOP counter over the reference."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from core import work
from reference import nets, voxels
from reference.arch3d import net3d
from reference.quant import fp32


def _config(m, nc, num_planes, reps, residual):
    return {"num_classes": nc, "models": {"net3d": {"backbone_3d": {
        "m": m, "num_planes": num_planes, "block_reps": reps, "in_channels": 3,
        "residual_blocks": residual}}}}


def test_conv_flops_by_hand():
    # 2 x 3 in, 4 out, 3x3 kernel, 5x6 output: 2 * 3 * 4 * 9 * 30
    assert work.conv_flops(3, 4, 3, 5, 6) == 6480


def test_bound_is_the_larger_of_bytes_and_flops():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_spconv_least_time_by_hand():
    # one conv: 10 pairs, 4 rows in and out, 2 -> 3 channels, 27 taps
    conv = (10, 4, 4, 2, 3, 27)
    flops = 2 * 10 * 2 * 3
    fwd = (4 * 2 * 2 + 27 * 2 * 3 * 2 + 4 * 3 * 4) / 3.35e12
    dx = (4 * 3 * 2 + 27 * 2 * 3 * 2 + 4 * 2 * 4) / 3.35e12
    dw = (4 * 2 * 2 + 4 * 3 * 2 + 27 * 2 * 3 * 4) / 3.35e12
    assert flops / 989e12 < min(fwd, dx, dw)
    assert work.spconv_least_s([conv], train=False) == pytest.approx(fwd)
    assert work.spconv_least_s([conv], train=True) == pytest.approx(fwd + dx + dw)


def _counts(level_voxels, level_pairs):
    """A voxelisation with only its counts: levels of `level_voxels` voxels
    and `level_pairs` submanifold pairs."""
    return SimpleNamespace(levels=[SimpleNamespace(num_voxels=v, num_pairs=lambda p=p: p)
                                   for v, p in zip(level_voxels, level_pairs)])


def test_spconvs_of_a_two_level_net():
    # levels of 10 and 4 voxels, 30 and 8 pairs, m = 2, one block a level
    convs = net3d.convs(_counts([10, 4], [30, 8]), _config(2, 6, 2, 1, False))
    assert convs == [(30, 10, 10, 3, 2, 27),  # input conv
                     (30, 10, 10, 2, 2, 27),  # enc 0
                     (10, 10, 4, 2, 4, 8),  # down 1 (one pair per fine voxel)
                     (8, 4, 4, 4, 4, 27),  # enc 1
                     (10, 4, 10, 4, 2, 8),  # up 0
                     (30, 10, 10, 4, 2, 27)]  # dec 0 over the concat


def test_residual_spconvs_and_shortcuts_of_a_two_level_net():
    # as above with residual blocks: two convs a block, and dec 0's 4 -> 2
    # shortcut a 1x1 product over the 10 voxels of level 0
    vox = _counts([10, 4], [30, 8])
    config = _config(2, 6, 2, 1, True)
    assert net3d.convs(vox, config) == [(30, 10, 10, 3, 2, 27),
                                        (30, 10, 10, 2, 2, 27), (30, 10, 10, 2, 2, 27),
                                        (10, 10, 4, 2, 4, 8),
                                        (8, 4, 4, 4, 4, 27), (8, 4, 4, 4, 4, 27),
                                        (10, 4, 10, 4, 2, 8),
                                        (30, 10, 10, 4, 2, 27), (30, 10, 10, 2, 2, 27)]
    points = 50
    assert net3d.dense_flops(vox, points, config) == (2 * points * 3 + 2 * 2 * points * 2 * 6
                                                      + 2 * 10 * 4 * 2)


def test_net2d_flops_match_torch_flop_counter():
    h, w, nc, b = 30, 44, 6, 2
    W = {n: torch.randn(s) * 0.05 for n, s in nets.template2d(nc).items()}
    for n in W:
        if n.endswith("running_var"):
            W[n] = W[n].abs() + 1
    img = torch.rand(b, h, w, 3)
    depth = torch.rand(b, h, w, 1)
    idx = torch.zeros(b, 5, 2, dtype=torch.int32)
    mask = torch.ones(b, 5, dtype=torch.bool)
    with FlopCounterMode(display=False) as fc:
        nets.net2d(W, img, depth, idx, mask, False, None, fp32)
    assert fc.get_total_flops() == b * work.net2d_flops(h, w, nc)


def _net3d_flops_against_torch(residual, reps):
    rng = np.random.RandomState(0)
    coords = torch.as_tensor(rng.randint(0, 40, (2, 300, 3)))
    mask = torch.as_tensor(rng.rand(2, 300) < 0.9)
    vox = voxels.voxelize(coords, mask, 64, 4)
    config = _config(4, 3, 4, reps, residual)
    W = {n: torch.randn(s) * 0.1 for n, s in net3d.template(config).items()}
    feats = torch.rand(600, 3)
    with FlopCounterMode(display=False) as fc:
        net3d.forward(W, feats, vox, config, False, fp32)
    # the reference applies the gate and the heads to every point
    counted = (work.spconv_flops(net3d.convs(vox, config))
               + net3d.dense_flops(vox, 600, config))
    assert fc.get_total_flops() == counted


def test_net3d_flops_match_torch_flop_counter():
    _net3d_flops_against_torch(residual=False, reps=1)


def test_residual_net3d_flops_match_torch_flop_counter():
    _net3d_flops_against_torch(residual=True, reps=2)


def test_voxel_pairs_by_hand():
    # two voxels side by side in x, one alone: 2 + 2 + 1 pairs with the centre
    coords = torch.tensor([[[0, 0, 0], [1, 0, 0], [5, 5, 5]]])
    vox = voxels.voxelize(coords, torch.ones(1, 3, dtype=torch.bool), 8, 2)
    assert [lv.num_voxels for lv in vox.levels] == [3, 2]
    assert vox.levels[0].num_pairs() == 5
    assert vox.levels[1].num_pairs() == 2
    assert vox.transitions[0].tap.tolist() == [0, 4, 7]
