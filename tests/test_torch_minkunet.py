"""MinkUNet34C as the 3D branch (`models/minkunet.py`) against its plain
reference (`tests/_minkunet_ref.py`), its 125-neighbour table against a
brute-force search, its 5^3 stem's gradients against autograd, the KITTI
config through the task, the host-topology refusal, and the SCN path left
as it was.  CPU, 2 scans of at most 1,024 points, full_scale 128."""

import hashlib
import itertools
import math

import numpy as np
import pytest
import torch

from mm2d3d_tpu_torch.data.synthetic import make_batch
import _minkunet_ref as ref
from mm2d3d_tpu_torch.models.minkunet import (
    LAYERS, PLANES, INIT_DIM, MinkUNet34CSeg, Shortcut,
)
from mm2d3d_tpu_torch.models.sparse_unet import MaskedBatchNorm, Net3DSeg, SubmConv
from mm2d3d_tpu_torch.ops.hierarchy import OFFSETS_125, OFFSETS_27
from mm2d3d_tpu_torch.ops.spconv import subm_conv3, subm_conv5
from mm2d3d_tpu_torch.run import build_task, parse_config
from mm2d3d_tpu_torch.train.batch import build_topology, flatten_points
from mm2d3d_tpu_torch.train.losses import kl_consistency, weighted_cross_entropy
from mm2d3d_tpu_torch.train.step import _init_

FS = 128
NC = 6
CONFIG = "configs/vkitti_skitti_mink34c.yaml"
# fp32 against the fp32 reference: the two sum the same products in other
# orders (per-tap index_add against one contraction over all taps), so the
# logits agree to a few ulps of fp32 compounded over 55 convolutions and 62
# BatchNorms (measured 1e-6 to 4e-6)
TOL_FP32 = 1e-5
# gradients against the reference in float64: the median leaf read
# 1.8e-6 to 6.6e-6 on six of seeds 0-7.  A ReLU whose input lies within
# fp32 round-off of 0 takes the other branch than in float64 now and then
# (about once a run at this size): that element's gradient differs by its
# whole size, and the train-form BatchNorms spread it over every leaf
# upstream (seed 2: median 9.9e-4, worst 2.4e-3; seed 3: worst 2.1e-3).
# The limits hold that with room; the program in bf16 reads a median of
# 0.24-0.40 and a worst leaf of 0.73-0.97 (seeds 0-2)
TOL_GRAD_MEDIAN = 1e-2
TOL_GRAD_WORST = 2e-2
# bf16 operands (8 bits of mantissa, 2^-9 relative rounding) into every
# convolution, with fp32 sums, against the fp32 reference: measured 1.9e-3
# to 5.9e-3 on the logits in eval mode and 2.5e-2 to 6.3e-2 in train mode
# over seeds 0-5 (the train-form BatchNorms over the 35-111 voxels of the
# deep levels carry each block's rounding into the next); 0.1 holds both,
# and the planted faults below read 0.39-0.81 (seeds 4, 5), over 3x it
TOL_BF16 = 0.1


# Level capacities for these batches: the default plan's per-scan floors
# (`train.batch.default_capacities`) give the coarse levels 2,048 rows for
# the 32-77 voxels 2 scans of 1,024 points hold there, and the CPU would
# spend most of its time on padding rows at MinkUNet34C's widths; the
# largest counts of seeds 0-10 are 502, 269, 137, 76 and 45
CAPS = (640, 384, 256, 128, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores,
    and these tests' many small products slow down by tens of times when
    each worker's threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, n_points=1024):
    return make_batch(np.random.RandomState(seed), batch_size=2, height=48, width=64,
                      n_points=n_points, num_classes=NC, full_scale=FS, variant="kitti")


def _topology(batch, stem_kernel=5):
    topo = build_topology(batch, FS, 5, capacities=CAPS, slot_profile="dense",
                          stem_kernel=stem_kernel)
    assert all(int(lv.num_voxels) < lv.capacity for lv in topo[1].levels)
    return topo


def _net(seed, dtype=torch.float32):
    """The branch with seeded weights and BatchNorms whose scales, shifts
    and running statistics are not the identity."""
    net = MinkUNet34CSeg(NC, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        _init_(net, gen)
        for m in net.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return net


def _run(net, batch, train):
    net.train(train)
    grid, hier = _topology(batch)
    _, feats, _, _, _ = flatten_points(batch)
    preds, _, aux = net(feats, grid, hier)
    return {"seg_logit": preds["seg_logit"], "seg_logit_point": aux["seg_logit_point"],
            "confidence": preds["confidence"]}


def _same_tables(a, b):
    """Two topologies of one batch at other capacities hold the same voxels
    and the same 125-neighbour hits."""
    assert [int(lv.num_voxels) for lv in a[1].levels] == \
        [int(lv.num_voxels) for lv in b[1].levels]
    la, lb = a[1].levels[0], b[1].levels[0]
    n = int(la.num_voxels)
    ha = torch.where(la.nbr5[:, :n] < la.capacity, la.nbr5[:, :n], -1)
    hb = torch.where(lb.nbr5[:, :n] < lb.capacity, lb.nbr5[:, :n], -1)
    assert torch.equal(ha, hb)


def _reference(net, batch, train, dtype=torch.float32):
    W = {k: v.detach().to(dtype).clone().requires_grad_(True)
         for k, v in net.state_dict().items()}
    _, feats, _, _, _ = flatten_points(batch)
    return W, ref.forward(W, feats.to(dtype), batch.coords, batch.point_mask, FS, train)


def _gap(a, b, mask):
    a, b = a.detach()[mask].double(), b.detach()[mask].double()
    return float((a - b).norm() / b.norm())


def _worst_gap(prog, want, mask):
    return max(_gap(prog[k], want[k], mask) for k in want)


def _xmuda_loss(out, batch):
    """Source CE on the main head plus the cross-modal KL of the auxiliary
    head to a fixed teacher, as one domain's 3D loss of the train step."""
    _, _, labels, mask, _ = flatten_points(batch)
    teacher = torch.randn(out["seg_logit"].shape, generator=torch.Generator().manual_seed(9))
    teacher = teacher.to(out["seg_logit"].dtype)
    return (weighted_cross_entropy(out["seg_logit"], labels, mask, None)
            + kl_consistency(out["seg_logit_point"], teacher, mask))


# -- the branch against the reference -------------------------------------

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_branch_matches_the_reference_fp32(train):
    net, batch = _net(1), _batch(1)
    mask = batch.point_mask.reshape(-1)
    with torch.no_grad():
        prog = _run(net, batch, train)
        _, want = _reference(net, batch, train)
    assert _worst_gap(prog, want, mask) < TOL_FP32


def test_gradients_match_the_reference():
    net, batch = _net(2), _batch(2)
    _xmuda_loss(_run(net, batch, True), batch).backward()
    W, want = _reference(net, batch, True, torch.float64)
    _xmuda_loss(want, batch).backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert set(grads) == {n for n, w in W.items() if w.grad is not None}
    norms = sorted(float(W[n].grad.norm()) for n in grads)
    floor = norms[len(norms) // 2]
    gaps = {n: float((g.double() - W[n].grad).norm()) / max(float(W[n].grad.norm()), floor)
            for n, g in grads.items()}
    worst = max(gaps, key=gaps.get)
    assert sorted(gaps.values())[len(gaps) // 2] < TOL_GRAD_MEDIAN
    assert gaps[worst] < TOL_GRAD_WORST, (worst, gaps[worst])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_branch_in_bf16_stays_within_its_tolerance(train):
    batch = _batch(3)
    mask = batch.point_mask.reshape(-1)
    net = _net(3, torch.bfloat16)
    with torch.no_grad():
        prog = _run(net, batch, train)
        _, want = _reference(net, batch, train)
    assert _worst_gap(prog, want, mask) < TOL_BF16


def _stem_as_3x3(monkeypatch):
    """Planted fault: the stem convolves the 27 middle taps of its 5^3
    weight over the 3^3 neighbourhood."""
    mid = [int(k) for k, d in enumerate(OFFSETS_125) if (np.abs(d) <= 1).all()]
    forward = SubmConv.forward

    def fault(self, x, level):
        if self.weight.shape[0] != 125:
            return forward(self, x, level)
        return subm_conv3(x, level, self.weight[mid], self.compute_dtype)

    monkeypatch.setattr(SubmConv, "forward", fault)


def _shortcut_without_bn(monkeypatch):
    """Planted fault: the 1x1 shortcut without its BatchNorm."""
    monkeypatch.setattr(Shortcut, "forward", lambda self, x, valid: self.conv(x))


@pytest.mark.parametrize("plant", [_stem_as_3x3, _shortcut_without_bn],
                         ids=["stem_3x3", "shortcut_without_bn"])
def test_planted_faults_fail_the_comparison(monkeypatch, plant):
    net, batch = _net(4), _batch(4)
    mask = batch.point_mask.reshape(-1)
    plant(monkeypatch)
    with torch.no_grad():
        prog = _run(net, batch, True)
        _, want = _reference(net, batch, True)
    assert _worst_gap(prog, want, mask) > 3 * TOL_BF16


def test_published_sizes():
    net = MinkUNet34CSeg(NC)
    assert (LAYERS, PLANES, INIT_DIM) == ((2, 3, 4, 6, 2, 2, 2, 2),
                                          (32, 64, 128, 256, 256, 128, 96, 96), 32)
    trunk = net.net_3d
    assert trunk.conv0p1s1.weight.shape == (125, 3, 32)
    assert sum(p.numel() for p in trunk.parameters()) == 37_854_112
    convs = [m for m in trunk.modules() if isinstance(m, SubmConv)]
    assert len(convs) == 1 + 2 * sum(LAYERS)
    bns = [m for m in net.modules() if isinstance(m, MaskedBatchNorm)]
    assert len(bns) == 62 and all(m.eps == 1e-5 for m in bns)
    assert [n for n, m in trunk.named_modules() if isinstance(m, Shortcut)] == [
        "block2.0.downsample", "block3.0.downsample", "block4.0.downsample",
        "block5.0.downsample", "block6.0.downsample", "block7.0.downsample",
        "block8.0.downsample"]
    assert (net.num_levels, net.stem_kernel) == (5, 5)
    assert net.linear.weight.shape == net.aux_linear_point.weight.shape == (NC, 96)


# -- the 125-neighbour table and the stem ---------------------------------

def _edge_batch():
    """Two scans with the same voxels (no neighbour crosses a scan): a
    dense 6^3 block in the far corner of the grid, points on the other
    faces and corners, random points in a 12^3 box at the origin, and
    invalid and out-of-grid points."""
    rng = np.random.RandomState(5)
    n = 600
    pts = [[0, 0, 0], [FS - 1, 0, 0], [0, FS - 1, 0], [FS - 2, 1, FS - 1], [1, 0, 2]]
    pts += [list(p) for p in itertools.product(range(FS - 6, FS), repeat=3)]
    pts += rng.randint(0, 12, size=(n - len(pts), 3)).tolist()
    coords = np.array(pts, np.int32)
    coords[-3] = [-1, 5, 5]
    coords[-2] = [5, FS, 5]
    b = _batch(5, n_points=n)
    b.coords = torch.as_tensor(np.stack([coords, coords]))
    mask = np.ones((2, n), bool)
    mask[1, -1] = False
    b.point_mask = torch.as_tensor(mask)
    b.coords_sorted = False
    return b


def test_nbr5_equals_a_brute_force_search():
    batch = _edge_batch()
    _, hier = build_topology(batch, FS, 5, slot_profile="dense", stem_kernel=5)
    assert all(int(lv.num_voxels) < lv.capacity for lv in hier.levels)
    lv = hier.levels[0]
    v = lv.capacity
    valid = lv.valid.numpy()
    coords, scans = lv.coords.numpy(), lv.batch.numpy()
    row_of = {(int(s), *map(int, c)): r
              for r, (s, c) in enumerate(zip(scans, coords)) if valid[r]}
    want = np.full((125, v), v, np.int32)
    for r in np.nonzero(valid)[0]:
        for k, d in enumerate(OFFSETS_125):
            want[k, r] = row_of.get((int(scans[r]), *map(int, coords[r] + d)), v)
    np.testing.assert_array_equal(lv.nbr5.numpy(), want)
    assert valid.sum() > 300 and (want < v).sum() > 4 * valid.sum()
    # the 27 middle taps are the 27-neighbour table
    mid = [int(k) for k, d in enumerate(OFFSETS_125) if (np.abs(d) <= 1).all()]
    np.testing.assert_array_equal(OFFSETS_125[mid], OFFSETS_27)
    np.testing.assert_array_equal(lv.nbr5[mid].numpy(), lv.nbr.numpy())


def test_stem_gradients_match_autograd_on_the_reference():
    batch = _batch(6)
    grid, hier = _topology(batch)
    lv = hier.levels[0]
    gen = torch.Generator().manual_seed(6)
    n = int(lv.num_voxels)
    x = torch.randn(lv.capacity, 3, generator=gen).requires_grad_(True)
    w = torch.randn(125, 3, 32, generator=gen).requires_grad_(True)
    g = torch.randn(lv.capacity, 32, generator=gen)
    (subm_conv5(x, lv, w, torch.float32) * g)[:n].sum().backward()
    xr, wr = x.detach()[:n].clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    c = lv.coords[:n].long()
    keys = ((lv.batch[:n].long() * FS + c[:, 0]) * FS + c[:, 1]) * FS + c[:, 2]
    order = keys.argsort()  # the reference searches keys in ascending order
    pairs = [(order[o], order[i]) for o, i in ref.neighbour_pairs(keys[order], FS, 5)]
    (ref.subm_conv(xr, pairs, wr) * g[:n]).sum().backward()
    for got, want in ((x.grad[:n], xr.grad), (w.grad, wr.grad)):
        assert float((got - want).norm() / want.norm()) < 1e-6
    assert float(x.grad[n:].abs().max()) == 0.0


def test_a_level_without_the_table_refuses_the_stem():
    _, hier = _topology(_batch(7), stem_kernel=3)
    assert hier.levels[0].nbr5 is None
    with pytest.raises(ValueError, match="stem_kernel=5"):
        subm_conv5(torch.zeros(hier.levels[0].capacity, 3), hier.levels[0],
                   torch.zeros(125, 3, 32))


# -- the config through the task ------------------------------------------

def _small_config(path=CONFIG, *extra):
    return parse_config(path, ["models.net3d.backbone_3d.full_scale=128", *extra])


def test_the_config_runs_a_train_and_an_eval_step_on_the_cpu():
    cfg = _small_config()
    task = build_task(cfg, NC, device="cpu")
    assert isinstance(task.model3d, MinkUNet34CSeg)
    assert (task.num_planes, task.stem_kernel, task.slot_profile) == (5, 5, "dense")
    task.init_params(torch.Generator().manual_seed(8))
    src, trg = _batch(8), _batch(9)
    topo = task.build_topology(src)
    assert len(topo[1].levels) == 5 and topo[1].levels[0].nbr5.shape[0] == 125
    # the step on the same tables at `CAPS` rows (the task's own plan pads
    # the coarse levels to 2,048)
    small = {k: _topology(b) for k, b in (("src", src), ("trg", trg))}
    _same_tables(topo, small["src"])
    before = task.model3d.net_3d.conv0p1s1.weight.detach().clone()
    logs = task.train_step(src, trg, torch.Generator().manual_seed(0), small["src"],
                           small["trg"])
    assert all(math.isfinite(float(v)) for v in logs.values())
    assert float(logs["train/nbr_slot_overflow"]) == 0
    assert not torch.equal(before, task.model3d.net_3d.conv0p1s1.weight)
    _, elogs = task.eval_step(trg, topo=small["trg"])
    assert math.isfinite(float(elogs["loss_segmentation_3d"]))


def test_build_task_checks_the_levels_against_the_network():
    with pytest.raises(ValueError, match="num_planes is 7"):
        build_task(_small_config(CONFIG, "models.net3d.backbone_3d.num_planes=7"), NC,
                   device="cpu")


def test_host_topology_refuses_the_5x5x5_stem(tmp_path):
    from mm2d3d_tpu_torch.train.trainer import Trainer

    task = build_task(_small_config(), NC, device="cpu")
    with pytest.raises(ValueError, match="train.host_topology"):
        Trainer(task, None, None, ckpt_dir=str(tmp_path), host_topology=True)


# -- the SCN path as it was ------------------------------------------------

# sha256 over (name, bytes) of `Net3DSeg(6)`'s state after `_init_` with
# seed 7, as before the branch was factored into `GatedTrunk`
NET3D_SHA = {False: "9cc3cc153e211e5f93b5d540e637fa42aaa0ea4bbfc2e17139809cc13435ebe1",
             True: "0aa9f0867af5ad53954f8625e3ec250b7c3f1df96ef7278220b5835755c45992"}


@pytest.mark.parametrize("residual", [False, True], ids=["vgg", "residual"])
def test_net3d_keeps_its_state_dict_and_weights(residual):
    net = Net3DSeg(NC, residual_blocks=residual)
    with torch.no_grad():
        _init_(net, torch.Generator().manual_seed(7))
    h = hashlib.sha256()
    for k, v in net.state_dict().items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == NET3D_SHA[residual]
    assert (net.num_levels, net.stem_kernel) == (7, 3)


@pytest.mark.parametrize("config", ["configs/vkitti_skitti.yaml", "configs/config.yaml"])
def test_net3d_configs_build_no_125_tap_table(config):
    task = build_task(_small_config(config), NC, device="cpu")
    assert isinstance(task.model3d, Net3DSeg) and task.stem_kernel == 3
    assert task.num_planes == 7
    _, hier = task.build_topology(_batch(10))
    assert len(hier.levels) == 7 and all(lv.nbr5 is None for lv in hier.levels)
