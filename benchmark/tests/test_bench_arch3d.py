"""The 3D network found by `models.net3d.name`: the lookup, the residual
form of `net3d` against the program, and a toy network added by files
alone; the `net3d` module against a frozen copy of the harness's functions
from before the lookup (weights, reference records and work counts
bit-identical).  All on the CPU at `tiny_spec` size."""

import copy
import importlib
import math
import os
import sys

import pytest
import torch
from torch import nn

from conftest import tiny_spec
from core import program, work
from core.cell import Run, seeded_weights, templates
from reference import arch3d, nets
from reference.nets import Q, down_conv, subm_conv, up_conv
from reference.task import Reference
from reference.voxels import voxelize
from traffic import generator as G

CELLS = ["nusc_usa_sing.train", "vkitti_skitti.train", "nusc_usa_sing.eval"]
SEEDS = [3, 2147483659]
TOY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy_arch3d")


# -- the parent's functions, frozen ---------------------------------------

def _bn_names(prefix, c):
    return {f"{prefix}.{k}": (c,) for k in
            ("weight", "bias", "running_mean", "running_var")}


def frozen_template3d(num_classes, m, num_planes, reps, in_channels):
    planes = [(i + 1) * m for i in range(num_planes)]
    t = {"linear_rgb_mask.weight": (1, in_channels), "linear_rgb_mask.bias": (1,),
         "net_3d.input_conv.weight": (27, in_channels, m)}
    u = "net_3d.unet"
    for l in range(num_planes):
        if l > 0:
            t.update(_bn_names(f"{u}.down_bn_{l}", planes[l - 1]))
            t[f"{u}.down_{l}.weight"] = (8, planes[l - 1], planes[l])
        for r in range(reps):
            t.update(_bn_names(f"{u}.enc_{l}_{r}.bn", planes[l]))
            t[f"{u}.enc_{l}_{r}.conv.weight"] = (27, planes[l], planes[l])
    for l in range(num_planes - 2, -1, -1):
        t.update(_bn_names(f"{u}.up_bn_{l}", planes[l + 1]))
        t[f"{u}.up_{l}.weight"] = (8, planes[l + 1], planes[l])
        for r in range(reps):
            cin = 2 * planes[l] if r == 0 else planes[l]
            t.update(_bn_names(f"{u}.dec_{l}_{r}.bn", cin))
            t[f"{u}.dec_{l}_{r}.conv.weight"] = (27, cin, planes[l])
    t.update(_bn_names("net_3d.out_bn", m))
    for head in ("linear", "aux_linear_point"):
        t[f"{head}.weight"] = (num_classes, m)
        t[f"{head}.bias"] = (num_classes,)
    return t


def _frozen_bn3d(x, W, name, train):
    if train:
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
    else:
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    return (x - mean) * torch.rsqrt(var + 1e-4) * W[f"{name}.weight"] + W[f"{name}.bias"]


def frozen_net3d(W, feats, vox, num_planes, reps, train, q: Q):
    gate = torch.sigmoid(feats @ W["linear_rgb_mask.weight"].T + W["linear_rgb_mask.bias"])
    gated = feats * gate
    ok = vox.point_voxel >= 0
    v0 = vox.levels[0].num_voxels
    pooled = gated.new_zeros(v0, gated.shape[1]).index_add(
        0, vox.point_voxel[ok], gated[ok]) / vox.counts.clamp(min=1)[:, None].to(gated.dtype)
    u = "net_3d.unet"
    x = subm_conv(pooled, vox.levels[0], W["net_3d.input_conv.weight"], q)
    enc = []
    for l in range(num_planes):
        if l > 0:
            y = torch.relu(_frozen_bn3d(x, W, f"{u}.down_bn_{l}", train))
            x = down_conv(y, vox.transitions[l - 1], vox.levels[l].num_voxels,
                          W[f"{u}.down_{l}.weight"], q)
        for r in range(reps):
            x = subm_conv(torch.relu(_frozen_bn3d(x, W, f"{u}.enc_{l}_{r}.bn", train)),
                          vox.levels[l], W[f"{u}.enc_{l}_{r}.conv.weight"], q)
        enc.append(x)
    for l in range(num_planes - 2, -1, -1):
        y = torch.relu(_frozen_bn3d(x, W, f"{u}.up_bn_{l}", train))
        x = torch.cat([enc[l], up_conv(y, vox.transitions[l], W[f"{u}.up_{l}.weight"], q)], 1)
        for r in range(reps):
            x = subm_conv(torch.relu(_frozen_bn3d(x, W, f"{u}.dec_{l}_{r}.bn", train)),
                          vox.levels[l], W[f"{u}.dec_{l}_{r}.conv.weight"], q)
    x = torch.relu(_frozen_bn3d(x, W, "net_3d.out_bn", train))
    padded = torch.cat([x, x.new_zeros(1, x.shape[1])])
    point_out = padded[torch.where(ok, vox.point_voxel, v0)]
    return {key: point_out @ W[f"{head}.weight"].T + W[f"{head}.bias"]
            for key, head in (("seg_logit", "linear"),
                              ("seg_logit_point", "aux_linear_point"))}


def frozen_spconvs(level_voxels, level_pairs, m, reps, in_channels):
    n = len(level_voxels)
    planes = [(i + 1) * m for i in range(n)]
    v, p = level_voxels, level_pairs
    convs = [(p[0], v[0], v[0], in_channels, m, 27)]
    for l in range(n):
        if l > 0:
            convs.append((v[l - 1], v[l - 1], v[l], planes[l - 1], planes[l], 8))
        convs += [(p[l], v[l], v[l], planes[l], planes[l], 27)] * reps
    for l in range(n - 2, -1, -1):
        convs.append((v[l], v[l + 1], v[l], planes[l + 1], planes[l], 8))
        convs.append((p[l], v[l], v[l], 2 * planes[l], planes[l], 27))
        convs += [(p[l], v[l], v[l], planes[l], planes[l], 27)] * (reps - 1)
    return convs


def frozen_init_std(name, shape):
    if name.endswith(("running_mean", "running_var", "bias")) or len(shape) == 1:
        return None
    if len(shape) == 3:
        return math.sqrt(2.0 / (shape[0] * shape[1]))
    if len(shape) == 4:
        fan_in = (shape[0] if ".tconv." in name else shape[1]) * shape[2] * shape[3]
        return math.sqrt(1.0 / fan_in)
    return math.sqrt(1.0 / shape[1])


def frozen_make_weights(templates, seed, device):
    names = [(br, n) for br in sorted(templates) for n in sorted(templates[br])]
    drawn = [(br, n) for br, n in names if frozen_init_std(n, templates[br][n]) is not None]
    total = sum(math.prod(templates[br][n]) for br, n in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out = {br: {} for br in templates}
    at = 0
    for br, n in names:
        shape = templates[br][n]
        std = frozen_init_std(n, shape)
        if std is not None:
            size = math.prod(shape)
            out[br][n] = pool[at:at + size].view(shape) * std
            at += size
        elif n.endswith("running_var") or (len(shape) == 1 and n.endswith("weight")):
            out[br][n] = torch.ones(shape, device=device)
        else:
            out[br][n] = torch.zeros(shape, device=device)
    return out


def _b3(config):
    b3 = config["models"]["net3d"]["backbone_3d"]
    return b3["m"], b3["num_planes"], b3.get("block_reps", 1), b3.get("in_channels", 3)


def frozen_templates(config):
    m, n, reps, cin = _b3(config)
    nc = config["num_classes"]
    return {"2d": nets.template2d(nc), "3d": frozen_template3d(nc, m, n, reps, cin)}


class FrozenReference(Reference):
    def forward(self, b, train, gen=None):
        p2 = nets.net2d(self.W["2d"], b["img"], b["depth"], b["img_indices"],
                        b["point_mask"], train, gen, self.q)
        _, n, reps, _ = _b3(self.config)
        p3 = frozen_net3d(self.W["3d"], b["feats"], self.voxels(b), n, reps, train, self.q)
        return ({k: v.reshape(-1, self.nc) for k, v in p2.items()}, p3)


def frozen_record(run):
    W = frozen_make_weights(frozen_templates(run.config), G.derive(run.seed, G.WEIGHTS),
                            "cpu")
    ref = FrozenReference(run.config, W, "cpu")
    if run.kind == "train":
        gen = torch.Generator().manual_seed(G.derive(run.seed, G.DROPOUT))
        pairs = [run.pool_np[s % len(run.pool_np)] for s in range(run.mix["warm_steps"])]
        return ref.train_steps(pairs, gen)
    return [ref.eval_batch(b) for b in run.pool_np]


def frozen_work_of_pool(run):
    geo = G.scan_geometry(run.config, run.mix)
    b3 = run.config["models"]["net3d"]["backbone_3d"]
    m, _, reps, cin = _b3(run.config)
    nc = run.config["num_classes"]
    train = run.kind == "train"

    def one(batch):
        mask = torch.as_tensor(batch["point_mask"])
        vox = voxelize(torch.as_tensor(batch["coords"]), mask, b3["full_scale"],
                       b3["num_planes"])
        convs = frozen_spconvs([lv.num_voxels for lv in vox.levels],
                               [lv.num_pairs() for lv in vox.levels], m, reps, cin)
        points = int(mask.sum())
        net3d = (work.spconv_flops(convs) + 2 * points * cin + 2 * 2 * points * m * nc)
        return {"flops": (run.mix["batch_size"] * work.net2d_flops(geo["height"],
                                                                   geo["width"], nc)
                          + net3d),
                "spconv_least_s": work.spconv_least_s(convs, train)}

    out = []
    for item in run.pool_np:
        parts = [one(b) for b in (item if train else (item,))]
        out.append({k: sum(p[k] for p in parts) for k in parts[0]})
    return out


def _same(a, b):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


# -- identity: what every existing cell reads stays the same ---------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_template_and_weights_are_the_parents(manifest_data, cell, seed):
    config = tiny_spec(manifest_data, cell)["config"]
    assert templates(config) == frozen_templates(config)
    _same(seeded_weights(config, seed, "cpu"),
          frozen_make_weights(frozen_templates(config), G.derive(seed, G.WEIGHTS), "cpu"))


@pytest.fixture
def deterministic():
    """The CPU's scatter-adds in the backward sum in a varying order across
    threads; two runs of one reference agree bit for bit only with
    PyTorch's deterministic algorithms."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_reference_records_and_work_are_the_parents(manifest_data, cell, seed,
                                                    deterministic):
    run = Run(tiny_spec(manifest_data, cell), seed, "cpu")
    run.make_pool()
    _same(run.reference_record(), frozen_record(run))
    _same(run.work_of_pool(), frozen_work_of_pool(run))


# -- the residual form of net3d --------------------------------------------

def _residual(spec):
    spec = copy.deepcopy(spec)
    spec["config"]["models"]["net3d"]["backbone_3d"]["residual_blocks"] = True
    return spec


@pytest.mark.parametrize("cell", ["nusc_usa_sing.train", "vkitti_skitti.train"])
def test_residual_template_is_the_programs_state_dict(manifest_data, cell):
    from mm2d3d_tpu_torch.run import build_task

    config = _residual(tiny_spec(manifest_data, cell))["config"]
    task = build_task(config, config["num_classes"], device="cpu")
    state = {k: tuple(v.shape) for k, v in task.model3d.state_dict().items()}
    assert state == templates(config)["3d"]
    assert any(k.endswith(".nin_kernel") for k in state)


def test_residual_shortcut_is_drawn_over_its_fan_in(manifest_data):
    config = _residual(tiny_spec(manifest_data, "nusc_usa_sing.train"))["config"]
    W = seeded_weights(config, 5, "cpu")["3d"]
    nin = W["net_3d.unet.dec_0_0.nin_kernel"]  # (32, 16)
    assert nin.shape == (32, 16)
    assert abs(nin.std().item() - math.sqrt(1 / 32)) < 0.25 * math.sqrt(1 / 32)


@pytest.mark.parametrize("cell", ["nusc_usa_sing.train", "vkitti_skitti.train"])
def test_residual_train_steps_match_the_fp32_program(manifest_data, cell):
    run = Run(_residual(tiny_spec(manifest_data, cell)), 23, "cpu")
    run.setup()
    run.window(0.01)
    run.release()
    n = run.compare()
    assert n["overflow"] == 0
    assert n["loss_gap"] < 1e-4
    assert n["grad_gap"] < 5e-3
    assert n["change_gap"] < 0.05


def test_residual_eval_matches_the_fp32_program(manifest_data):
    run = Run(_residual(tiny_spec(manifest_data, "nusc_usa_sing.eval")), 24, "cpu")
    run.setup()
    run.window(15.0)  # long enough for every sampled call, under load too
    run.release()
    n = run.compare()
    assert len(run.prog["logits"]) == 3
    assert n["cm_gap"] == 0 and n["overflow"] == 0
    assert max(n["logit_gap_2d"], n["logit_gap_3d"], n["loss_gap"]) < 1e-5


# -- the lookup ------------------------------------------------------------

@pytest.fixture
def extra_arch3d(monkeypatch):
    """Puts a directory on `reference.arch3d`'s path, as if its files had
    been added there; forgets what was imported from it afterwards."""
    before = set(sys.modules)

    def add(path):
        monkeypatch.setattr(arch3d, "__path__", [*arch3d.__path__, str(path)])
        importlib.invalidate_caches()

    yield add
    for name in set(sys.modules) - before:
        if name.startswith(arch3d.__name__ + "."):
            del sys.modules[name]


def test_an_unknown_3d_network_fails_at_setup_with_the_known_names(manifest_data):
    spec = tiny_spec(manifest_data, "nusc_usa_sing.eval")
    for name in ("no_such_net", "pkg.no_such_net", "../net3d"):
        spec["config"]["models"]["net3d"]["name"] = name
        with pytest.raises(ValueError, match=r"known: .*\bnet3d\b"):
            Run(spec, 1, "cpu").setup()


def test_a_dotted_plugin_path_is_found_by_its_file_name(tmp_path, extra_arch3d):
    (tmp_path / "my__nets__unet.py").write_text("MARK = 7\n")
    extra_arch3d(tmp_path)
    config = {"models": {"net3d": {"name": "my.nets.unet"}}}
    assert arch3d.lookup(config).MARK == 7
    assert "my.nets.unet" in arch3d.known()


class Toy3D(nn.Module):
    """The program's side of the toy network: gate and pool, one SubmConv,
    BatchNorm and ReLU, unpool, both heads."""

    def __init__(self, num_classes, in_channels=3, m=16,
                 compute_dtype=torch.bfloat16):
        from mm2d3d_tpu_torch.models.sparse_unet import MaskedBatchNorm, SubmConv

        super().__init__()
        self.linear_rgb_mask = nn.Linear(in_channels, 1)
        self.conv = SubmConv(in_channels, m, compute_dtype)
        self.bn = MaskedBatchNorm(m)
        self.linear = nn.Linear(m, num_classes)
        self.aux_linear_point = nn.Linear(m, num_classes)

    def forward(self, point_feats, grid, hier):
        from mm2d3d_tpu_torch.ops.voxelize import pool_features, unpool_features

        gate = torch.sigmoid(self.linear_rgb_mask(point_feats.float()))
        x = self.conv(pool_features(grid, point_feats * gate), hier.levels[0])
        point_out = unpool_features(grid, torch.relu(self.bn(x, hier.levels[0].valid)))
        return ({"seg_logit": self.linear(point_out), "confidence": gate}, point_out,
                {"feats": point_out, "seg_logit_point": self.aux_linear_point(point_out)})


def test_a_toy_network_added_by_files_runs_an_eval_cell(manifest_data, monkeypatch,
                                                        extra_arch3d):
    from mm2d3d_tpu_torch.models import registry

    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    registry.register_model("toy3d", dependencies=["torch"])(Toy3D)
    extra_arch3d(TOY_DIR)
    spec = tiny_spec(manifest_data, "nusc_usa_sing.eval")
    spec["config"]["models"]["net3d"]["name"] = "toy3d"
    run = Run(spec, 25, "cpu")
    run.setup()
    assert isinstance(run.task.model3d, Toy3D)
    assert program.spconv_modules(run.task, run.net3d.SPCONV_MODULES) == [run.task.model3d.conv]
    run.window(0.5)
    run.traced(2)
    run.release()
    n = run.compare()
    assert n["cm_gap"] == 0 and n["overflow"] == 0
    assert max(n["logit_gap_2d"], n["logit_gap_3d"], n["loss_gap"]) < 1e-5
    geo = G.scan_geometry(spec["config"], spec["mix"])
    net2d = spec["mix"]["batch_size"] * work.net2d_flops(geo["height"], geo["width"], 6)
    assert all(w["flops"] > net2d and w["spconv_least_s"] > 0 for w in run.work_of_pool())
