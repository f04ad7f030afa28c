"""The `minkunet34c` reference (`reference/arch3d/minkunet34c.py`) and the
cell `vkitti_skitti_mink34c.train`: the template against the program's
`state_dict`, the fp32 forward and three train steps against the fp32
program, the work count (125 taps at the stem), the cell's entries, and the
`topology/nbr5` reader.  CPU, 2 scans of 1,024 points on a 128^3 grid."""

import copy

import pytest
import torch

from conftest import tiny_spec
from core import check, manifest, work
from core.cell import Run, seeded_weights, templates
from reference import arch3d
from reference.arch3d import minkunet34c
from reference.quant import fp32
from reference.voxels import voxelize
from traffic import generator as G

CELL = "vkitti_skitti_mink34c.train"


def small_spec(man, cell=CELL):
    """`tiny_spec` on a 128^3 grid at 1,024 points a scan: MinkUNet34C's
    widths at 8,192 points a scan cost the CPU minutes a step."""
    spec = tiny_spec(man, cell)
    spec["config"]["data"].update(n_points=1024, full_scale=128)
    spec["config"]["models"]["net3d"]["backbone_3d"]["full_scale"] = 128
    return spec


def test_the_cell_loads_through_the_manifest(manifest_data):
    spec = manifest.cell_spec(manifest_data, CELL)
    assert spec["cell"]["chips"] == 1 and spec["cell"]["traffic"] == "train_b16"
    assert spec["mix"]["kind"] == "train" and spec["limits"]
    assert spec["config"]["models"]["net3d"]["name"] == "minkunet34c"
    assert arch3d.lookup(spec["config"]) is minkunet34c
    assert "minkunet34c" in arch3d.known()
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    want = {m["name"] for m in manifest_data["per_layer"] if m["name"].endswith(".train")}
    assert want <= names and "topology_nbr5_host_ms.train" in names
    assert {"setup_s", "train_scans_per_s", "peak_mem_gib"} <= names
    conf = {c["name"]: c for c in manifest_data["configs"]}["vkitti_skitti_mink34c"]
    assert conf["reduced"] == []
    # the KITTI job's keys, the 3D network aside
    kitti = manifest.cell_spec(manifest_data, "vkitti_skitti.train")["config"]
    for key in ("num_classes", "data", "run", "losses", "train"):
        assert spec["config"][key] == kitti[key], key
    assert spec["config"]["models"]["net2d"] == kitti["models"]["net2d"]


def test_template_is_the_programs_state_dict(manifest_data):
    from mm2d3d_tpu_torch.run import build_task

    config = small_spec(manifest_data)["config"]
    task = build_task(config, config["num_classes"], device="cpu")
    state = {k: tuple(v.shape) for k, v in task.model3d.state_dict().items()}
    assert state == templates(config)["3d"]
    assert state["net_3d.conv0p1s1.weight"] == (125, 3, 32)


def test_shortcuts_are_drawn_over_their_fan_in(manifest_data):
    W = seeded_weights(small_spec(manifest_data)["config"], 5, "cpu")["3d"]
    w = W["net_3d.block5.0.downsample.conv.weight"]  # (384, 256)
    assert w.shape == (384, 256)
    assert abs(w.std().item() - (1 / 384) ** 0.5) < 0.1 * (1 / 384) ** 0.5


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_the_fp32_program(manifest_data, train):
    from core import program
    from mm2d3d_tpu_torch.train.batch import flatten_points, prepare_device_batch

    spec = small_spec(manifest_data)
    config = spec["config"]
    weights = seeded_weights(config, 11, "cpu")
    task = program.build_task(config, weights, "cpu")
    batch = G.make_pool(config, spec["mix"], 11)[0][0]
    pb = prepare_device_batch(program.point_batch(batch, "cpu"))
    task.model3d.train(train)
    with torch.no_grad():
        preds, _, aux = task.model3d(flatten_points(pb)[1], *task.build_topology(pb))
    feats = pb.feats.reshape(-1, 3)
    vox = voxelize(pb.coords, pb.point_mask, 128, 5)
    want = minkunet34c.forward(weights["3d"], feats, vox, config, train, fp32)
    valid = pb.point_mask.reshape(-1)
    for got, key in ((preds["seg_logit"], "seg_logit"),
                     (aux["seg_logit_point"], "seg_logit_point")):
        gap = (got[valid] - want[key][valid]).norm() / want[key][valid].norm()
        assert float(gap) < 1e-5, key


def test_train_steps_match_the_fp32_program_and_read_the_nbr5_span(manifest_data):
    """The first step's loss agrees to round-off; later ones drift apart:
    at this size (35 voxels at level 4) the RGB gate's gradient is mostly
    round-off (its worst leaf), Adam turns that into a full step of the
    gate, which moves every point's features, so the third loss read
    0.9e-3 and 2.6e-3 apart (seeds 21, 22) and the worst leaf's change
    0.036 and 0.045; the first gradients' median leaf 1e-6 to 8e-6."""
    run = Run(small_spec(manifest_data), 21, "cpu")
    run.setup()
    run.window(0.01)
    run.release()
    ref = run.reference_record()
    n = check.train_numbers({**run.prog, "overflow": 0.0}, ref)
    assert run.prog["overflow"] == 0
    assert abs(run.prog["losses"][0] - ref["losses"][0]) < 1e-5 * ref["losses"][0]
    assert n["loss_gap"] < 1e-2
    assert n["grad_gap"] < 1e-4
    assert n["change_gap"] < 0.1
    read = manifest.reader("topology_nbr5_host_ms.train")
    assert read(run.rec) > 0


def test_the_nbr5_reader_reads_nothing_where_no_table_is_built(manifest_data):
    run = Run(tiny_spec(manifest_data, "vkitti_skitti.train"), 3, "cpu")
    run.setup()
    run.window(0.01)
    assert run.rec["calls"] >= 1
    assert manifest.reader("topology_nbr5_host_ms.train")(run.rec) is None


def test_convs_count_125_taps_at_the_stem(manifest_data):
    spec = small_spec(manifest_data)
    config = spec["config"]
    batch = G.make_pool(config, spec["mix"], 12)[0][0]
    mask = torch.as_tensor(batch["point_mask"])
    vox = voxelize(torch.as_tensor(batch["coords"]), mask, 128, 5)
    convs = minkunet34c.convs(vox, config)
    assert len(convs) == 55
    pairs, v_in, v_out, ci, co, taps = convs[0]
    v0 = vox.levels[0].num_voxels
    assert (v_in, v_out, ci, co, taps) == (v0, v0, 3, 32, 125)
    # every pair within 2 of each other in each axis, scan by scan
    want = 0
    keys = vox.levels[0].keys.tolist()
    have = set(keys)
    fs = 128
    for k in keys:
        s, rem = divmod(k, fs ** 3)
        x, rem = divmod(rem, fs * fs)
        y, z = divmod(rem, fs)
        for dx in range(-2, 3):
            for dy in range(-2, 3):
                for dz in range(-2, 3):
                    q = (x + dx, y + dy, z + dz)
                    if all(0 <= c < fs for c in q):
                        want += (((s * fs + q[0]) * fs + q[1]) * fs + q[2]) in have
    assert pairs == want
    assert sum(c[5] == 27 for c in convs) == 46 and sum(c[5] == 8 for c in convs) == 8
    assert max(c[3] for c in convs) == 384 and max(c[4] for c in convs) == 256
    flops = work.spconv_flops(convs)
    assert flops > work.spconv_flops(convs[1:]) > 0
    points = int(mask.sum())
    shortcuts = minkunet34c.dense_flops(vox, points, config) - (
        2 * points * 3 + 2 * 2 * points * 96 * config["num_classes"])
    assert shortcuts == sum(2 * vox.levels[l].num_voxels * ci * co for l, ci, co in (
        (2, 32, 64), (3, 64, 128), (4, 128, 256), (3, 384, 256), (2, 192, 128),
        (1, 128, 96), (0, 128, 96)))


def test_the_parent_program_fails_the_cell_at_set_up(manifest_data, monkeypatch):
    """A program without `minkunet34c` refuses the configuration when the
    task is built, before any step (the parent commit's behaviour)."""
    from mm2d3d_tpu_torch.models import registry

    monkeypatch.setattr(registry, "_REGISTRY", {k: v for k, v in registry._REGISTRY.items()
                                                if k != "minkunet34c"})
    spec = copy.deepcopy(small_spec(manifest_data))
    with pytest.raises(ModuleNotFoundError, match="minkunet34c"):
        Run(spec, 1, "cpu").setup()
