"""The pseudo-label generator of mm2d3d_tpu_torch against the JAX package's,
on the CPU, over the tiny fake-nuScenes workspace of
tests/test_torch_trainer.py (m=8, 3 planes, full_scale 256, fp32).

- A seeded JAX state (random running statistics) is written with the JAX
  `CheckpointIO`, read back, carried across with `models.convert.from_flax`
  and saved with the port's `CheckpointIO`; then both generators write the
  target-train split's records: the same schema, lengths and dropped
  points, labels equal wherever the top-two margin exceeds 1e-4, probs
  within 1e-5.
- The port's and the JAX dataset attach the same refined labels from the
  port's file, and the port's CLI trains on it.
- Dropped conv hits warn, and raise with `strict`.
"""

import copy
import os.path as osp
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_port import randomize_stats, to_numpy_tree
from _torch_port import two_threads  # noqa: F401  (fixture)
from test_torch_trainer import write_workspace

from mm2d3d_tpu_torch.data.nuscenes import NuScenesLidarSeg
from mm2d3d_tpu_torch.run import build_task, parse_config
from mm2d3d_tpu_torch.tools import generate_pseudo_labels as gen
from mm2d3d_tpu_torch.train.trainer import CheckpointIO

pytestmark = pytest.mark.usefixtures("two_threads")

KEYS = ("2d", "3d", "ensemble")
MARGIN, PROB_TOL = 1e-4, 1e-5


def _jax_config(path, overrides):
    from mm2d3d_tpu.utils.config import _deep_merge, load_config

    cfg = load_config(path, overrides)
    if "train_overrides" in cfg:
        cfg["train"] = _deep_merge(cfg["train"], cfg.pop("train_overrides"))
    return cfg


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    path = tmp_path_factory.mktemp("pselab")
    write_workspace(path)
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _margins(cfg):
    """Per scan of the target-train split: the three softmaxes' top-two gaps
    in scan order (`generate_pseudo_labels.margins`), from the task the
    generator restores."""
    dataset, dm = gen.target_train_dataset(cfg)
    task = gen.restore_task(copy.deepcopy(cfg), dm, "last", "cpu")
    return [gen.margins(task, dataset, i) for i in range(len(dataset))]


@pytest.fixture(scope="module")
def generated(ws):
    """Both packages' records from one seeded state."""
    import mm2d3d_tpu.data.augment as augment_jax
    from mm2d3d_tpu.data.base import collate as collate_j
    from mm2d3d_tpu.run import build_datamodule as build_datamodule_j
    from mm2d3d_tpu.run import build_task as build_task_j
    from mm2d3d_tpu.tools.generate_pseudo_labels import generate as generate_j
    from mm2d3d_tpu.train.trainer import CheckpointIO as CheckpointIOJ

    config = str(ws / "configs" / "config.yaml")
    out_j, out_p = ws / "runs" / "jax", ws / "runs" / "port"
    cfg_j = _jax_config(config, [f"train.out_dir={out_j}"])
    cfg_p = parse_config(config, [f"train.out_dir={out_p}"])
    with pytest.MonkeyPatch.context() as mp:
        # the numpy image ops, which the port copies (test_torch_data.py)
        mp.setattr(augment_jax, "_USE_NATIVE", False)
        dm_j = build_datamodule_j(cfg_j)
        task_j = build_task_j(cfg_j, dm_j.num_classes)
        example = jax.tree_util.tree_map(jax.numpy.asarray, collate_j(
            [dm_j.source_train.dataset[0]], 256, full_scale=task_j.full_scale))
        state = task_j.init_state(jax.random.PRNGKey(5), example)
        state = state.replace(stats2d=randomize_stats(state.stats2d, 1),
                              stats3d=randomize_stats(state.stats3d, 2))
        ckpt_j = CheckpointIOJ(str(out_j / "ckpts"))
        ckpt_j.save("last", state, {"epoch": 0})
        template = task_j.init_state(jax.random.PRNGKey(0), example)
        restored, _ = ckpt_j.restore("last", template)

        task = build_task(cfg_p, dm_j.num_classes, device="cpu")
        task.load_flax(*(to_numpy_tree(t) for t in (
            restored.params2d, restored.stats2d, restored.params3d, restored.stats3d)))
        CheckpointIO(str(out_p / "ckpts")).save("last", task, torch.Generator(),
                                                {"epoch": 0})

        rec_j = generate_j(cfg_j, "last", str(out_j / "pselab.npy"))
    rec_p = gen.generate(cfg_p, "last", str(out_p / "pselab.npy"), device="cpu")
    return dict(jax=rec_j, port=rec_p, cfg=cfg_p, file=str(out_p / "pselab.npy"),
                margins=_margins(cfg_p))


def test_records_match_jax(generated, ws):
    import pickle

    rec_j, rec_p = generated["jax"], generated["port"]
    with open(ws / "data" / "preprocess" / "train_singapore.pkl", "rb") as f:
        scans = pickle.load(f)
    assert len(rec_p) == len(rec_j) == len(scans)
    saved = list(np.load(generated["file"], allow_pickle=True))
    n_cmp = 0
    for i, (p, j, scan, margins) in enumerate(zip(rec_p, rec_j, scans,
                                                  generated["margins"])):
        assert sorted(p) == sorted(j) == sorted(saved[i])
        for key in KEYS:
            probs, labels = p[f"probs_{key}"], p[f"pseudo_label_{key}"]
            assert probs.dtype == np.float32 and labels.dtype == np.int64
            assert len(probs) == len(labels) == len(scan["points"])
            # the points the dataset drops: prob 0, label 0 on both sides
            dropped = j[f"probs_{key}"] == 0
            assert np.array_equal(probs == 0, dropped), (i, key)
            assert not labels[dropped].any()
            np.testing.assert_allclose(probs, j[f"probs_{key}"], rtol=0,
                                       atol=PROB_TOL, err_msg=f"{i} {key}")
            clear = margins[key] > MARGIN
            assert clear.sum() > 0.9 * (~dropped).sum(), (i, key)
            np.testing.assert_array_equal(labels[clear],
                                          j[f"pseudo_label_{key}"][clear])
            np.testing.assert_array_equal(saved[i][f"pseudo_label_{key}"], labels)
            n_cmp += int(clear.sum())
    assert n_cmp > 1000


def _dataset(package, root, pselab):
    if package == "jax":
        from mm2d3d_tpu.data.nuscenes import NuScenesLidarSeg as cls
    else:
        cls = NuScenesLidarSeg
    return cls(split=("train_singapore",), preprocess_dir=osp.join(root, "preprocess"),
               nuscenes_dir=root, pselab_paths=pselab, scale=20, full_scale=256,
               resize=(40, 22))


def test_datasets_attach_the_same_refined_labels(generated, ws, monkeypatch):
    import mm2d3d_tpu.data.augment as augment_jax

    monkeypatch.setattr(augment_jax, "_USE_NATIVE", False)
    root = str(ws / "data")
    port, ref = (_dataset(p, root, generated["file"]) for p in ("port", "jax"))
    assert len(port) == len(ref) == len(generated["port"])
    for i in range(len(port)):
        a, b = port[i], ref[i]
        for key in KEYS:
            name = f"pseudo_label_{key}"
            assert a[name] is not None and len(a[name]) == len(a["seg_label"])
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{i} {name}")
        # the refinement keeps some labels and ignores the rest
        assert (a["pseudo_label_2d"] >= 0).any()


def test_cli_trains_on_the_generated_labels(generated, ws, monkeypatch):
    from mm2d3d_tpu_torch.run import main
    from mm2d3d_tpu_torch.train.step import MM2D3DTask

    carried = []
    step = MM2D3DTask.train_step

    def recording(self, src, trg, *a, **kw):
        carried.append(trg.pseudo_label_2d is not None
                       and bool((trg.pseudo_label_2d >= 0).any()))
        return step(self, src, trg, *a, **kw)

    monkeypatch.setattr(MM2D3DTask, "train_step", recording)
    trainer, _ = main(["--config", str(ws / "configs" / "config.yaml"), "--device", "cpu",
                       f"train.out_dir={ws / 'runs' / 'retrain'}",
                       f"dataset.target.pselab_paths={generated['file']}",
                       "train.params.val_log_images_step=null"])
    assert trainer.global_step == 2 and carried == [True, True]


@pytest.mark.parametrize("strict", [False, True])
def test_dropped_hits_warn_or_raise(generated, ws, monkeypatch, capsys, strict):
    """Tiers of one and two hits with compaction caps of one row make the
    3-tier levels drop hits (at scale 2, where the fake scans' points have
    neighbours; the plain plan drops none there)."""
    from mm2d3d_tpu_torch.train import batch as batch_mod

    caps = batch_mod.default_slot_caps

    def tiny(num_levels, capacities=None, profile="default"):
        return tuple((1, 2, s[2], 1, 1) if len(s) == 5 else s
                     for s in caps(num_levels, capacities, profile))

    cfg = parse_config(str(ws / "configs" / "config.yaml"), [
        f"train.out_dir={ws / 'runs' / 'port'}", "dataset.specific.scale=2"])
    out = str(ws / "runs" / f"strict{strict}.npy")
    gen.generate(cfg, "last", out, strict=strict, device="cpu")
    assert "WARNING" not in capsys.readouterr().out
    monkeypatch.setattr(batch_mod, "default_slot_caps", tiny)
    if strict:
        with pytest.raises(RuntimeError, match="dropped by the slot-table cap"):
            gen.generate(cfg, "last", out + "2", strict=True, device="cpu")
        assert not osp.exists(out + "2")
    else:
        gen.generate(cfg, "last", out, device="cpu")
        assert "WARNING: scan 0:" in capsys.readouterr().out


def test_main_raises_without_a_gpu_unless_given_the_cpu(generated, ws):
    config = str(ws / "configs" / "config.yaml")
    out = str(ws / "runs" / "main.npy")
    argv = ["--config", config, "--ckpt", "last", "--out", out,
            f"train.out_dir={ws / 'runs' / 'port'}"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gen.main(argv)
    records = gen.main(argv[:6] + ["--device", "cpu"] + argv[6:])
    for a, b in zip(records, generated["port"]):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_restore_leaves_the_dropout_stream_out(generated, ws, tmp_path):
    """A checkpoint written on the card holds a CUDA generator's state (16
    bytes), which a CPU generator refuses: the generator's task takes the
    weights, statistics and optimizers without it."""
    state = torch.load(ws / "runs" / "port" / "ckpts" / "last.pt", weights_only=True)
    state["generator"] = torch.zeros(16, dtype=torch.uint8)
    (tmp_path / "ckpts").mkdir()
    torch.save(state, tmp_path / "ckpts" / "last.pt")
    try:
        with pytest.raises(RuntimeError, match="RNG state"):
            torch.Generator().set_state(state["generator"])
        cfg = parse_config(str(ws / "configs" / "config.yaml"),
                           [f"train.out_dir={tmp_path}"])
        dataset, dm = gen.target_train_dataset(cfg)
        task = gen.restore_task(cfg, dm, "last", "cpu")
        for name in ("model2d", "model3d"):
            got = getattr(task, name).state_dict()
            assert got.keys() == state[name].keys()
            assert all(torch.equal(got[k], state[name][k]) for k in got), name
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
