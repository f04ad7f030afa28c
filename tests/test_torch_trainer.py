"""The trainer and CLI of mm2d3d_tpu_torch vs the JAX package's, on the CPU.

- A port `Trainer` and a JAX `Trainer` over the same fake-nuScenes loaders
  (tests/test_torch_data.py holds their batches bit-equal): fp32, tiny
  widths (m=8, 3 planes, full_scale 256, 40x22 images), SGD with momentum
  0.9, dropout off on both sides, the same flax weights (`load_flax`; BN
  scales and biases near 1, as in tests/test_torch_train.py).  Three train
  steps, validation, test: every train log within 1e-4 relative, the
  confusion matrices equal except at near-tie points, the same best
  checkpoints.  One JAX fit serves the module.
- Save, resume, and the resumed epoch bit-identical to the uninterrupted
  run (dropout on, AdamW with OneCycle).
- configs/vkitti_skitti.yaml, shrunk (m=8, 3 planes, full_scale 256,
  240x150 crops, fp32, SGD under its OneCycle), over fixture trees of
  tests/test_torch_kitti_data.py: the port's and the JAX CLI's datamodule,
  task (`run.build_task`, the dense slot profile) and Trainer, three train
  steps, validation and test, every log within 1e-4 relative.  One JAX fit
  serves the module.
- The overflow warnings on both log paths; the CLI's fast_dev_run, run=test
  with resume, and its refusals; configs/a2d2.yaml (its computed class
  weights and `total_steps: auto` against the JAX CLI's) and
  configs/day_night.yaml through the CLI; the torchvision ResNet-34 import
  against the JAX import mapped through `from_flax`.
"""

import json
import os.path as osp
import shutil
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_batch, near_tie, randomize_stats, to_numpy_tree
from test_torch_data import write_nuscenes
from test_torch_kitti_data import write_a2d2, write_semantic_kitti, write_virtual_kitti

from mm2d3d_tpu.data.loader import Loader as LoaderJ
from mm2d3d_tpu.data.nuscenes import NuScenesLidarSeg as NuScenesJ
from mm2d3d_tpu.flagship import flagship_task as flagship_task_jax
from mm2d3d_tpu.train.trainer import Trainer as TrainerJ
from mm2d3d_tpu_torch.data.loader import Loader
from mm2d3d_tpu_torch.data.nuscenes import NuScenesLidarSeg
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.tools.train_repro import differing, snapshot
from mm2d3d_tpu_torch.train.trainer import Trainer

SMALL = dict(full_scale=256, num_planes=3, m=8)
SGD = {"name": "sgd", "lr": 1e-2, "momentum": 0.9}
ADAMW_ONE_CYCLE = {"name": "adamw", "lr": 1e-3, "lr_scheduler": {
    "name": "one_cycle", "max_lr": 5e-3, "total_steps": 6}}
SPLITS = {"source": "train_usa", "target": "train_singapore",
          "val": "val_singapore", "test": "test_singapore"}
AUG = dict(noisy_rot=0.1, flip_x=0.5, rot=6.2831, transl=True, fliplr=0.5,
           color_jitter=(0.4, 0.4, 0.4))
CLASSES = ["vehicle", "driveable_surface", "sidewalk", "terrain", "manmade",
           "vegetation"]
REL = 1e-4
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


class Recorder:
    """A logger that keeps every `log_metrics` call."""

    def __init__(self):
        self.calls = []

    def log_metrics(self, metrics, step):
        self.calls.append((step, {k: float(v) for k, v in metrics.items()}))

    def train_logs(self):
        """The train steps' logs, without the spans' host times
        (`time/<span>_ms`), which differ from run to run."""
        return [(s, {k: v for k, v in m.items() if not k.startswith("time/")})
                for s, m in self.calls if "train/loss_total" in m]


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied after the test: the checkpoints written
    here are ~0.6 GB each, and pytest keeps the last runs' directories."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def nusc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_trainer"))
    write_nuscenes(root, np.random.RandomState(1), scans_per_split=6)
    return root


def loaders(root, package="port", batch_size=2):
    """source, target, val, test loaders over the fake splits (train: every
    augmentation, shuffled; eval: padded tail)."""
    ds_cls, loader_cls = ((NuScenesLidarSeg, Loader) if package == "port"
                          else (NuScenesJ, LoaderJ))
    out = []
    for role, split in SPLITS.items():
        train = role in ("source", "target")
        ds = ds_cls(split=(split,), preprocess_dir=osp.join(root, "preprocess"),
                    nuscenes_dir=root, scale=20, full_scale=256, resize=(40, 22),
                    device_image_ops=True, output_orig=not train,
                    **(AUG if train else {}))
        out.append(loader_cls(ds, batch_size, 256 if train else 320, shuffle=train,
                              drop_last=train, seed=42 + (role == "target"),
                              full_scale=256, pad_last=not train))
    return out


def _biases_near_one(params, seed):
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (1 + 0.1 * r.randn(*x.shape)).astype(np.float32)
        if x.ndim == 1 else x, to_numpy_tree(params))


def _recording(fn, calls):
    """fn(..., batch, metrics) -> (metrics, logs), keeping each batch, the
    metrics it returned, and whether it started an eval loop (the incoming
    matrices were fresh)."""
    def wrapped(*args):
        fresh = not np.asarray(args[-1].cm_2d).any()
        metrics, logs = fn(*args)
        calls.append((fresh, args[-2], metrics))
        return metrics, logs

    return wrapped


def _eval_runs(calls):
    """-> one [(batch, (cm_2d, cm_3d, cm_avg) after it), ...] per eval loop."""
    runs = []
    for fresh, batch, m in calls:
        if fresh:
            runs.append([])
        runs[-1].append((batch, tuple(np.asarray(x) for x in
                                      (m.cm_2d, m.cm_3d, m.cm_avg))))
    return runs


@pytest.fixture(scope="module")
def fits(nusc, tmp_path_factory):
    import mm2d3d_tpu.data.augment as augment_jax

    ckpts = tmp_path_factory.mktemp("ckpts")
    lj = loaders(nusc, "jax")
    task_j = flagship_task_jax(compute_dtype=jnp.float32, optimizer_2d=SGD,
                               optimizer_3d=SGD, **SMALL)
    calls_j, log_j = [], Recorder()
    task_j.jit_eval_step = _recording(jax.jit(task_j.eval_step), calls_j)
    trainer_j = TrainerJ(task_j, *lj[:2], val_loader=lj[2], test_loader=lj[3],
                         ckpt_dir=str(ckpts / "jax"), max_epochs=1,
                         class_names=CLASSES, logger=log_j, limit_train_batches=3,
                         prefetch_batches=0)
    with pytest.MonkeyPatch.context() as mp:
        # the numpy image ops, which the port copies (test_torch_data.py)
        mp.setattr(augment_jax, "_USE_NATIVE", False)
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        state = task_j.init_state(jax.random.PRNGKey(0),
                                  jax_batch(next(iter(lj[0]))))
        params2d = _biases_near_one(state.params2d, 3)
        state = state.replace(params2d=params2d, opt2d=task_j.tx2d.init(params2d),
                              stats2d=randomize_stats(state.stats2d, 1),
                              stats3d=randomize_stats(state.stats3d, 2))
        init = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                                state.params3d, state.stats3d))
        trainer_j.state = state
        trainer_j.fit()
        test_j = trainer_j.test()
    # a checkpoint holds both ResNet-34 encoders and their optimizer state
    # (~0.4 GB here): keep the names, free the disk
    names_j = {n for n in ("last", "best_2d", "best_3d") if (ckpts / "jax" / n).exists()}
    shutil.rmtree(ckpts / "jax")

    task = flagship_task(compute_dtype=torch.float32, optimizer_2d=SGD,
                         optimizer_3d=SGD, device="cpu", **SMALL)
    task.load_flax(*init)
    for enc in (task.model2d.rgb_backbone, task.model2d.depth_backbone):
        enc.dropout_rate = 0.0
    calls_t, log_t = [], Recorder()
    task.eval_step = _recording(task.eval_step, calls_t)
    trainer = Trainer(task, *loaders(nusc), ckpt_dir=str(ckpts / "port"),
                      max_epochs=1, class_names=CLASSES, logger=log_t,
                      limit_train_batches=3)
    trainer.initialized = True
    trainer.fit()
    test_t = trainer.test()
    yield dict(trainers=(trainer, trainer_j), logs=(log_t, log_j),
               evals=(_eval_runs(calls_t), _eval_runs(calls_j)),
               tests=(test_t, test_j), ckpts=ckpts, names_j=names_j)
    shutil.rmtree(ckpts)


def test_train_logs_match_jax(fits):
    log_t, log_j = (lg.train_logs() for lg in fits["logs"])
    assert [s for s, _ in log_t] == [s for s, _ in log_j] == [1, 2, 3]
    for (step, lt), (_, lj) in zip(log_t, log_j):
        assert set(lt) == set(lj), step
        assert lt["train/nbr_slot_overflow"] == lt["train/voxel_overflow_levels"] == 0
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=REL, atol=1e-7,
                                       err_msg=f"step {step} {k}")


def test_confusion_matrices_match_jax(fits):
    """val and test after fit, then test again: per eval loop, the 2D, 3D
    and ensemble matrices equal, up to the points whose top-2 gap is under
    1e-3 (another summation order may flip their argmax)."""
    runs_t, runs_j = fits["evals"]
    trainer = fits["trainers"][0]
    assert len(runs_t) == len(runs_j) == 3
    for run_t, run_j in zip(runs_t, runs_j):
        assert len(run_t) == len(run_j) == 3
        ties = np.zeros(3, np.int64)
        for batch, _ in run_t:
            out = trainer.task.forward(batch)
            keep = ((batch.seg_label != -100) & batch.point_mask).reshape(-1).numpy()
            for h, logits in enumerate((out["seg_logit_2d"], out["seg_logit_3d"],
                                        out["ensemble"])):
                flat = logits.reshape(keep.shape[0], -1).numpy()
                ties[h] += int((near_tie(flat) & keep).sum())
        for h in range(3):
            diff = np.abs(run_t[-1][1][h].astype(np.int64)
                          - run_j[-1][1][h].astype(np.int64)).sum()
            assert diff <= 2 * ties[h], (h, diff, ties[h])
        assert run_t[-1][1][0].sum() > 0


def test_eval_logs_and_best_checkpoints_match_jax(fits):
    trainer, trainer_j = fits["trainers"]
    (_, ev_t), = [c for c in fits["logs"][0].calls if "val/target/iou" in c[1]]
    (_, ev_j), = [c for c in fits["logs"][1].calls if "val/target/iou" in c[1]]
    assert set(ev_t) == set(ev_j)
    for k in ev_j:
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=REL, atol=1e-6, err_msg=k)
    for k, v in trainer_j.best.items():
        np.testing.assert_allclose(trainer.best[k], v, rtol=REL, atol=1e-6, err_msg=k)
    test_t, test_j = fits["tests"]
    assert set(test_t) == set(test_j)
    for k in test_j:
        np.testing.assert_allclose(test_t[k], test_j[k], rtol=REL, atol=1e-6, err_msg=k)
    names = fits["names_j"]
    assert names == {n for n in ("last", "best_2d", "best_3d")
                     if osp.exists(fits["ckpts"] / "port" / f"{n}.pt")}
    assert "last" in names and len(names) >= 2
    with open(fits["ckpts"] / "port" / "last.meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 0 and meta["global_step"] == 3


def _resume_trainer(nusc, ckpt_dir, max_epochs, logger):
    task = flagship_task(compute_dtype=torch.float32, optimizer_2d=ADAMW_ONE_CYCLE,
                         optimizer_3d=ADAMW_ONE_CYCLE, device="cpu", **SMALL)
    lo = loaders(nusc)
    return Trainer(task, lo[0], lo[1], val_loader=lo[2], ckpt_dir=str(ckpt_dir),
                   max_epochs=max_epochs, class_names=CLASSES, logger=logger,
                   seed=5, limit_val_batches=1)


def _differing(a, b):
    """Where two trainers' task states (weights, running statistics,
    optimizer moments and schedules, step, dropout generator) differ."""
    return differing(snapshot(a.task, a.generator), snapshot(b.task, b.generator))


def test_resume_is_bit_identical_to_the_uninterrupted_run(nusc, tmp_path):
    """Epoch 0 (3 steps, validation, `last`), then a new trainer resumes
    from `last` for epoch 1: its steps 4-6 and final state equal those of
    one trainer that ran both epochs, bit for bit (dropout on, so the
    generator state matters; OneCycle, so the schedule's position does)."""
    whole_log = Recorder()
    whole = _resume_trainer(nusc, tmp_path / "whole", 2, whole_log)
    whole.fit()
    shutil.rmtree(tmp_path / "whole")  # ~0.6 GB per checkpoint
    first = _resume_trainer(nusc, tmp_path / "split", 1, Recorder())
    first.fit()
    assert first.global_step == 3
    resumed_log = Recorder()
    resumed = _resume_trainer(nusc, tmp_path / "split", 2, resumed_log)
    resumed.fit(resume=True)
    assert resumed.start_epoch == 1
    assert [s for s, _ in resumed_log.train_logs()] == [4, 5, 6]
    assert resumed_log.train_logs() == whole_log.train_logs()[3:]
    assert resumed.global_step == whole.global_step == 6
    assert resumed.best == whole.best
    assert not _differing(resumed, whole)
    lr = resumed.task.opt2d.param_groups[0]["lr"]
    assert lr == resumed.task.lr_schedule_2d(6)


def _overflow_trainer(nusc, tmp_path, logger=None):
    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    lo = loaders(nusc)
    return Trainer(task, lo[0], lo[1], ckpt_dir=str(tmp_path / "ckpts"),
                   max_epochs=1, limit_train_batches=1, logger=logger)


def test_overflow_warning_without_logger(nusc, tmp_path, monkeypatch, capsys):
    """Tiny voxel capacities overflow every level; with no logger the
    epoch-end flush still warns."""
    from mm2d3d_tpu_torch.train import batch as B

    monkeypatch.setattr(B, "default_capacities",
                        lambda num_points, num_levels, batch_size=None, profile="default":
                        (16,) * num_levels)
    _overflow_trainer(nusc, tmp_path).fit()
    out = capsys.readouterr().out
    assert "WARNING: train/voxel_overflow_levels" in out
    assert "gradients" in out.lower()


@pytest.mark.parametrize("path", ["history", "flush"])
def test_overflow_warnings_for_injected_values(nusc, tmp_path, capsys, path):
    """The epoch-end scan of the per-step scalars (no logger) and the
    per-step flush (with a logger) warn once per key, with the step."""
    recorder = Recorder() if path == "flush" else None
    trainer = _overflow_trainer(nusc, tmp_path, recorder)
    values = ((1, 0.0), (2, 7.0), (3, 0.0))  # the middle step overflows
    for rep in range(2):  # the second pass stays silent
        if path == "history":
            trainer._check_overflow_history([
                (s, {"train/nbr_slot_overflow": torch.tensor(v)}) for s, v in values])
        else:
            for s, v in values:
                trainer._flush_train_logs(s, {
                    "train/nbr_slot_overflow": torch.tensor(v),
                    "train/voxel_overflow_levels": torch.tensor(0.0)})
        out = capsys.readouterr().out
        if rep == 0:
            assert "WARNING: train/nbr_slot_overflow = 7 at step 2" in out
            assert "voxel_overflow_levels" not in out
        else:
            assert "WARNING" not in out
    if recorder is not None:
        assert [s for s, _ in recorder.calls] == [1, 2, 3, 1, 2, 3]


@pytest.fixture
def workspace(tmp_path):
    return write_workspace(tmp_path)


def write_workspace(tmp_path):
    """The tiny config tree and fake data of tests/test_cli.py under
    `tmp_path` (a pathlib.Path) -> `tmp_path`."""
    root = tmp_path / "data"
    pre = write_nuscenes(str(root), np.random.RandomState(2), scans_per_split=4)
    (tmp_path / "configs" / "datasets").mkdir(parents=True)
    (tmp_path / "configs" / "run").mkdir()
    (tmp_path / "configs" / "config.yaml").write_text(f"""
defaults:
  - _self_
  - datasets: tiny
  - run: train
models:
  net2d:
    frozen_batch_norm: false
    optimizer: {{name: adamw, lr: 0.001}}
  net3d:
    backbone_3d: {{in_channels: 3, m: 8, block_reps: 1, residual_blocks: false,
                  full_scale: 256, num_planes: 3}}
    optimizer: {{name: adamw, lr: 0.001}}
losses:
  - name: cross_entropy
    weight: 1.0
    target: segmentation
train:
  seed: 42
  out_dir: {tmp_path}/runs/t
  n_points: 256
  compute_dtype: float32
  num_workers: 0
  params:
    class_names: {CLASSES}
    val_log_images_step: 1
    lambda_xm_src: 1.0
    lambda_xm_trg: 0.1
""")
    (tmp_path / "configs" / "datasets" / "tiny.yaml").write_text(f"""
dataset:
  name: nuscenes
  source:
    TRAIN: [train_usa]
    preprocess_dir: {pre}
    nuscenes_dir: {root}
  target:
    TRAIN: [train_singapore]
    VAL: [val_singapore]
    TEST: [test_singapore]
    preprocess_dir: {pre}
    nuscenes_dir: {root}
  specific:
    merge_classes: true
    scale: 20
    full_scale: 256
    resize: [40, 22]
    use_rgb: true
  augmentations:
    fliplr: 0.5
""")
    (tmp_path / "configs" / "run" / "train.yaml").write_text(
        "run:\n  mode: train\n  batch_size: 2\n  max_epochs: 1\n"
        "  check_val_every_n_epoch: 1\n  resume: false\n  fast_dev_run: true\n")
    shutil.copy(osp.join(REPO, "configs", "run", "test.yaml"),
                tmp_path / "configs" / "run" / "test.yaml")
    return tmp_path


def test_cli_fast_dev_run_then_test_with_resume(workspace, capsys):
    from mm2d3d_tpu_torch.run import main

    cfg = str(workspace / "configs" / "config.yaml")
    trainer, results = main(["--config", cfg, "--device", "cpu"])
    out = workspace / "runs" / "t"
    assert trainer.global_step == 2 and trainer.task.device.type == "cpu"
    for name in ("last.pt", "last.meta.json"):
        assert (out / "ckpts" / name).exists()
    assert (out / "code_snapshot" / "mm2d3d_tpu_torch" / "run.py").exists()
    lines = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    assert [ln["step"] for ln in lines if "train/loss_total" in ln] == [1, 2]
    assert {"test/target/iou", "test/target/iou_3d", "test/target/iou_avg"} <= set(results)
    printed = capsys.readouterr().out
    assert "is ignored" not in printed  # the figure keys are honoured now
    # train_log_images_step 2000 (the CLI's default) draws step 0; the
    # workspace's val_log_images_step 1 every val and test batch, in the
    # dataset's palette (the config names none)
    assert sorted(p.name for p in (out / "figures").iterdir()) == [
        "test_target_step2.png", "train_source_step0.png", "train_target_step0.png",
        "val_target_step2.png"]

    tester, again = main(["--config", cfg, "--device", "cpu", "run=test",
                          "run.batch_size=2", "run.resume=true"])
    assert tester.global_step == 2 and tester.start_epoch == 1
    assert "resumed from epoch 1, step 2" in capsys.readouterr().out
    assert not _differing(tester, trainer)
    assert again == results


def test_cli_worker_pools_then_stop_worker_server(workspace):
    """The CLI with worker pools, fit then test with resume: the batches
    equal the in-process ones, and `stop_worker_server` then leaves none of
    the pools' server processes running."""
    from multiprocessing import forkserver, resource_tracker

    from mm2d3d_tpu_torch.data.loader import stop_worker_server
    from mm2d3d_tpu_torch.run import main

    cfg = str(workspace / "configs" / "config.yaml")
    trainer, results = main(["--config", cfg, "--device", "cpu", "train.num_workers=2"])
    inline, inline_results = main(["--config", cfg, "--device", "cpu",
                                   f"train.out_dir={workspace / 'runs' / 'inline'}"])
    assert results == inline_results and not _differing(trainer, inline)
    tester, again = main(["--config", cfg, "--device", "cpu", "train.num_workers=2",
                          "run=test", "run.batch_size=2", "run.resume=true"])
    assert again == results and not _differing(tester, trainer)
    servers = [forkserver._forkserver._forkserver_pid,
               resource_tracker._resource_tracker._pid]
    assert None not in servers
    stop_worker_server()
    assert [p for p in servers if osp.exists(f"/proc/{p}")] == []


@pytest.mark.parametrize("override,tracker", [
    ("logging.wandb.project=x", "wandb"),
    ("logging.mlflow.experiment_name=x", "mlflow"),
])
def test_cli_refuses_what_is_not_ported(workspace, override, tracker, monkeypatch,
                                        capsys):
    """The trackers are ported now, so the CLI refuses neither: without the
    tracker's package it prints the JAX package's "<tracker> logging
    disabled" line and trains with stdout and metrics.jsonl
    (tests/test_torch_trackers.py holds the loggers themselves)."""
    from mm2d3d_tpu_torch.run import main

    monkeypatch.setitem(sys.modules, tracker, None)  # the import raises
    trainer, _ = main(["--config", str(workspace / "configs" / "config.yaml"),
                       "--device", "cpu", override])
    assert trainer.global_step == 2
    assert f"{tracker} logging disabled: " in capsys.readouterr().err
    assert (workspace / "runs" / "t" / "metrics.jsonl").exists()
    assert not (workspace / "runs" / "t" / "run_id.yaml").exists()


# --------------------------------------------------------------------------
# the KITTI-family scenarios and day/night through the configs as shipped
# --------------------------------------------------------------------------

SKITTI_HW = (160, 250)  # frames of the SemanticKITTI fixture: crops of 240x150
SHRINK = ["models.net3d.backbone_3d.m=8", "models.net3d.backbone_3d.num_planes=3",
          "models.net3d.backbone_3d.full_scale=256", "dataset.specific.full_scale=256",
          "train.n_points=512", "train.eval_n_points=1024",
          "train.compute_dtype=float32", "train.num_workers=0",
          "run.batch_size=2", "run.test_batch_size=2"]
KITTI_SHRINK = SHRINK + ["dataset.specific.crop_size=[240, 150]"]


@pytest.fixture(scope="module")
def kitti_trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti_trainer")
    rng = np.random.RandomState(8)
    return {
        "semantic_kitti": write_semantic_kitti(
            str(base / "semantic_kitti"), rng, {"train": 6, "val": 3, "test": 3},
            hw=SKITTI_HW),
        "virtual_kitti": write_virtual_kitti(str(base / "virtual_kitti"), rng),
        "a2d2": write_a2d2(str(base / "a2d2"), rng, scans=6),
    }


def kitti_paths(trees, source):
    sk = trees["semantic_kitti"]
    out = [f"dataset.target.preprocess_dir={sk}/preprocess",
           f"dataset.target.semantic_kitti_dir={sk}"]
    if source == "virtual_kitti":
        return out + [f"dataset.source.preprocess_dir={trees[source]}/preprocess",
                      f"dataset.source.virtual_kitti_dir={trees[source]}"]
    return out + [f"dataset.source.preprocess_dir={trees[source]}"]


def _cli_config(load, name, overrides):
    """A config as both CLIs read it: the file, the overrides, then the
    dataset's `train_overrides` merged into `train`."""
    cfg = load(osp.join(REPO, "configs", name), overrides)
    from mm2d3d_tpu_torch.utils.config import _deep_merge

    cfg["train"] = _deep_merge(cfg["train"], cfg.pop("train_overrides"))
    return cfg


@pytest.fixture(scope="module")
def vkitti_fits(kitti_trees, tmp_path_factory):
    """configs/vkitti_skitti.yaml, shrunk, through both packages' CLI
    builders and Trainers: 3 steps, validation, test."""
    import mm2d3d_tpu.data.augment as augment_jax
    from mm2d3d_tpu import run as cli_jax
    from mm2d3d_tpu.utils.config import load_config as load_config_jax
    from mm2d3d_tpu_torch import run as cli
    from mm2d3d_tpu_torch.utils.config import load_config

    sgd = [f"models.{b}.optimizer.{k}={v}" for b in ("net2d", "net3d")
           for k, v in (("name", "sgd"), ("momentum", 0.9))]
    overrides = KITTI_SHRINK + sgd + kitti_paths(kitti_trees, "virtual_kitti")
    cfg = _cli_config(load_config, "vkitti_skitti.yaml", overrides)
    cfg_j = _cli_config(load_config_jax, "vkitti_skitti.yaml", overrides)
    assert cfg == cfg_j and cfg["train"]["slot_profile"] == "dense"
    classes = cfg["train"]["params"]["class_names"]
    ckpts = tmp_path_factory.mktemp("kitti_ckpts")
    common = dict(max_epochs=1, class_names=classes, limit_train_batches=3,
                  limit_val_batches=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(augment_jax, "_USE_NATIVE", False)
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        dm_j = cli_jax.build_datamodule(cfg_j)
        cli_jax.resolve_auto_params(cfg_j, dm_j)
        task_j = cli_jax.build_task(cfg_j, dm_j.num_classes)
        log_j = Recorder()
        trainer_j = TrainerJ(task_j, dm_j.source_train, dm_j.target_train,
                             val_loader=dm_j.target_val, test_loader=dm_j.target_test,
                             ckpt_dir=str(ckpts / "jax"), logger=log_j,
                             prefetch_batches=0, **common)
        state = task_j.init_state(jax.random.PRNGKey(1),
                                  jax_batch(next(iter(dm_j.source_train))))
        params2d = _biases_near_one(state.params2d, 4)
        state = state.replace(params2d=params2d, opt2d=task_j.tx2d.init(params2d),
                              stats2d=randomize_stats(state.stats2d, 5),
                              stats3d=randomize_stats(state.stats3d, 6))
        init = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                                state.params3d, state.stats3d))
        trainer_j.state = state
        trainer_j.fit()
        test_j = trainer_j.test()
    shutil.rmtree(ckpts / "jax")

    dm = cli.build_datamodule(cfg)
    cli.resolve_auto_params(cfg, dm)
    task = cli.build_task(cfg, dm.num_classes, device="cpu")
    task.load_flax(*init)
    for enc in (task.model2d.rgb_backbone, task.model2d.depth_backbone):
        enc.dropout_rate = 0.0
    log_t = Recorder()
    trainer = Trainer(task, dm.source_train, dm.target_train, val_loader=dm.target_val,
                      test_loader=dm.target_test, ckpt_dir=str(ckpts / "port"),
                      logger=log_t, **common)
    trainer.initialized = True
    trainer.fit()
    test_t = trainer.test()
    yield dict(trainers=(trainer, trainer_j), logs=(log_t, log_j),
               tests=(test_t, test_j), classes=classes)
    shutil.rmtree(ckpts)


def test_vkitti_skitti_trainer_matches_jax(vkitti_fits):
    trainer, trainer_j = vkitti_fits["trainers"]
    assert trainer.task.slot_profile == trainer_j.task.slot_profile == "dense"
    assert trainer.class_names == vkitti_fits["classes"] and len(trainer.class_names) == 6
    log_t, log_j = (lg.train_logs() for lg in vkitti_fits["logs"])
    assert [s for s, _ in log_t] == [s for s, _ in log_j] == [1, 2, 3]
    for (step, lt), (_, lj) in zip(log_t, log_j):
        assert set(lt) == set(lj), step
        assert lt["train/nbr_slot_overflow"] == lt["train/voxel_overflow_levels"] == 0
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=REL, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    (_, ev_t), = [c for c in vkitti_fits["logs"][0].calls if "val/target/iou" in c[1]]
    (_, ev_j), = [c for c in vkitti_fits["logs"][1].calls if "val/target/iou" in c[1]]
    assert set(ev_t) == set(ev_j)
    assert ev_t["val/target/nbr_slot_overflow"] == 0
    for k in ev_j:
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=REL, atol=1e-6, err_msg=k)
    test_t, test_j = vkitti_fits["tests"]
    assert set(test_t) == set(test_j)
    for k in test_j:
        np.testing.assert_allclose(test_t[k], test_j[k], rtol=REL, atol=1e-6, err_msg=k)


def test_a2d2_cli_resolves_auto_params_as_jax(kitti_trees, tmp_path, capsys):
    """configs/a2d2.yaml, shrunk, through the port's CLI with fast_dev_run:
    its computed class weights (`weight: compute`) and `total_steps: auto`
    equal what the JAX CLI resolves from the same trees."""
    from mm2d3d_tpu import run as cli_jax
    from mm2d3d_tpu.utils.config import load_config as load_config_jax
    from mm2d3d_tpu_torch.run import main

    overrides = (KITTI_SHRINK + kitti_paths(kitti_trees, "a2d2")
                 + ["dataset.specific.resize=[240, 150]"])
    trainer, results = main(["--config", osp.join(REPO, "configs", "a2d2.yaml"),
                             "--device", "cpu", *overrides, "run.fast_dev_run=true",
                             f"train.out_dir={tmp_path / 'run'}"])
    out = capsys.readouterr().out
    cfg_j = _cli_config(load_config_jax, "a2d2.yaml", overrides)
    cli_jax.resolve_auto_params(cfg_j, cli_jax.build_datamodule(cfg_j))
    weights = cfg_j["losses"][0]["args"]["weight"]
    assert len(weights) == 10
    assert f"computed class weights: {weights}" in out
    steps = cfg_j["models"]["net2d"]["optimizer"]["lr_scheduler"]["total_steps"]
    assert steps == 29 * 3  # max_epochs x max(6 A2D2, 6 SemanticKITTI scans) / 2
    assert f"total_steps=auto -> {steps}" in out
    assert trainer.task.class_weights.tolist() == pytest.approx(weights, rel=1e-7)
    assert trainer.task.slot_profile == "dense" and trainer.global_step == 2
    assert trainer.class_names == cfg_j["train"]["params"]["class_names"]
    assert {"test/target/iou", "test/target/iou_3d", "test/target/iou_avg"} <= set(results)


def test_day_night_cli_fast_dev_run(tmp_path):
    """configs/day_night.yaml, shrunk, through the port's CLI with
    fast_dev_run, over a fake nuScenes tree of the day/night splits."""
    from mm2d3d_tpu_torch.run import main

    root = tmp_path / "nusc"
    pre = write_nuscenes(str(root), np.random.RandomState(9), scans_per_split=4)
    for old, new in (("train_usa", "train_day"), ("train_singapore", "train_night"),
                     ("val_singapore", "val_night"), ("test_singapore", "test_night")):
        shutil.move(osp.join(pre, old + ".pkl"), osp.join(pre, new + ".pkl"))
    paths = [f"dataset.{d}.{k}={v}" for d in ("source", "target")
             for k, v in (("preprocess_dir", pre), ("nuscenes_dir", root))]
    trainer, results = main(["--config", osp.join(REPO, "configs", "day_night.yaml"),
                             "--device", "cpu", *SHRINK, *paths,
                             "dataset.specific.resize=[40, 22]", "run.fast_dev_run=true",
                             f"train.out_dir={tmp_path / 'run'}"])
    assert trainer.global_step == 2 and trainer.task.slot_profile == "default"
    assert trainer.class_names == CLASSES
    assert {"test/target/iou", "test/target/iou_3d", "test/target/iou_avg"} <= set(results)


def test_pretrained_backbone_matches_jax_import(tmp_path):
    """A torchvision-layout resnet34 state_dict built here: the port's
    import equals the JAX import (`load_pretrained_backbone`) mapped through
    `from_flax`, tensor for tensor, and loads into `Net2DSeg`."""
    from mm2d3d_tpu.models.torch_import import load_pretrained_backbone as load_jax
    from mm2d3d_tpu_torch.models.convert import from_flax
    from mm2d3d_tpu_torch.models.net2d import Net2DSeg
    from mm2d3d_tpu_torch.models.torch_import import load_pretrained_backbone

    g = torch.Generator().manual_seed(0)
    sd = {}

    def conv(name, co, ci, k):
        sd[f"{name}.weight"] = torch.randn(co, ci, k, k, generator=g)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.{leaf}"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for i, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), 1):
        for b in range(blocks):
            t = f"layer{i}.{b}"
            conv(f"{t}.conv1", width, cin if b == 0 else width, 3)
            bn(f"{t}.bn1", width)
            conv(f"{t}.conv2", width, width, 3)
            bn(f"{t}.bn2", width)
            if b == 0 and i > 1:
                conv(f"{t}.downsample.0", width, cin, 1)
                bn(f"{t}.downsample.1", width)
        cin = width
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    path = str(tmp_path / "resnet34.pth")
    torch.save(sd, path)

    ours = load_pretrained_backbone(path)
    p, s = load_jax(path)
    p, s = dict(p), dict(s)
    params2d = {"stem_rgb": p.pop("stem"), "rgb_backbone": p}
    stats2d = {"stem_rgb": s.pop("stem"), "rgb_backbone": s}
    ref, _ = from_flax(params2d, stats2d, {}, {})
    assert set(ours) == set(ref) and len(ours) == 5 + 16 * 10 + 3 * 5
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    net = Net2DSeg(6, torch.float32)
    missing, unexpected = net.load_state_dict(ours, strict=False)
    assert not unexpected
    assert all(not k.startswith(("stem_rgb", "rgb_backbone")) for k in missing)
    assert torch.equal(net.rgb_backbone.layer4_2.cb2.conv.weight,
                       sd["layer4.2.conv2.weight"])
