"""The port's sustained-fit tool (`mm2d3d_tpu_torch/tools/bench_e2e.py`) vs
the JAX tool (`tools/bench_e2e.py`), on the CPU at dryrun sizes.

The batch's bytes must be the JAX tool's `tree_bytes` of the JAX loader's
batch over the same on-disk tree; the whole tool (stage split, loader
rates with a worker pool, the fit, both controls, the fit with host-built
topologies) runs on a small CPU task and leaves no process and no
temporary directory; `main` refuses the CPU.
"""

import glob
import importlib.util
import math
import os.path as osp
import tempfile

import numpy as np
import pytest
import torch
from _torch_port import two_threads  # noqa: F401  (fixture)

import chip_smoke
import mm2d3d_tpu.data.augment as augment_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.tools import bench_e2e, bench_loader
from mm2d3d_tpu_torch.tools.autotune import ListLoader
from mm2d3d_tpu_torch.train.trainer import Trainer

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SMALL = dict(full_scale=256, num_planes=3, m=8)
JAX_KEYS = {"wire_format", "cache", "stage_loader_ms_per_batch", "batch_wire_bytes",
            "stage_transfer_ms_per_batch", "stage_device_step_ms",
            "loader_scans_per_sec_by_workers", "e2e_steps_measured",
            "e2e_train_scans_per_sec", "e2e_ms_per_step",
            "ctrl_host_batches_ms_per_step", "ctrl_device_batches_ms_per_step"}
TIME_KEYS = ("stage_loader_ms_per_batch", "stage_transfer_ms_per_batch",
             "stage_device_step_ms", "e2e_train_scans_per_sec", "e2e_ms_per_step",
             "ctrl_host_batches_ms_per_step", "ctrl_device_batches_ms_per_step",
             "e2e_ms_per_step_host_topology")
SCANS, POINTS, BATCH = 4, 1500, 2


def _jax_tool():
    """`tools/bench_e2e.py`, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "bench_e2e_jax", osp.join(REPO, "tools", "bench_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def sizes(monkeypatch):
    """Batch 2 of 2,048 points, two host batches, one timed stage step."""
    monkeypatch.setattr(bench_e2e, "BATCH", BATCH)
    monkeypatch.setattr(bench_e2e, "N_POINTS", 2048)
    monkeypatch.setattr(bench_e2e, "HOST_BATCHES", 2)
    monkeypatch.setattr(bench_e2e, "STAGE_STEPS", 1)


@pytest.mark.parametrize("wire", [True, False])
def test_batch_wire_bytes_match_jax_tree_bytes(sizes, monkeypatch, tmp_path, wire):
    """One batch of each package's loader over one tree (the flagship's
    frames and resize, the JAX tool's augmentations, seed 0): the port's
    bytes are the JAX tool's `tree_bytes`, field for field in shape."""
    jax_tool = _jax_tool()
    monkeypatch.setattr(jax_tool, "BATCH", BATCH)
    monkeypatch.setattr(jax_tool, "N_POINTS", 2048)
    monkeypatch.setattr(augment_jax, "_USE_NATIVE", False)
    root = str(tmp_path)
    bench_loader.write_dataset(root, SCANS, POINTS)
    ours = next(iter(bench_e2e.make_loaders(root, None, 0, wire, 4096)[0]))
    ref = next(iter(jax_tool.make_loaders(root, None, 0, wire)[0]))
    assert bench_e2e.batch_wire_bytes(ours) == jax_tool.tree_bytes(ref)
    for name, t in vars(ours).items():
        if isinstance(t, torch.Tensor):
            assert tuple(t.shape) == getattr(ref, name).shape, name
        else:
            assert t == getattr(ref, name), name
    # the uint8 wire image is a quarter of the float32 one
    assert ours.img.dtype == (torch.uint8 if wire else torch.float32)


def test_run_on_cpu_leaves_nothing_behind(sizes, monkeypatch, tmp_path, two_threads):  # noqa: F811
    """The whole tool on a small CPU task over 4 scans (frames 160x90 resized
    to 40x22), 2 steps, 0 and 2 loader workers: the JAX tool's keys and the
    host-topology time, finite; the timed epoch as long as the loader's
    epoch; no process and no temporary directory left."""
    monkeypatch.setattr(bench_loader, "FRAME_WH", (160, 90))
    monkeypatch.setattr(bench_loader, "RESIZE_WH", (40, 22))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    task = flagship_task(device="cpu", compute_dtype=torch.float32, **SMALL)
    before = set(chip_smoke.descendants())
    out = bench_e2e.run(task, scans=SCANS, steps=2, workers=(0, 2), points=POINTS)
    assert set(chip_smoke.descendants()) <= before
    assert not glob.glob(osp.join(str(tmp_path), "mm2d3d_e2e_*"))
    assert set(out) == JAX_KEYS | {"e2e_ms_per_step_host_topology"}
    assert out["wire_format"] is True and out["cache"] is True
    assert out["e2e_steps_measured"] == SCANS // BATCH
    assert set(out["loader_scans_per_sec_by_workers"]) == {"0", "2"}
    times = [out[k] for k in TIME_KEYS]
    times += list(out["loader_scans_per_sec_by_workers"].values())
    assert all(math.isfinite(v) and v > 0 for v in times)
    assert out["e2e_train_scans_per_sec"] == pytest.approx(
        2 * BATCH * 1e3 / out["e2e_ms_per_step"])
    # uint8 image, float32 depth, int32 indices/coords/labels, bool mask, ...
    assert out["batch_wire_bytes"] > BATCH * 22 * 40 * 3


def test_fit_and_controls_count_their_steps(sizes, two_threads):  # noqa: F811
    """`timed_fit` times the second epoch only; each control runs `steps`
    steps over its list loader, the device batches copied once and handed
    to the step as they are."""
    task = flagship_task(device="cpu", compute_dtype=torch.float32, **SMALL)
    task.init_params(torch.Generator().manual_seed(0))
    batches = [make_batch(np.random.RandomState(s), batch_size=1, height=22,
                          width=40, n_points=512, full_scale=256) for s in (0, 1)]
    seen = []
    step = task.train_step

    def recording(src, trg, gen, *topos):
        seen.append((src, trg))
        return step(src, trg, gen, *topos)

    task.train_step = recording
    with tempfile.TemporaryDirectory() as ck:
        ms = bench_e2e.control(task, batches[:1], 2, ck, on_device=True)
    assert math.isfinite(ms) and ms > 0
    assert len(seen) == 4  # a warm and a timed epoch of 2 steps
    assert all(s is t for s, t in seen)  # one list for both domains
    assert seen[0][0] is not batches[0]  # copied before the fit, not by it
    assert all(s is seen[0][0] for s, _ in seen)  # and not again per step
    seen.clear()
    with tempfile.TemporaryDirectory() as ck:
        tr = Trainer(task, source_loader=ListLoader(batches, 3),
                     target_loader=ListLoader(batches, 3), ckpt_dir=ck,
                     limit_train_batches=2)
        tr.initialized = True
        ms, steps = bench_e2e.timed_fit(tr)
    assert steps == 2 and len(seen) == 4 and tr.global_step == 4


def test_main_refuses_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_e2e.main(["--scans", "4", "--steps", "2"])
    assert capsys.readouterr().out == ""
