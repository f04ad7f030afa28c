"""The CLI of mm2d3d_tpu_torch under torchrun, on the CPU: two gloo ranks
(`python -m torch.distributed.run --nproc_per_node=2`, each rank through
`tools/ddp_check.py cli`) over the tiny config tree of
tests/test_torch_trainer.py (`workspace`, `--device cpu`, global batch 2).

- Fit, validation and test: both ranks end with the same state, bit for
  bit, and the same results; rank 0 alone writes the one checkpoint set,
  the metrics and the figures (and runs the figures' forward); the validation's confusion matrices equal one
  process's eval of the checkpoint over the same scans in the same
  batches.
- `run=test` with resume: both ranks restore the checkpoint, bit for bit,
  and report the fit's test results.
- The refusals of the JAX CLI (a world that does not divide the batch or
  the eval batch, `run.data_parallel=off` with more than one process),
  several GPUs without a launcher (the message names torchrun),
  `run.distributed` without the launcher's environment, and a rendezvous
  that does not complete: each raises, none falls back to one process.
"""

import json

import pytest
import torch
import torch.distributed as dist

from test_torch_trainer import tmp_path, workspace  # noqa: F401 (fixtures)

from mm2d3d_tpu_torch.parallel import mesh
from mm2d3d_tpu_torch.run import main
from mm2d3d_tpu_torch.tools import ddp_check

RANKS = 2
TIMEOUT_S = 300


def _launch(workspace, name, *overrides):
    cfg = str(workspace / "configs" / "config.yaml")
    prefix = str(workspace / name)
    ddp_check.launch(["cli", prefix, "--", "--config", cfg, "--device", "cpu",
                      *overrides], nproc=RANKS, timeout_s=TIMEOUT_S)
    ranks = ddp_check.read_ranks(prefix + ".rank*.pt")
    assert [r["rank"] for r in ranks] == list(range(RANKS))
    return ranks


def test_cli_data_parallel_fit_then_resumed_test(workspace):
    fit = _launch(workspace, "fit")
    out = workspace / "runs" / "t"
    for r in fit:
        assert r["device"] == "cpu" and r["global_step"] == 2
        assert r["state"] == fit[0]["state"] and r["results"] == fit[0]["results"]
        # validation (val, test) and the final test, the same on every rank
        assert len(r["evals"]) == 3
        for a, b in zip(r["evals"], fit[0]["evals"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
    assert {"test/target/iou", "test/target/iou_3d", "test/target/iou_avg"} <= set(
        fit[0]["results"])

    # one checkpoint set, written once; the metrics, once per step
    ckpts = sorted(p.name for p in (out / "ckpts").iterdir())
    assert "last.pt" in ckpts and "last.meta.json" in ckpts
    assert not [p for p in ckpts if p.endswith(".tmp")]
    lines = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    assert [ln["step"] for ln in lines if "train/loss_total" in ln] == [1, 2]
    saved = torch.load(out / "ckpts" / "last.pt", map_location="cpu", weights_only=True)
    assert ddp_check.digest(saved) == fit[0]["state"]
    # the figures (step 0's two batches, every val and test batch): rank 0
    # alone runs their forward and writes them
    assert [t["kind"] for t in fit[1]["topologies"]].count("viz") == 0
    assert [t["kind"] for t in fit[0]["topologies"]].count("viz") == 8
    assert len([ln for ln in lines if "image" in ln]) == 8
    assert sorted(p.name for p in (out / "figures").iterdir()) == [
        "test_target_step2.png", "train_source_step0.png", "train_target_step0.png",
        "val_target_step2.png"]

    # validation: one process over the same scans, in the ranks' batches
    cfg = str(workspace / "configs" / "config.yaml")
    ref = ddp_check.reference_eval(["--config", cfg, "--device", "cpu"], batch_size=1,
                                   limit=2 * RANKS, device="cpu")
    for k, cm in ref.items():
        assert torch.equal(fit[0]["evals"][0][k], cm), k
    assert int(ref["cm_2d"].sum()) > 0

    test = _launch(workspace, "test", "run=test", "run.batch_size=2", "run.resume=true")
    for r in test:
        assert r["global_step"] == 2 and r["start_epoch"] == 1
        assert r["state"] == fit[0]["state"]
        assert r["results"] == fit[0]["results"]


@pytest.mark.parametrize("override,match", [
    ("run.batch_size=3", "global batch 3 not divisible by 2 processes"),
    ("run.test_batch_size=3", "run.test_batch_size 3 not divisible by 2 processes"),
    ("run.data_parallel=off", "run.data_parallel must not be 'off'"),
])
def test_cli_refuses_a_world_that_does_not_fit(workspace, monkeypatch, override, match):
    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        main(["--config", str(workspace / "configs" / "config.yaml"), "--device", "cpu",
              override])
    assert not dist.is_initialized()


def test_cli_names_torchrun_for_several_gpus(workspace, monkeypatch):
    for k in mesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match=r"torchrun --nproc_per_node=4 -m "
                                           r"mm2d3d_tpu_torch\.run"):
        main(["--config", str(workspace / "configs" / "config.yaml")])


@pytest.mark.parametrize("how", ["config", "environment"])
def test_cli_distributed_needs_the_launcher(workspace, monkeypatch, how):
    for k in mesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    args = ["--config", str(workspace / "configs" / "config.yaml"), "--device", "cpu"]
    if how == "config":
        args.append("run.distributed=true")
    else:
        monkeypatch.setenv("MM2D3D_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="launcher's environment"):
        main(args)
    assert not dist.is_initialized()


def test_rendezvous_timeout_raises(monkeypatch):
    """Rank 0 of a world of two whose rank 1 never comes: an error at the
    timeout, no run alone."""
    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(ddp_check.free_port())}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(Exception, match="(?i)time"):
        mesh.init_process_group("cpu", timeout_s=3)
    mesh.destroy_process_group()
    assert not dist.is_initialized()


def test_backend_follows_the_layout(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("WORLD_SIZE", "4")
    cuda = torch.device("cuda", 0)
    assert mesh.backend_for(torch.device("cpu")) == "gloo"
    for local, backend in (("1", "nccl"), ("2", "nccl"), ("4", "gloo")):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
        assert mesh.backend_for(cuda) == backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for local_rank, index in (("0", 0), ("1", 1), ("3", 1)):
        monkeypatch.setenv("LOCAL_RANK", local_rank)
        assert mesh.rank_device("cuda") == torch.device("cuda", index)
    assert mesh.rank_device("cpu") == torch.device("cpu")
