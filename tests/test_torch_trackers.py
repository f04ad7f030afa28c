"""The W&B and MLflow loggers and `tools/mlflow_ops.py` of mm2d3d_tpu_torch
against the JAX package's, through recording stub modules.

Neither machine has `wandb` or `mlflow`, so each test puts a stub module per
tracker into `sys.modules` that records every call with its arguments and
returns made-up run ids.  Both packages, driven alike, must make the same
calls: metrics, params, images, artifacts, finish, the run ids written to
``run_id.yaml`` and re-attached on resume, nothing on a process other than
0, and the same "<tracker> logging disabled" line where the package is
missing.  `mlflow_ops`' four subcommands likewise.
"""

import os
import os.path as osp
import re
import sys
import types

import numpy as np
import pytest
import yaml

import mm2d3d_tpu.tools.mlflow_ops as ops_jax
import mm2d3d_tpu.utils.logging as log_jax
import mm2d3d_tpu_torch.tools.mlflow_ops as ops
import mm2d3d_tpu_torch.utils.logging as log


class Tape(list):
    """The calls made into the stubs, in order: (name, args, kwargs)."""

    def rec(self, call, /, *args, **kwargs):
        self.append((call, args, kwargs))


def wandb_stub(tape: Tape) -> types.ModuleType:
    mod = types.ModuleType("wandb")

    class Config:
        def update(self, params, **kw):
            tape.rec("config.update", params, **kw)

    class Run:
        def __init__(self, id):
            self.id = id
            self.config = Config()

        def log(self, data, step=None):
            tape.rec("log", data, step=step)

        def save(self, path):
            tape.rec("save", path)

        def finish(self):
            tape.rec("finish")

    def init(**kw):
        tape.rec("init", **kw)
        return Run(kw.get("id") or "wandb-run-1")

    mod.init = init
    mod.Image = lambda path: ("Image", path)
    return mod


def mlflow_stub(tape: Tape, root: str) -> dict:
    """`mlflow` and `mlflow.tracking`; artifacts "download" from files the
    stub writes under `root`."""
    mod = types.ModuleType("mlflow")
    tracking = types.ModuleType("mlflow.tracking")
    state = {"uri": "file:./mlruns"}

    def rec(name, ret=None):
        def fn(*args, **kwargs):
            tape.rec(name, *args, **kwargs)
            return ret(*args, **kwargs) if callable(ret) else ret
        return fn

    def set_tracking_uri(uri):
        tape.rec("set_tracking_uri", uri)
        state["uri"] = uri

    def start_run(run_id=None, run_name=None, tags=None):
        tape.rec("start_run", run_id=run_id, run_name=run_name, tags=tags)
        return types.SimpleNamespace(info=types.SimpleNamespace(
            run_id=run_id or "mlflow-run-1"))

    def download(run_id, path, dst=None):
        out = osp.join(dst or osp.join(root, "cache"), run_id, path or "all")
        os.makedirs(osp.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(f"artifact {path} of {run_id}\nline 2\n"
                    + ("line 3 of a\n" if run_id.endswith("a") else ""))
        return out

    class MlflowClient:
        def __init__(self, tracking_uri=None):
            tape.rec("MlflowClient", tracking_uri=tracking_uri)

        log_artifact = staticmethod(rec("client.log_artifact"))
        download_artifacts = staticmethod(rec("client.download_artifacts", download))
        get_run = staticmethod(rec("client.get_run", lambda run_id: types.SimpleNamespace(
            info=types.SimpleNamespace(experiment_id="7"),
            data=types.SimpleNamespace(tags={"t": "1"}, params={"lr": "0.1"},
                                       metrics={"loss": 0.5, "iou": 0.3}))))
        get_experiment = staticmethod(rec("client.get_experiment",
                                          types.SimpleNamespace(name="exp")))
        get_experiment_by_name = staticmethod(rec("client.get_experiment_by_name"))
        create_experiment = staticmethod(rec("client.create_experiment", "11"))
        create_run = staticmethod(rec("client.create_run", types.SimpleNamespace(
            info=types.SimpleNamespace(run_id="new-run"))))
        log_param = staticmethod(rec("client.log_param"))
        get_metric_history = staticmethod(rec(
            "client.get_metric_history", lambda run_id, key: [
                types.SimpleNamespace(value=v, timestamp=100 + s, step=s)
                for s, v in enumerate((1.0, 0.5))]))
        log_metric = staticmethod(rec("client.log_metric"))
        log_artifacts = staticmethod(rec("client.log_artifacts"))
        set_terminated = staticmethod(rec("client.set_terminated"))

    mod.set_tracking_uri = set_tracking_uri
    mod.get_tracking_uri = lambda: state["uri"]
    mod.set_experiment = rec("set_experiment")
    mod.start_run = start_run
    for name in ("log_metrics", "log_params", "log_artifacts", "log_artifact",
                 "end_run"):
        setattr(mod, name, rec(name))
    tracking.MlflowClient = MlflowClient
    mod.tracking = tracking
    return {"mlflow": mod, "mlflow.tracking": tracking}


@pytest.fixture
def stubs(monkeypatch, tmp_path):
    """-> install(): fresh stub modules and their tape."""
    def install():
        tape = Tape()
        monkeypatch.setitem(sys.modules, "wandb", wandb_stub(tape))
        for name, mod in mlflow_stub(tape, str(tmp_path / "artifacts")).items():
            monkeypatch.setitem(sys.modules, name, mod)
        return tape
    return install


CFG = {"wandb": {"project": "p", "run_name": "r", "tags": ["train"]},
       "mlflow": {"experiment_name": "e", "run_name": "r", "tags": {"k": "v"},
                  "tracking_uri": "http://localhost:5000"}}


def drive(module, out_dir, cfg=CFG, resume=False):
    """One run's logging through `module.create_logger`."""
    os.makedirs(out_dir, exist_ok=True)
    lg = module.create_logger(cfg, out_dir=out_dir, resume=resume)
    lg.log_hyperparams({"config": "c.yaml", "long": "x" * 300, "lr": 0.01})
    lg.log_metrics({"train/loss": np.float32(1.5), "train/iou": 0.25}, 3)
    lg.log_image("val/figure", osp.join(out_dir, "f.png"), 4)
    lg.log_artifacts(out_dir)
    lg.finish()
    return lg


def _runs(stubs, tmp_path, seed_ids=None, **kw):
    """Both packages' `drive` in turn, each in a fresh `tmp_path / "run"`
    (holding `seed_ids` as run_id.yaml if given) -> {package: (tape,
    collection, run_id.yaml or None, metrics.jsonl)}."""
    import shutil

    out_dir = tmp_path / "run"
    out = {}
    for name, module in (("port", log), ("jax", log_jax)):
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        if seed_ids:
            with open(out_dir / "run_id.yaml", "w") as f:
                yaml.safe_dump(seed_ids, f)
        tape = stubs()
        lg = drive(module, str(out_dir), **kw)
        ids = out_dir / "run_id.yaml"
        jsonl = out_dir / "metrics.jsonl"
        out[name] = (tape, lg, yaml.safe_load(open(ids)) if ids.exists() else None,
                     open(jsonl).read() if jsonl.exists() else None)
    return out


@pytest.mark.parametrize("trackers", [("wandb",), ("mlflow",), ("wandb", "mlflow")])
def test_loggers_make_the_same_calls_as_jax(stubs, tmp_path, trackers):
    cfg = {k: CFG[k] for k in trackers}
    runs = _runs(stubs, tmp_path, cfg=cfg)
    (tape, lg, ids, jsonl), (tape_j, lg_j, ids_j, jsonl_j) = runs["port"], runs["jax"]
    assert tape == tape_j and len(tape) >= 6
    names = [c[0] for c in tape]
    assert {"wandb": "init", "mlflow": "set_tracking_uri"}[trackers[0]] == names[0]
    assert ("finish" in names) == ("wandb" in trackers)
    assert ("end_run" in names) == ("mlflow" in trackers)
    assert lg.run_ids == lg_j.run_ids == {k: f"{k}-run-1" for k in trackers}
    assert ids == ids_j == lg.run_ids  # run_id.yaml
    assert jsonl == jsonl_j  # the JSONL sink is written alike


@pytest.mark.parametrize("resume", [True, False])
def test_resume_reattaches_recorded_runs_as_jax(stubs, tmp_path, resume):
    runs = _runs(stubs, tmp_path, seed_ids={"wandb": "w-old", "mlflow": "m-old"},
                 resume=resume)
    (tape, lg, ids, _), (tape_j, _, ids_j, _) = runs["port"], runs["jax"]
    assert tape == tape_j and ids == ids_j == lg.run_ids
    init = next(c for c in tape if c[0] == "init")
    start = next(c for c in tape if c[0] == "start_run")
    if resume:
        assert init[2]["id"] == "w-old" and init[2]["resume"] == "allow"
        assert start[2]["run_id"] == "m-old"
        assert lg.run_ids == {"wandb": "w-old", "mlflow": "m-old"}
    else:
        assert init[2]["id"] is None and init[2]["resume"] is None
        assert start[2]["run_id"] is None
        assert lg.run_ids == {"wandb": "wandb-run-1", "mlflow": "mlflow-run-1"}


def test_only_process_0_logs(stubs, tmp_path, monkeypatch):
    """A process other than 0 (the port asks torch.distributed, JAX its
    process index) gets an empty collection: no tracker run, no file."""
    import jax
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    for tape, lg, ids, jsonl in _runs(stubs, tmp_path).values():
        assert tape == [] and lg.loggers == [] and lg.run_ids == {}
        assert ids is None and jsonl is None


@pytest.mark.parametrize("tracker", ["wandb", "mlflow"])
def test_missing_package_disables_the_tracker_as_jax(tmp_path, monkeypatch, capsys,
                                                     tracker):
    monkeypatch.setitem(sys.modules, tracker, None)  # import raises ImportError
    printed = {}
    for name, module in (("port", log), ("jax", log_jax)):
        lg = drive(module, str(tmp_path / name), cfg={tracker: CFG[tracker]})
        assert [type(x).__name__ for x in lg.loggers] == ["StdoutLogger", "JsonlLogger"]
        printed[name] = capsys.readouterr().err
        assert not osp.exists(tmp_path / name / "run_id.yaml")
    assert printed["port"] == printed["jax"]
    assert printed["port"].startswith(f"{tracker} logging disabled: ")


def _ops_args(tmp_path, name):
    out = str(tmp_path / name)
    return {
        "upload": ["upload", "--run-id", "R", "--path", "ckpt.pt", "--dest", "ckpts",
                   "--uri", "http://a"],
        "download": ["download", "--run-id", "R", "--path", "figures", "--out", out],
        "diff": ["diff", "--run-a", "ra", "--run-b", "rb", "--file", "cfg.yaml",
                 "--out", osp.join(out, "diff.html"), "--uri", "http://a"],
        "copy-run": ["copy-run", "--run-id", "R", "--src-uri", "http://a",
                     "--dst-uri", "http://b"],
    }


@pytest.mark.parametrize("cmd", ["upload", "download", "diff", "copy-run"])
def test_mlflow_ops_make_the_same_calls_as_jax(stubs, tmp_path, monkeypatch, capsys,
                                               cmd):
    tapes, printed = {}, {}
    for name, module in (("port", ops), ("jax", ops_jax)):
        tapes[name] = stubs()
        os.makedirs(tmp_path / name, exist_ok=True)
        argv = _ops_args(tmp_path, name)[cmd]
        if name == "port":
            module.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["mlflow_ops", *argv])
            module.main()
        printed[name] = capsys.readouterr().out.replace(str(tmp_path / name), "OUT")
        tapes[name] = [(n, tuple(str(a).replace(str(tmp_path / name), "OUT")
                                 for a in args), kw) for n, args, kw in tapes[name]]
    assert tapes["port"] == tapes["jax"] and tapes["port"]
    assert printed["port"] == printed["jax"]
    if cmd == "diff":
        # difflib numbers each table's anchors from a process-wide counter
        html = [re.sub(r"(from|to)\d+_", r"\1N_", open(tmp_path / n / "diff.html").read())
                for n in ("port", "jax")]
        assert html[0] == html[1] and "line&nbsp;3&nbsp;of&nbsp;a" in html[0]
    if cmd == "copy-run":
        logged = [c for c in tapes["port"] if c[0] == "client.log_metric"]
        assert len(logged) == 4  # two metrics, two points each
        assert printed["port"].strip() == "copied run R -> new-run"
    if cmd == "upload":
        # the tracking server is switched back afterwards
        assert [c[1] for c in tapes["port"] if c[0] == "set_tracking_uri"] == [
            ("http://a",), ("file:./mlruns",)]
