"""Experiment logging (port of `mm2d3d_tpu/utils/logging.py`): stdout and a
JSONL file always, W&B and MLflow where a config's `logging:` section asks
for them, behind one `LoggerCollection`; scalars, hyperparameters, artifacts
and qualitative figures (`log_image`: a PNG's path, one line on stdout,
``{"step", "image": {name: path}}`` in the JSONL file).

The trackers' packages are imported when a logger is made; where one is
missing (or refuses, e.g. without credentials), `create_logger` prints
``<tracker> logging disabled: <reason>`` and goes on without it, as the
JAX package does.  Their run ids go to ``<out_dir>/run_id.yaml``, and a
resumed run re-attaches to them.  Process 0 alone logs.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import sys
import time
from typing import Any, Dict, List, Optional


def rank_zero() -> bool:
    """True on process 0 of a `torch.distributed` run, and on any
    single-process run: logging side effects happen there only."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class BaseLogger:
    name = "base"

    def log_metrics(self, metrics: Dict[str, float], step: int):  # pragma: no cover
        raise NotImplementedError

    def log_hyperparams(self, params: Dict[str, Any]):
        pass

    def log_artifacts(self, path: str):
        pass

    def log_image(self, name: str, path: str, step: int):
        """A qualitative figure, a PNG on disk."""
        pass

    def finish(self):
        pass

    @property
    def run_id(self) -> Optional[str]:
        return None


class StdoutLogger(BaseLogger):
    name = "stdout"

    def __init__(self, every_n: int = 50):
        self.every_n = every_n
        self._t0 = time.time()

    def log_metrics(self, metrics: Dict[str, float], step: int):
        if step % self.every_n == 0:
            parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
            print(f"[{time.time() - self._t0:8.1f}s] step {step}: {parts}", flush=True)

    def log_hyperparams(self, params: Dict[str, Any]):
        print("hyperparams:", json.dumps(params, default=str)[:2000], flush=True)

    def log_image(self, name: str, path: str, step: int):
        print(f"figure {name} @ step {step}: {path}", flush=True)


class JsonlLogger(BaseLogger):
    """Appends metrics to a JSONL file, the machine-readable sink."""

    name = "jsonl"

    def __init__(self, path: str):
        os.makedirs(osp.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log_metrics(self, metrics: Dict[str, float], step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")

    def log_image(self, name: str, path: str, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "image": {name: path}}) + "\n")


class WandbLogger(BaseLogger):
    name = "wandb"

    def __init__(self, project: str, run_name: str, tags=None, run_id=None):
        import wandb  # optional: the user's machine has it or this raises

        self._wandb = wandb
        self.run = wandb.init(project=project, name=run_name, tags=tags, id=run_id,
                              resume="allow" if run_id else None)

    def log_metrics(self, metrics, step):
        self.run.log(metrics, step=step)

    def log_hyperparams(self, params):
        self.run.config.update(params, allow_val_change=True)

    def log_artifacts(self, path):
        self.run.save(path)

    def log_image(self, name, path, step):
        self.run.log({name: self._wandb.Image(path)}, step=step)

    def finish(self):
        self.run.finish()

    @property
    def run_id(self):
        return self.run.id


class MLflowLogger(BaseLogger):
    name = "mlflow"

    def __init__(self, experiment_name: str, run_name: str, tags=None,
                 tracking_uri=None, run_id=None):
        import mlflow  # optional: the user's machine has it or this raises

        self._mlflow = mlflow
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment_name)
        self.run = mlflow.start_run(run_id=run_id, run_name=run_name, tags=tags)

    def log_metrics(self, metrics, step):
        self._mlflow.log_metrics(metrics, step=step)

    def log_hyperparams(self, params):
        self._mlflow.log_params({k: str(v)[:250] for k, v in params.items()})

    def log_artifacts(self, path):
        self._mlflow.log_artifacts(path)

    def log_image(self, name, path, step):
        # MLflow has no stepped image channel: one artifact folder per name
        self._mlflow.log_artifact(path, artifact_path=f"figures/{name}")

    def finish(self):
        self._mlflow.end_run()

    @property
    def run_id(self):
        return self.run.info.run_id


class LoggerCollection(BaseLogger):
    def __init__(self, loggers: List[BaseLogger]):
        self.loggers = loggers

    def log_metrics(self, metrics, step):
        metrics = {k: float(v) for k, v in metrics.items()}
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def log_hyperparams(self, params):
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def log_artifacts(self, path):
        for lg in self.loggers:
            lg.log_artifacts(path)

    def log_image(self, name, path, step):
        for lg in self.loggers:
            lg.log_image(name, path, step)

    def finish(self):
        for lg in self.loggers:
            lg.finish()

    @property
    def run_ids(self) -> Dict[str, str]:
        return {lg.name: lg.run_id for lg in self.loggers if lg.run_id}


def _tracker(name: str, make):
    """`make()`, or None after JAX's "<tracker> logging disabled" line where
    the tracker's package is missing or refuses."""
    try:
        return make()
    except Exception as e:  # a missing package, no credentials, a server
        print(f"{name} logging disabled: {e}", file=sys.stderr)
        return None


def create_logger(cfg: Optional[Dict], out_dir: str = ".",
                  resume: bool = False) -> LoggerCollection:
    """stdout, ``<out_dir>/metrics.jsonl`` and the trackers that `cfg` (the
    config's `logging:` section) names, on process 0; an empty collection
    elsewhere.  The trackers' run ids are written to
    ``<out_dir>/run_id.yaml``; with `resume`, the runs recorded there are
    re-attached."""
    import yaml

    if not rank_zero():
        return LoggerCollection([])
    run_id_path = osp.join(out_dir, "run_id.yaml")
    saved: Dict[str, str] = {}
    if resume and osp.exists(run_id_path):
        with open(run_id_path) as f:
            saved = yaml.safe_load(f) or {}

    loggers: List[BaseLogger] = [
        StdoutLogger(), JsonlLogger(osp.join(out_dir, "metrics.jsonl"))]
    cfg = cfg or {}
    if "wandb" in cfg:
        w = cfg["wandb"]
        loggers.append(_tracker("wandb", lambda: WandbLogger(
            project=w.get("project", "mm2d3d_tpu"), run_name=w.get("run_name", "run"),
            tags=w.get("tags"), run_id=saved.get("wandb"))))
    if "mlflow" in cfg:
        m = cfg["mlflow"]
        loggers.append(_tracker("mlflow", lambda: MLflowLogger(
            experiment_name=m.get("experiment_name", "mm2d3d_tpu"),
            run_name=m.get("run_name", "run"), tags=m.get("tags"),
            tracking_uri=m.get("tracking_uri"), run_id=saved.get("mlflow"))))

    collection = LoggerCollection([lg for lg in loggers if lg is not None])
    ids = collection.run_ids
    if ids:
        with open(run_id_path, "w") as f:
            yaml.safe_dump(ids, f)
    return collection


def snapshot_code(out_dir: str, repo_root: str) -> Optional[str]:
    """Copy the package source into ``<out_dir>/code_snapshot`` for
    provenance (process 0 only)."""
    if not rank_zero():
        return None
    dst = osp.join(out_dir, "code_snapshot")
    src = osp.join(repo_root, "mm2d3d_tpu_torch")
    if osp.isdir(src):
        shutil.copytree(src, osp.join(dst, "mm2d3d_tpu_torch"), dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dst
