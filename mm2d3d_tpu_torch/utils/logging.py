"""Experiment logging (port of `mm2d3d_tpu/utils/logging.py`): stdout and a
JSONL file, behind one `LoggerCollection`; scalars, hyperparameters and
qualitative figures (`log_image`: a PNG's path, one line on stdout,
``{"step", "image": {name: path}}`` in the JSONL file).

W&B and MLflow are not ported: a `logging:` config that asks for either
raises.  Run ids are written to ``run_id.yaml`` only by those trackers, so
the port writes none.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
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

    def log_image(self, name: str, path: str, step: int):
        """A qualitative figure, a PNG on disk."""
        pass

    def finish(self):
        pass


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

    def log_image(self, name, path, step):
        for lg in self.loggers:
            lg.log_image(name, path, step)

    def finish(self):
        for lg in self.loggers:
            lg.finish()


def create_logger(cfg: Optional[Dict], out_dir: str = ".") -> LoggerCollection:
    """stdout + ``<out_dir>/metrics.jsonl`` on process 0; an empty collection
    elsewhere.  `cfg` is the config's `logging:` section."""
    cfg = cfg or {}
    trackers = sorted(k for k in cfg if k in ("wandb", "mlflow"))
    if trackers:
        raise NotImplementedError(
            f"logging to {', '.join(trackers)} is not ported to "
            "mm2d3d_tpu_torch; remove it from the config's logging section "
            "(stdout and metrics.jsonl are always written)")
    if not rank_zero():
        return LoggerCollection([])
    return LoggerCollection([
        StdoutLogger(),
        JsonlLogger(osp.join(out_dir, "metrics.jsonl")),
    ])


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
