"""The command without a card: it refuses, prints no result, and writes no
CPU number under a device metric's name."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "nusc_usa_sing.train", "--seed", "5", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_refuses_with_only_the_benchmark(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_cpu_run_reports_no_metric(manifest_data):
    from conftest import tiny_spec
    from core.main import execute

    result, lines = execute(tiny_spec(manifest_data, "nusc_usa_sing.eval"), 3, 0.2,
                            False, "cpu", 0.0)
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"
    assert lines[-1].startswith("check ")
    json.dumps(result)
