"""Shared set-up of the benchmark's own tests (CPU; those marked `cuda`
need a card and skip without one, decided inside a fixture)."""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


HELD_OUT = os.path.join(BENCH, "tests", "held_out_cells.json")


@pytest.fixture(scope="session")
def manifest_data():
    """`BENCHMARK.json` with the entries of `held_out_cells.json` added: the
    cells held out of the benchmark while the program fails on some of their
    seeds, so that the harness's paths for them stay under test."""
    import json

    from core import manifest

    man = manifest.load()
    with open(HELD_OUT) as f:
        held = json.load(f)
    for key in ("workloads", "end_to_end", "per_layer"):
        man[key] = man[key] + held[key]
    return man


def tiny_spec(man, cell: str, dtype: str = "float32"):
    """A cell's spec at a size the CPU can run: 48x64 images, 2 scans of
    8,192 points (fewer points per scan fill the coarse levels of the
    program's capacity plan), 3 pool entries; the program in `dtype`.  The
    `dense` slot profile: at 2 scans a batch the default profile's
    compacted tiers drop hits on some seeds (2 of 120 scans at 4 a batch),
    at 16 they hold."""
    from core import manifest

    spec = copy.deepcopy(manifest.cell_spec(man, cell))
    spec["config"]["data"].update(height=48, width=64, n_points=8192)
    spec["config"]["train"]["compute_dtype"] = dtype
    spec["config"]["train"]["slot_profile"] = "dense"
    spec["mix"]["batch_size"] = 2
    spec["mix"]["pool_pairs" if spec["mix"]["kind"] == "train" else "pool_batches"] = 3
    return spec
