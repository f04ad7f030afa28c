"""The port's host self-validation (`mm2d3d_tpu_torch/tools/autotune.py`)
vs the JAX tool, on the CPU at dryrun sizes.

The JAX tool decides inside its probes; here its probes run with their
device work and loaders stood in for and a scripted clock, so each JAX
decision comes from the JAX code on a table of timings, and the port's pure
rules must take it on the same times.  The port's probes then run on a
small CPU task, and `main` must refuse to run a device probe on the CPU.
"""

import json
import math
import os
import tempfile
import types
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import two_threads  # noqa: F401  (fixture)

import mm2d3d_tpu.data.host_topology as host_topology_jax
import mm2d3d_tpu.data.loader as loader_jax
import mm2d3d_tpu.native as native_jax
import mm2d3d_tpu.tools.autotune as autotune_jax
import mm2d3d_tpu.train.batch as batch_jax
import mm2d3d_tpu.train.trainer as trainer_jax
from mm2d3d_tpu_torch.data import host_topology
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.tools import autotune, doctor

SMALL = dict(full_scale=256, num_planes=3, m=8)
SCAN = dict(height=32, width=48, n_points=512, full_scale=256)


class _Clock:
    """A stand-in for the `time` module whose perf_counter() returns
    scripted readings."""

    def __init__(self, readings):
        self._readings = iter(readings)

    def perf_counter(self):
        return next(self._readings)


def _jax_workers(monkeypatch, rates):
    """The JAX probe_workers' decision on `rates` (worker count -> scans/s),
    and the unrounded rates it computed."""
    class OneScanLoader:
        def __init__(self, *args, **kwargs):
            pass

        def __iter__(self):
            yield types.SimpleNamespace(batch_size=1)

        def close(self):
            pass

    monkeypatch.setattr(loader_jax, "Loader", OneScanLoader)
    readings = [t for r in rates.values() for t in (0.0, 1.0 / r)]
    monkeypatch.setattr(autotune_jax, "time", _Clock(readings))
    _, rec = autotune_jax.probe_workers(1, worker_counts=tuple(int(w) for w in rates))
    return rec, {w: 1 / (1.0 / r - 0.0) for w, r in rates.items()}


def _jax_prefetch(monkeypatch, ms):
    class IdleTrainer:
        def __init__(self, task, **kwargs):
            pass

        def fit(self):
            pass

    monkeypatch.setattr(trainer_jax, "Trainer", IdleTrainer)
    readings = [t for v in ms.values() for t in (0.0, v / 1000)]
    monkeypatch.setattr(autotune_jax, "time", _Clock(readings))
    state0 = namedtuple("State", "opt2d")(np.zeros(1, np.float32))
    _, rec = autotune_jax.probe_prefetch(None, [None], state0, 1,
                                         depths=tuple(int(d) for d in ms))
    return rec, {d: (v / 1000 - 0.0) / 1 * 1000 for d, v in ms.items()}


def _jax_host_topology(monkeypatch, host_ms, device_ms):
    monkeypatch.setattr(native_jax, "available", lambda: True)
    monkeypatch.setattr(host_topology_jax, "topology_for_batch",
                        lambda b, fs, planes: (np.zeros(1, np.float32),))
    monkeypatch.setattr(batch_jax, "build_topology", lambda b, fs, planes: (b,))
    monkeypatch.setattr(autotune_jax, "time", _Clock(
        [0.0, device_ms / 1000, 0.0, host_ms / 1000]))

    def fwd(p, s, b, *rest):
        return {"seg_logit": b}, None, None, None

    task = types.SimpleNamespace(full_scale=1, num_planes=1, _fwd2d=fwd, _fwd3d=fwd)
    z = jnp.zeros(1)
    state = types.SimpleNamespace(params2d=z, params3d=z, stats2d=z, stats3d=z)
    ms, rec = autotune_jax.probe_host_topology(task, [None], [z], state, 1)
    return rec, ms


def test_synth_dataset_equals_jax():
    ours, ref = autotune.SynthDataset(), autotune_jax.SynthDataset()
    assert len(ours) == len(ref) == 64
    for i in (0, 7, 63):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("rates,want", [
    ({"0": 95.0, "2": 100.0, "4": 99.0}, None),  # on the 5% threshold
    ({"0": 94.9, "2": 100.0, "4": 100.0}, 2),  # below it; a tie goes to 2
    ({"0": 95.1, "2": 100.0, "4": 90.0}, 0),
    ({"0": 100.0, "2": 100.0, "4": 100.0}, 0),
    ({"0": 50.0, "2": 104.4, "4": 110.0}, 4),
    ({"0": 50.0, "2": 104.6, "4": 110.0}, 2),
])
def test_workers_rule_equals_jax(monkeypatch, rates, want):
    rec, seen = _jax_workers(monkeypatch, rates)
    assert autotune.workers_rule(seen) == rec["num_workers"]
    assert want is None or rec["num_workers"] == want


@pytest.mark.parametrize("ms,want", [
    ({"0": 103.0, "2": 100.0, "4": 101.0}, None),  # on the 3% threshold
    ({"0": 102.9, "2": 100.0, "4": 100.0}, 0),
    ({"0": 103.1, "2": 100.0, "4": 100.0}, 2),  # a tie goes to 2
    ({"0": 100.0, "2": 100.0, "4": 100.0}, 0),
    ({"0": 200.0, "2": 104.0, "4": 100.0}, 4),
])
def test_prefetch_rule_equals_jax(monkeypatch, ms, want):
    rec, seen = _jax_prefetch(monkeypatch, ms)
    assert autotune.prefetch_rule(seen) == rec["prefetch_batches"]
    assert want is None or rec["prefetch_batches"] == want


@pytest.mark.parametrize("host,device,want", [
    (95.0, 100.0, None),  # on the 0.95x threshold
    (94.9, 100.0, True),
    (95.1, 100.0, False),
    (100.0, 100.0, False),
    (150.0, 100.0, False),
    (10.0, 100.0, True),
])
def test_host_topology_rule_equals_jax(monkeypatch, host, device, want):
    rec, seen = _jax_host_topology(monkeypatch, host, device)
    assert autotune.host_topology_rule(seen) == rec["host_topology"]
    assert want is None or rec["host_topology"] == want


@pytest.fixture(scope="module")
def small(two_threads):  # noqa: F811
    task = flagship_task(device="cpu", compute_dtype=torch.float32, **SMALL)
    task.init_params(torch.Generator().manual_seed(0))
    return task, autotune.host_batches(batch_size=2, **SCAN)


def test_probe_host_topology_on_cpu(small):
    task, batches = small
    ms, rec = autotune.probe_host_topology(task, batches, batches, 2)
    assert set(ms) == {"host-topo", "device-topo"}
    assert all(math.isfinite(v) and v > 0 for v in ms.values())
    assert rec == {"host_topology": autotune.host_topology_rule(ms)}


def test_probe_host_topology_refuses_a_differing_forward(small, monkeypatch):
    """The warm forwards must agree bit for bit: a host topology of the
    other batch makes them differ."""
    task, batches = small
    build = host_topology.topology_for_batch
    monkeypatch.setattr(host_topology, "topology_for_batch",
                        lambda b, *a, **k: build(batches[1], *a, **k))
    with pytest.raises(AssertionError, match="differs"):
        autotune.probe_host_topology(task, batches, batches, 1)


def test_probe_prefetch_on_cpu(small):
    task, batches = small
    before = {k: v.clone() for k, v in task.model3d.state_dict().items()}
    step0 = task.step
    left = set(os.listdir(tempfile.gettempdir()))
    ms, rec = autotune.probe_prefetch(task, batches, 1, depths=(0, 2))
    assert set(ms) == {"0", "2"}
    assert all(math.isfinite(v) and v > 0 for v in ms.values())
    assert rec == {"prefetch_batches": autotune.prefetch_rule(ms)}
    assert rec["prefetch_batches"] in (0, 2)
    # the task is back in its state on entry, and no checkpoint dir is left
    assert task.step == step0
    assert all(torch.equal(v, before[k]) for k, v in task.model3d.state_dict().items())
    assert not {d for d in set(os.listdir(tempfile.gettempdir())) - left
                if d.startswith("mm2d3d_autotune_ck_")}


def _descendants():
    """Live processes below this one, from /proc."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            state, ppid = stat[stat.rfind(")") + 2:].split()[:2]
            if state != "Z":
                parent[int(d)] = int(ppid)
    out, frontier = set(), [os.getpid()]
    while frontier:
        pid = frontier.pop()
        kids = [c for c, pp in parent.items() if pp == pid]
        out.update(kids)
        frontier += kids
    return out


def test_probe_workers_leaves_no_process(two_threads):  # noqa: F811
    before = _descendants()
    rates, rec = autotune.probe_workers(1, worker_counts=(0, 2),
                                        dataset=autotune.SynthDataset(4),
                                        batch_size=2, n_points=1024)
    assert set(rates) == {"0", "2"}
    assert all(math.isfinite(v) and v > 0 for v in rates.values())
    assert rec["num_workers"] in (0, 2)
    assert not _descendants() - before


def test_doctor_perf_reaches_autotune(capsys):
    assert doctor.main(["--perf", "--skip", "donation", "host_topology", "prefetch",
                        "workers"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("autotune: backend=")
    assert json.loads(lines[-1]) == {"measured": {}, "recommended": {}}
    assert doctor.main(["--perf", "--iters", "2", "--skip", "host_topology",
                        "prefetch", "workers"]) == 0
    out = capsys.readouterr().out
    assert f"donation: {autotune.DONATION_NOTE}" in out and "iters=2" in out
    assert json.loads(out.strip().splitlines()[-1]) == {"measured": {}, "recommended": {}}


def test_main_refuses_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.main(["--iters", "1", "--skip", "workers", "host_topology"])
    assert "measured" not in capsys.readouterr().out
