"""The port's spans and counters (`mm2d3d_tpu_torch/utils/profiling.py`), on
the CPU at the other tests' tiny sizes (m=8, 3 planes, full_scale 256,
32x48 images), and one test on the card.

A train and an eval step each leave one record holding every span the
steps name, nested spans within their parents and the topology's four
phases within `topology`; the ring keeps the last `RING` calls in order;
without a profiler no profiler range is entered and the sync mode is never
touched; under `torch.profiler` every span is an ``mm2d3d/<name>`` range,
nested as the spans are; the sync counter takes its own thread's waits
only and passes every other warning on; `Trainer.fit` logs each step's
spans and prints their medians.

No JAX here, so the card test runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling.py -q
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.tools.autotune import ListLoader
from mm2d3d_tpu_torch.train.trainer import Trainer
from mm2d3d_tpu_torch.utils import profiling
from mm2d3d_tpu_torch.utils.profiling import call, records, span

SMALL = dict(full_scale=256, num_planes=3, m=8)
BATCH = dict(batch_size=2, height=32, width=48, n_points=256, full_scale=256, wire=True)
PHASES = ("topology/voxelize", "topology/coarsen", "topology/neighbours", "topology/slots")
TRAIN = {"step", "prepare", "topology", *PHASES, "net2d", "net3d", "losses", "backward",
         "optimizer", "logs"}
EVAL = {"step", "prepare", "topology", *PHASES, "net2d", "net3d", "metrics"}
# each span -> the span it lies in
PARENT = {**{p: "topology" for p in PHASES},
          **{s: "step" for s in TRAIN | EVAL if s != "step" and s not in PHASES}}
SYNC = "called a synchronizing CUDA operation"


@pytest.fixture(scope="module")
def small():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    task.init_params(torch.Generator().manual_seed(0))
    src, trg = (make_batch(np.random.RandomState(s), **BATCH) for s in (0, 1))
    yield task, src, trg
    torch.set_num_threads(n)


def _train(task, src, trg):
    return task.train_step(src, trg, torch.Generator().manual_seed(0))


def _new_record(kind, fn):
    before = {id(r) for r in records(kind)}
    fn()
    new = [r for r in records(kind) if id(r) not in before]
    assert len(new) == 1
    return new[0]


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_a_step_leaves_one_record_with_every_span(small, kind):
    task, src, trg = small
    fn = (lambda: _train(task, src, trg)) if kind == "train" else (
        lambda: task.eval_step(src))
    rec = _new_record(kind, fn)
    assert rec["kind"] == kind and rec["host_syncs"] is None
    assert set(rec["spans"]) == (TRAIN if kind == "train" else EVAL)
    spans = rec["spans"]
    assert all(isinstance(ns, int) and ns > 0 for ns in spans.values())
    for name, parent in PARENT.items():
        if name in spans:
            assert spans[name] <= spans[parent], name
    assert sum(spans[p] for p in PHASES) <= spans["topology"]
    assert sum(v for k, v in spans.items() if PARENT.get(k) == "step") <= spans["step"]


def test_spans_outside_a_call_record_nothing(small):
    task, src, _ = small
    n = len(records("eval"))
    with span("step"):
        task.forward(src)
    assert len(records("eval")) == n


def test_the_ring_keeps_the_last_calls_in_order():
    for i in range(profiling.RING + 5):
        with call("eval") as rec:
            rec["i"] = i
            with span("a"), span("b"):
                pass
    got = [r["i"] for r in records("eval") if "i" in r]
    assert got == list(range(5, profiling.RING + 5))
    assert len(profiling._ring) == profiling.RING


def test_threads_keep_their_own_records():
    """Calls on 16 threads at once, the interpreter switching threads every
    microsecond: each record holds its own thread's span only."""
    import sys

    n_threads, n_calls = 16, 200

    def work(k):
        for _ in range(n_calls):
            with call("train") as rec, span(f"t{k}"):
                rec["thread"] = k

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    mine = [r for r in records("train") if "thread" in r][-n_threads * n_calls:]
    assert len(mine) == n_threads * n_calls
    assert all(list(r["spans"]) == [f"t{r['thread']}"] for r in mine)


def test_a_nested_call_joins_the_open_one_and_a_raising_call_is_dropped():
    with call("train") as outer:
        with call("eval") as inner, span("x"):
            pass
    assert inner is outer and outer["kind"] == "train" and "x" in outer["spans"]
    assert records("train")[-1] is outer
    n = len(records("train"))
    with pytest.raises(ValueError):
        with call("train"), span("y"):
            raise ValueError
    assert len(records("train")) == n


def test_no_profiler_no_range_and_no_sync_mode(small, monkeypatch):
    """The profiler-off path enters no `record_function` and never sets the
    sync mode, even where CUDA is there."""
    task, src, trg = small
    ranges, modes = [], []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function",
                        lambda *a: ranges.append(a) or real(*a))
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: modes.append(m))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes.append("get"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    train = _new_record("train", lambda: _train(task, src, trg))
    ev = _new_record("eval", lambda: task.eval_step(src))
    assert ranges == [] and modes == []
    assert train["host_syncs"] is None and ev["host_syncs"] is None


def _intervals(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == profiling.PREFIX + name]


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_under_the_profiler_every_span_is_a_range(small, kind):
    task, src, trg = small
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = _new_record(kind, (lambda: _train(task, src, trg)) if kind == "train"
                          else (lambda: task.eval_step(src)))
    names = TRAIN if kind == "train" else EVAL
    assert set(rec["spans"]) == names and rec["host_syncs"] is None  # no CUDA here
    (step,) = _intervals(prof, "step")
    for name in names - {"step"}:
        got = _intervals(prof, name)
        assert got, name
        outer = _intervals(prof, PARENT[name])
        for s, e in got:
            assert any(s0 <= s and e <= e1 for s0, e1 in outer), name
            assert step[0] <= s and e <= step[1], name
        # the range times the span's own block: about the span's ns
        assert sum(e - s for s, e in got) * 1e3 >= 0.5 * rec["spans"][name], name


@pytest.fixture
def sync_mode(monkeypatch):
    """The sync debug mode as a recorder: CPU builds of PyTorch have none."""
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


def test_the_sync_counter_counts_its_own_threads_waits_only(sync_mode):
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with profiling.SyncCounter() as counter:
            assert sync_mode[-1] == "warn"
            for _ in range(3):  # one line, three waits: each counts
                warnings.warn(SYNC)
            other = threading.Thread(target=lambda: warnings.warn(SYNC + " (other)"))
            other.start()
            other.join(timeout=30)
            assert not other.is_alive()
            warnings.warn("a warning of the step's own")
            # the mode's notice, raised once where it is first set
            warnings.warn("Synchronization debug mode is a prototype feature and does not "
                          "yet detect all synchronizing operations")
    assert counter.n == 3
    assert sync_mode[-1] == "default"
    assert sorted(str(w.message)[:20] for w in shown) == [
        "Synchronization debu", "a warning of the ste", SYNC[:20]]
    assert not any(f[0] == "always" and f[1] is not None
                   and f[1].pattern == profiling.SYNC_WARNING for f in warnings.filters)


def test_count_syncs_counts_one_call(sync_mode):
    assert profiling.count_syncs(lambda: [warnings.warn(SYNC) for _ in range(2)]) == 2


def test_a_call_under_the_profiler_counts_its_syncs(sync_mode, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with profile(activities=[ProfilerActivity.CPU]):
        with call("eval") as rec, span("x"):
            warnings.warn(SYNC)
            warnings.warn(SYNC)
    assert rec["host_syncs"] == 2 and sync_mode == ["default", "warn", "default"]
    with call("eval") as rec, pytest.warns(UserWarning, match="synchronizing"):
        warnings.warn(SYNC)  # no profiler: no counter, the warning goes on
    assert rec["host_syncs"] is None


class _Logger:
    def __init__(self):
        self.calls = []

    def log_metrics(self, metrics, step):
        self.calls.append((step, dict(metrics)))


def test_fit_logs_each_steps_spans(small, tmp_path, capsys):
    task, src, trg = small
    host = [make_batch(np.random.RandomState(s), **BATCH) for s in (2, 3)]
    logger = _Logger()
    trainer = Trainer(task, ListLoader(host, 3), ListLoader(host[::-1], 3),
                      ckpt_dir=str(tmp_path), logger=logger, limit_train_batches=3)
    trainer.initialized = True
    trainer.validate = lambda epoch: {}
    trainer.fit()
    logged = [(s, m) for s, m in logger.calls if "train/loss_total" in m]
    assert [s for s, _ in logged] == [1, 2, 3]
    for s, m in logged:
        times = {k for k in m if k.startswith("time/")}
        want = {f"time/{n}_ms" for n in TRAIN} | (
            {"time/fit/loader_wait_ms"} if s < 3 else set())  # the limit ends the epoch
        assert times == want, s
        assert all(m[k] >= 0 for k in times) and m["time/step_ms"] > 0
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("epoch 0")]
    assert len(line) == 1 and "median step" in line[0] and "median fit/loader_wait" in line[0]


@pytest.mark.cuda
def test_on_the_card_a_planted_item_counts_one():
    """Under the profiler a planted `.item()` inside a span counts 1; a
    flagship-sized bf16 `eval_step` reports its count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x = torch.ones(1024, device=dev)
    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    batch = make_batch(np.random.RandomState(0), batch_size=8, height=225, width=400,
                       n_points=8192, wire=True).to(dev)
    task.eval_step(batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with call("eval") as planted, span("planted"):
            x.sum().item()
        ev = _new_record("eval", lambda: task.eval_step(batch))
    assert planted["host_syncs"] == 1, planted
    assert isinstance(ev["host_syncs"], int) and set(ev["spans"]) == EVAL, ev
    print(f"flagship eval_step, batch 8: {ev['host_syncs']} host syncs")
