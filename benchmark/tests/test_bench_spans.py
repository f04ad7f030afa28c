"""The readers of the program's own spans and counters (`core/spans.py`,
`metrics/*_host_ms.*`, `metrics/host_syncs_per_*`): the window's and the
traced segment's records are the run's last calls, a program without the
records (an older commit) gives nothing, and a CPU run reads real spans."""

import pytest

from core import manifest, spans

SPANS = ("net2d_forward_host_ms", "net3d_forward_host_ms", "topology_coarsen_host_ms")
TRAIN = [f"{m}.train" for m in SPANS + ("backward_host_ms", "optimizer_host_ms")]
EVAL = [f"{m}.eval" for m in SPANS]


def _record(kind, ms, syncs=None):
    return {"kind": kind, "spans": {"net2d": int(ms * 1e6), "topology/coarsen": 1},
            "host_syncs": syncs}


@pytest.fixture
def program(monkeypatch):
    """The program's records replaced by a list the test fills."""
    from mm2d3d_tpu_torch.utils import profiling

    recs = []
    monkeypatch.setattr(profiling, "records",
                        lambda kind: [r for r in recs if r["kind"] == kind])
    return recs


def test_the_window_and_the_traced_calls_are_the_last_records(program):
    program += [_record("train", 100.0)] * 3  # warm-up
    program += [_record("eval", 7.0)]  # another kind between them
    program += [_record("train", ms) for ms in (2.0, 4.0)]  # window
    program += [_record("train", 50.0, s) for s in (5, 3, 4, 9)]  # traced
    rec = {"kind": "train", "calls": 2, "trace_pool_index": [0, 1, 2, 3]}
    assert manifest.reader("net2d_forward_host_ms.train")(rec) == pytest.approx(3.0)
    assert manifest.reader("host_syncs_per_step.train")(rec) == 4
    assert manifest.reader("net2d_forward_host_ms.eval")(rec) is None
    assert spans.span_ms(rec, "train", "losses") is None
    program[-1] = _record("train", 50.0, None)
    assert manifest.reader("host_syncs_per_step.train")(rec) is None
    assert spans.window({**rec, "calls": 20}, "train") is None  # fewer records


def test_a_program_without_records_gives_nothing(monkeypatch):
    from mm2d3d_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    rec = {"kind": "eval", "calls": 3, "trace_pool_index": [0]}
    for name in EVAL + ["host_syncs_per_batch.eval"]:
        assert manifest.reader(name)(rec) is None


def test_every_new_reader_is_listed_with_its_cells(manifest_data):
    listed = {m["name"]: m for m in manifest_data["per_layer"]}
    for name in TRAIN + ["host_syncs_per_step.train"]:
        assert listed[name]["workloads"] == ["nusc_usa_sing.train", "vkitti_skitti.train"]
    for name in EVAL + ["host_syncs_per_batch.eval"]:
        assert listed[name]["workloads"] == ["nusc_usa_sing.eval"]


def test_a_cpu_run_reads_the_programs_spans(manifest_data):
    """A tiny eval run on the CPU: the span readers read its window; the
    counter is off without CUDA, so its reader gives nothing."""
    from conftest import tiny_spec
    from core.cell import Run

    spec = tiny_spec(manifest_data, "nusc_usa_sing.eval")
    spec["mix"]["traced_calls"] = 2
    run = Run(spec, 2147483649, "cpu")
    run.setup()
    run.window(0.2, spans=True)
    run.traced(spec["mix"]["traced_calls"])
    rec = run.rec
    assert len(spans.window(rec, "eval")) == rec["calls"]
    assert len(spans.traced(rec, "eval")) == 2
    for name in EVAL:
        value = manifest.reader(name)(rec)
        assert isinstance(value, float) and value > 0, name
    assert manifest.reader("host_syncs_per_batch.eval")(rec) is None
    run.release()
