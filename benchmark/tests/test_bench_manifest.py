"""BENCHMARK.json against its format's rules, and the harness finding every file
by the names it gives."""

import copy
import json
import shutil

import pytest

from conftest import BENCH, HELD_OUT, tiny_spec
from core import manifest


def test_manifest_has_no_problems(manifest_data):
    assert manifest.problems(manifest_data) == []


def test_held_out_cells_are_not_in_the_committed_manifest():
    man = manifest.load()
    with open(HELD_OUT) as f:
        held = json.load(f)
    assert manifest.problems(man) == []
    for key in ("workloads", "end_to_end", "per_layer"):
        assert not {e["name"] for e in man[key]} & {e["name"] for e in held[key]}


@pytest.mark.parametrize("edit, fragment", [
    (lambda m: m["workloads"][0].update(name="bad name"), "workload name"),
    (lambda m: m["end_to_end"][1].update(unit="scans per s"), "unit"),
    (lambda m: m["per_layer"][0].update(moves="eval_batch_ms_p95"), "does not report"),
    (lambda m: m["per_layer"][0].update(name="no_such_reader"), "no reader"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["workloads"][0].update(traffic="no_such_mix"), "no mix file"),
    (lambda m: m["workloads"][1].update(config="nusc_usa_sing",
                                        traffic="train_b16"), "used twice"),
    (lambda m: m["per_layer"][0].update(why="extra key"), "keys"),
    (lambda m: m.update(run_seconds=52), "run_seconds"),
    (lambda m: m["end_to_end"][1].update(name="setup_s"), "used twice"),
])
def test_manifest_refuses(manifest_data, edit, fragment):
    man = copy.deepcopy(manifest_data)
    edit(man)
    assert any(fragment in p for p in manifest.problems(man)), manifest.problems(man)


def test_every_cell_finds_its_files(manifest_data):
    for cell in manifest_data["workloads"]:
        spec = manifest.cell_spec(manifest_data, cell["name"])
        assert spec["mix"]["kind"] in ("train", "eval")
        assert spec["limits"], cell["name"]
        assert spec["config"]["name"] == cell["config"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(manifest.reader(m["name"]))


def test_each_layer_metric_moves_a_metric_its_cells_report(manifest_data):
    e2e = {m["name"]: m for m in manifest_data["end_to_end"]}
    for m in manifest_data["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in manifest_data["workloads"]]):
            assert manifest.applies(e2e[m["moves"]], cell)


def test_a_cell_is_added_by_files_and_entries_alone(manifest_data, tmp_path):
    """A throwaway cell, mix, limits and per-layer metric, added as new files
    plus entries in a copy: nothing already there is edited, and the harness
    finds and runs them."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    man = copy.deepcopy(manifest_data)
    (root / "benchmark" / "workloads" / "eval_b2_throwaway.json").write_text(json.dumps(
        {"kind": "eval", "loop": "closed", "batch_size": 2, "pool_batches": 2,
         "warm_calls": 1, "sample_rounds": 1, "traced_calls": 1}))
    (root / "benchmark" / "limits" / "nusc_usa_sing.throwaway.json").write_text(
        (root / "benchmark" / "limits" / "nusc_usa_sing.eval.json").read_text())
    (root / "benchmark" / "metrics" / "calls_throwaway.py").write_text(
        '"""Window calls."""\n\n\ndef read(rec):\n    return rec["calls"]\n')
    man["workloads"].append({"name": "nusc_usa_sing.throwaway", "config": "nusc_usa_sing",
                             "traffic": "eval_b2_throwaway", "chips": 1,
                             "why": "a throwaway cell of the test"})
    for m in man["end_to_end"]:
        if "eval_batch_ms_p95" == m["name"]:
            m["workloads"].append("nusc_usa_sing.throwaway")
    man["per_layer"].append({"name": "calls_throwaway", "unit": "calls", "better": "higher",
                             "source": "host_clock", "layer": "Step",
                             "moves": "eval_batch_ms_p95",
                             "workloads": ["nusc_usa_sing.throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man, str(root)) == []
    spec = manifest.cell_spec(man, "nusc_usa_sing.throwaway", str(root))
    assert spec["mix"]["batch_size"] == 2
    assert [m["name"] for m in spec["per_layer"]] == ["calls_throwaway"]
    assert manifest.reader("calls_throwaway", str(root))({"calls": 7}) == 7
    after = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
             if p.is_file() and p in before}
    assert after == before

    from core.main import execute

    small = tiny_spec(man, "nusc_usa_sing.eval")
    small["mix"] = dict(spec["mix"])
    result, _ = execute(small, 11, 0.2, False, "cpu", 0.0)
    assert result["attempted"] >= 1
