"""`BENCHMARK.json`: its checks, and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric is
found by its name: `configs[].file`; `benchmark/workloads/<traffic>.json`;
`benchmark/limits/<cell>.json` (the limits of the numbers that decide
`correct`); `benchmark/metrics/<metric>.py` (the reader of one metric, end
to end or per layer).  Adding one of them is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text, what: str) -> List[str]:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text \
            or "\t" in text:
        return [f"{what}: 1 to 200 characters on one line, no tab"]
    return []


def problems(man: Dict, root: str = ROOT) -> List[str]:
    """Every way `man` breaks the rules of the format (empty if none)."""
    out = []
    if set(man) != KEYS:
        out.append(f"keys {sorted(man)} != {sorted(KEYS)}")
        return out
    cmd, paths = man["command"], man["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        out.append("command: a list of 1 to 32 strings")
    for w in cmd:
        out += _line(w, f"command word {w!r}")
        if isinstance(w, str) and (w.startswith("/") or ".." in w.split("/")):
            out.append(f"command word {w!r} leaves the checkout")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        out.append("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    if not (isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51):
        out.append("run_seconds: a whole number from 1 to 51")

    def under_paths(f: str) -> bool:
        return any(f == p or f.startswith(p.rstrip("/") + "/") for p in paths)

    for w in cmd[1:]:
        if "/" in w and not under_paths(w):
            out.append(f"command names {w!r} outside paths")

    names = set()

    def named(entry: Dict, keys: set, what: str, extra=()):
        if not keys <= set(entry) or set(entry) - keys - set(extra):
            out.append(f"{what} {entry.get('name')!r}: keys {sorted(entry)}")
        n = entry.get("name", "")
        if not isinstance(n, str) or not NAME.match(n):
            out.append(f"{what} name {n!r}")
        if n in names:
            out.append(f"{what} name {n!r} is used twice")
        names.add(n)

    configs = {}
    if not 1 <= len(man["configs"]) <= 24:
        out.append("configs: 1 to 24")
    for c in man["configs"]:
        named(c, CONFIG_KEYS, "config")
        configs[c.get("name")] = c
        out += _line(c.get("source"), f"config {c.get('name')} source")
        out += _line(c.get("why"), f"config {c.get('name')} why")
        if not under_paths(c.get("file", "")) or not os.path.exists(
                os.path.join(root, c.get("file", ""))):
            out.append(f"config {c.get('name')}: file {c.get('file')!r} missing or "
                       "outside paths")
        red = c.get("reduced", [])
        if len(red) > 16 or any(not NAME.match(k) for k in red):
            out.append(f"config {c.get('name')}: reduced {red}")
    if len({c.get("file") for c in man["configs"]}) != len(man["configs"]):
        out.append("two configs share a file")

    cells = {}
    pairs = set()
    if not 1 <= len(man["workloads"]) <= 24:
        out.append("workloads: 1 to 24")
    for w in man["workloads"]:
        named(w, CELL_KEYS, "workload")
        cells[w.get("name")] = w
        out += _line(w.get("why"), f"workload {w.get('name')} why")
        if w.get("config") not in configs:
            out.append(f"workload {w.get('name')}: unknown config {w.get('config')!r}")
        if not NAME.match(str(w.get("traffic", ""))):
            out.append(f"workload {w.get('name')}: traffic {w.get('traffic')!r}")
        elif not os.path.exists(traffic_file(w["traffic"], root)):
            out.append(f"workload {w.get('name')}: no mix file for {w['traffic']!r}")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips 1 or 4")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"workload {w.get('name')}: config and traffic used twice")
        pairs.add(pair)
    four = sum(w.get("chips") == 4 for w in man["workloads"])
    if four > max(1, len(man["workloads"]) // 4):
        out.append("too many four-chip cells")
    for c in configs:
        if not any(w.get("config") == c for w in man["workloads"]):
            out.append(f"config {c} has no cell")

    e2e = {}
    if not 1 <= len(man["end_to_end"]) <= 16:
        out.append("end_to_end: 1 to 16")
    for m in man["end_to_end"]:
        named(m, E2E_KEYS, "metric", extra=("workloads",))
        e2e[m.get("name")] = m
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"metric {m.get('name')}: end-to-end source {m.get('source')!r}")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            out.append(f"metric {m.get('name')}: bound {b!r}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    if not 1 <= len(man["per_layer"]) <= 128:
        out.append("per_layer: 1 to 128")
    for m in man["per_layer"]:
        named(m, LAYER_KEYS, "metric", extra=("workloads",))
        out += _line(m.get("layer"), f"metric {m.get('name')} layer")
        if m.get("source") not in ("device_trace", "program_span", "program_counter",
                                   "host_clock"):
            out.append(f"metric {m.get('name')}: source {m.get('source')!r}")
        if m.get("moves") not in e2e:
            out.append(f"metric {m.get('name')}: moves {m.get('moves')!r}")
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(str(m.get("unit", ""))):
            out.append(f"metric {m.get('name')}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m.get('name')}: better {m.get('better')!r}")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"metric {m.get('name')}: unknown cell {c!r}")
        if not os.path.exists(metric_file(m.get("name", ""), root)):
            out.append(f"metric {m.get('name')}: no reader")
    for m in man["per_layer"]:
        moved = e2e.get(m.get("moves"))
        for c in m.get("workloads", list(cells)):
            if moved is not None and not applies(moved, c):
                out.append(f"metric {m['name']}: cell {c} does not report {m['moves']}")
    for c in cells:
        mine = [m for m in man["end_to_end"] if applies(m, c)]
        if len(mine) < 2 or not any(applies(m, c) for m in man["per_layer"]):
            out.append(f"cell {c}: needs setup_s, another end-to-end metric and a "
                       "per-layer metric")
        if not os.path.exists(limits_file(c, root)):
            out.append(f"cell {c}: no limits file")
    if len(json.dumps(man, indent=1)) > 64 * 1024:
        out.append("larger than 64 KiB")
    return out


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def traffic_file(traffic: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "workloads", f"{traffic}.json")


def metric_file(metric: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "metrics", f"{metric}.py")


def limits_file(cell: str, root: str = ROOT) -> str:
    return os.path.join(root, "benchmark", "limits", f"{cell}.json")


def load(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    bad = problems(man, root)
    if bad:
        raise ValueError("BENCHMARK.json: " + "; ".join(bad))
    return man


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def reader(metric: str, root: str = ROOT):
    """The `read(record)` function of `benchmark/metrics/<metric>.py`."""
    path = metric_file(metric, root)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(man: Dict, cell_name: str, root: str = ROOT) -> Dict:
    """Everything one cell's run needs, found by name."""
    cells = {w["name"]: w for w in man["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    limits_path = limits_file(cell_name, root)
    limits = _json(limits_path) if os.path.exists(limits_path) else {}
    return {
        "root": root,
        "cell": cell,
        "config": _json(os.path.join(root, conf["file"])),
        "mix": _json(traffic_file(cell["traffic"], root)),
        "limits": limits.get("limits"),
        "not_compared": sorted(limits.get("not_compared", {})),
        "end_to_end": [m for m in man["end_to_end"] if applies(m, cell_name)],
        "per_layer": [m for m in man["per_layer"] if applies(m, cell_name)],
    }
