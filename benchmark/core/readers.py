"""Helpers of the metric readers in `benchmark/metrics/`: each reader is
`read(record) -> value or None`, None where its cell has nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from .work import PEAK_FLOPS


def scans_per_s(rec: Dict, kind: str) -> Optional[float]:
    if rec["kind"] != kind:
        return None
    per_call = rec["batch_size"] * (2 if kind == "train" else 1)
    return rec["calls"] * per_call / rec["window_s"]


def mfu_pct(rec: Dict, kind: str) -> Optional[float]:
    """Model FLOPs of the window's calls (a train step as three forwards of
    both domains) over the window and the bf16 peak."""
    if rec["kind"] != kind or "work_pool" not in rec:
        return None
    passes = 3 if kind == "train" else 1
    flops = sum(rec["work_pool"][j]["flops"] for j in rec["window_pool_index"]) * passes
    return 100.0 * flops / rec["window_s"] / PEAK_FLOPS


def _traced(rec: Dict, kind: str) -> Optional[Dict]:
    trace = rec.get("trace")
    if rec["kind"] != kind or not trace:
        return None
    return trace


def per_traced_call(rec: Dict, kind: str, key: str, scale: float = 1.0):
    trace = _traced(rec, kind)
    if trace is None:
        return None
    n = len(rec["trace_pool_index"])
    value = trace["kernels"] if key == "kernels" else trace["device_s"].get(key)
    return None if value is None else value * scale / n


def device_idle_pct(rec: Dict, kind: str) -> Optional[float]:
    trace = _traced(rec, kind)
    if trace is None:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def spconv_roofline_pct(rec: Dict, kind: str) -> Optional[float]:
    """The least time of the traced calls' sparse convolutions over the
    device time of the kernels under the sparse-convolution calls."""
    trace = _traced(rec, kind)
    if trace is None or "work_pool" not in rec or not trace["device_s"].get("spconv"):
        return None
    least = sum(rec["work_pool"][j]["spconv_least_s"] for j in rec["trace_pool_index"])
    return 100.0 * least / trace["device_s"]["spconv"]


def topology_ms(rec: Dict, kind: str) -> Optional[float]:
    if rec["kind"] != kind or not rec.get("topology_s"):
        return None
    return 1e3 * sum(rec["topology_s"]) / rec["calls"]
