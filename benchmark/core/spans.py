"""The program's own spans and counters (`mm2d3d_tpu_torch.utils.profiling`),
read back after a run.

The program keeps one record per `train_step` / `eval_step` call, in call
order: the host ns of each of its spans and its counters.  A run's calls of
one kind end with the window's `rec["calls"]` calls and then the traced
segment's `len(rec["trace_pool_index"])`; the warm-up calls come before
them.  Imported only inside the functions, as `program.py` imports the
program.  A program without the records (an older commit) gives None, so
each reader leaves its metric out.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def _records(rec: Dict, kind: str) -> Optional[List[Dict]]:
    """The run's last `calls + traced` records of `kind`, or None."""
    if rec["kind"] != kind:
        return None
    from mm2d3d_tpu_torch.utils import profiling

    read = getattr(profiling, "records", None)
    if read is None:
        return None
    n = rec["calls"] + len(rec.get("trace_pool_index", ()))
    out = read(kind)
    return out[-n:] if n and len(out) >= n else None


def window(rec: Dict, kind: str) -> Optional[List[Dict]]:
    """The records of the profiler-off window's calls."""
    out = _records(rec, kind)
    return None if out is None else out[:rec["calls"]]


def traced(rec: Dict, kind: str) -> Optional[List[Dict]]:
    """The records of the traced segment's calls."""
    out = _records(rec, kind)
    return None if out is None or not rec.get("trace_pool_index") else out[rec["calls"]:]


def span_ms(rec: Dict, kind: str, name: str) -> Optional[float]:
    """Host ms in span `name` per window call (None where no call has it)."""
    recs = window(rec, kind)
    if not recs or not any(name in r["spans"] for r in recs):
        return None
    return sum(r["spans"].get(name, 0) for r in recs) / len(recs) / 1e6


def syncs_per_call(rec: Dict, kind: str) -> Optional[int]:
    """The median (lower) of the traced calls' blocking host-device waits."""
    recs = traced(rec, kind)
    if not recs or any(r.get("host_syncs") is None for r in recs):
        return None
    return statistics.median_low(r["host_syncs"] for r in recs)
