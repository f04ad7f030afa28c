"""Spans set from the benchmark's files, and the reading of a profiler trace.

Spans: `topology_spans` wraps the task's `build_topology` with a host clock
(and a profiler range); `layer_ranges` puts a profiler range, from module
hooks, around every forward of the 2D network, the 3D network and each of
its sparse convolutions.

Reading: every device activity (kernel, copy, set) is tied to the host op
that launched it (the profiler's correlation id).  A host op inside one of
the ranges above belongs to that layer; a backward op belongs to the layer
whose forward op carries the same autograd sequence number; the optimizer
steps are torch's own "Optimizer.step" ranges.  Busy time is the union of
the activities' intervals, idle gaps are the holes in it, each named after
what the host was doing when it opened.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

PREFIX = "bench/"
WINDOW = PREFIX + "window"
TOP = 10


@dataclass
class HostOp:
    name: str
    start: int  # ns
    end: int
    tid: int
    corr: int
    seq: int
    fwd_tid: int
    annotation: bool


@dataclass
class DeviceOp:
    name: str
    start: int  # ns
    end: int
    linked: int  # correlation id of the launching host op


def topology_spans(task, spans: List[float]):
    """Wrap `task.build_topology`: host seconds of each build into `spans`."""
    build = task.build_topology

    def timed(batch):
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + "topology"):
            out = build(batch)
        spans.append(time.perf_counter() - t0)
        return out

    task.build_topology = timed
    return lambda: delattr(task, "build_topology")


@contextlib.contextmanager
def layer_ranges(modules: Sequence[Tuple[torch.nn.Module, str]]):
    """A profiler range `bench/<label>` around each forward of each module."""
    handles = []
    for module, label in modules:
        stack = []

        def pre(mod, args, stack=stack, label=label):
            rf = torch.profiler.record_function(PREFIX + label)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out, stack=stack):
            stack.pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre),
                    module.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def events(prof) -> Tuple[List[HostOp], List[DeviceOp]]:
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(DeviceOp(e.name(), e.start_ns(), e.end_ns(),
                                    e.linked_correlation_id()))
        elif not e.is_async():
            host.append(HostOp(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                               e.correlation_id(), e.sequence_nr(), e.fwd_thread_id(),
                               e.is_user_annotation()))
    return host, dev


class _Intervals:
    """Disjoint or nested intervals of one kind on one thread."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: int):
        """The latest-starting interval that contains t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            if self.spans[j][0] <= t < self.spans[j][1]:
                return self.spans[j]
        return None


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _label_of(name: str) -> Optional[str]:
    if name.startswith(PREFIX) and name != WINDOW:
        return name[len(PREFIX):]
    if name.startswith("Optimizer.step"):
        return "optimizer"
    return None


def summarize(host: List[HostOp], dev: List[DeviceOp]) -> Dict:
    """Busy and window seconds, kernel count, device seconds by layer
    label, the share of device time with a label, and the breakdown."""
    window = [h for h in host if h.name == WINDOW]
    if not window or not dev:
        return {}
    w0, w1 = window[0].start, window[0].end
    by_corr = {h.corr: h for h in host}
    ranges = defaultdict(list)  # (tid, label) -> [(start, end)]
    nodes = defaultdict(list)  # tid -> backward nodes [(start, end, fwd_tid, seq)]
    ops = defaultdict(list)  # tid -> [(start, end, name)]
    for h in host:
        label = _label_of(h.name) if h.annotation else None
        if label:
            ranges[(h.tid, label)].append((h.start, h.end))
        elif h.name.startswith("autograd::engine::evaluate_function") and h.seq >= 0:
            nodes[h.tid].append((h.start, h.end, h.fwd_tid, h.seq))
        ops[h.tid].append((h.start, h.end, h.name))
    ranges = {k: _Intervals(v) for k, v in ranges.items()}
    nodes = {k: _Intervals(v) for k, v in nodes.items()}
    ops = {k: _Intervals(v) for k, v in ops.items()}
    labels_by_tid = defaultdict(list)
    for tid, label in ranges:
        labels_by_tid[tid].append(label)

    def labels_at(tid: int, t: int) -> frozenset:
        return frozenset(l for l in labels_by_tid.get(tid, ())
                         if ranges[(tid, l)].at(t) is not None)

    seq_labels = {}
    for h in host:
        if h.seq >= 0 and h.fwd_tid == 0:
            seq_labels[(h.tid, h.seq)] = labels_at(h.tid, h.start)

    def labels_of(op: Optional[HostOp]) -> frozenset:
        if op is None:
            return frozenset()
        out = labels_at(op.tid, op.start)
        node = nodes[op.tid].at(op.start) if op.tid in nodes else None
        if node is not None:
            out = out | seq_labels.get((node[2], node[3]), frozenset())
        return out

    device_s = defaultdict(float)
    by_name = defaultdict(float)
    total = labelled = 0.0
    kernels = 0
    intervals = []
    for d in dev:
        if d.end <= w0 or d.start >= w1:
            continue
        dur = (d.end - d.start) * 1e-9
        intervals.append((d.start, d.end))
        total += dur
        by_name[d.name] += dur
        if not d.name.startswith(("Memcpy", "Memset")):
            kernels += 1
        labs = labels_of(by_corr.get(d.linked))
        for lab in labs:
            device_s[lab] += dur
        if labs:
            labelled += dur
    busy = _union(intervals)
    busy_s = sum(e - s for s, e in busy) * 1e-9

    main_tid = window[0].tid
    gaps = []
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            gaps.append((s1 - e0, e0))
    gaps.sort(reverse=True)

    def host_doing(t: int) -> str:
        for tid, iv in nodes.items():
            node = iv.at(t)
            if node is not None:
                labs = sorted(seq_labels.get((node[2], node[3]), ()))
                return "backward " + (",".join(labs) or "other")
        labs = sorted(labels_at(main_tid, t))
        op = ops[main_tid].at(t) if main_tid in ops else None
        name = op[2] if op is not None else "host"
        return (",".join(labs) + ": " if labs else "") + name

    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "kernels": kernels,
        "device_s": dict(device_s),
        "device_total_s": total,
        "attributed_share": labelled / total if total else None,
        "breakdown": {
            "device_ops": [[n[:96], s] for n, s in
                           sorted(by_name.items(), key=lambda x: -x[1])[:TOP]],
            "idle_gaps": [[host_doing(t), g * 1e-9] for g, t in gaps[:TOP]],
        },
    }
