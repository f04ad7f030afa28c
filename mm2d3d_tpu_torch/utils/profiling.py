"""The port's spans and counters, and its profiler trace (port of
`mm2d3d_tpu/utils/profiling.py`).

- `call(kind)`: one train or eval call (`MM2D3DTask.train_step`,
  `eval_step`, `Trainer.fit`'s step); its record holds the host ns of
  each span in it and the counters.  A call opened inside an open call
  joins it.  Records of the calls that ended go into a ring of the last
  `RING` calls, read by `records(kind)` in call order.
- `span(name)`: host ns of the block (`time.perf_counter_ns`, never a
  synchronise), added to the open call's record under `name`, summed over
  the name's uses in the call.  While a `torch.profiler` session records,
  the block is also the profiler range ``mm2d3d/<name>``, on the clock of
  the device activities, so an idle gap that opens inside it carries its
  name.  Outside a call it does nothing.
- `SyncCounter`, `count_syncs`: blocking host-device waits of the calling
  thread, through CUDA sync debug mode.  A call counts its own
  (`host_syncs`) only while a profiler records, since the mode is
  process-wide and costs time; elsewhere the record holds None.
- `trace`: a context manager around `torch.profiler` (CPU, and the CUDA
  device where there is one) that writes a Chrome trace,
  ``<out_dir>/trace.json``.

The train step's spans: `step`, `prepare`, `topology` (and its phases
`topology/voxelize`, `topology/coarsen`, `topology/neighbours`,
`topology/slots`), `net2d`, `net3d`, `losses`, `backward`, `optimizer`,
`logs`; the eval step's: `step`, `prepare`, `topology` (and phases),
`net2d`, `net3d`, `metrics`; `Trainer.fit` adds `fit/loader_wait`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import os.path as osp
import threading
import time
import warnings
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

PREFIX = "mm2d3d/"
RING = 4096
# how the warning CUDA sync debug mode raises at each blocking wait begins
# (the mode's own notice that it is a prototype, raised once, is not one)
SYNC_WARNING = "called a synchronizing CUDA operation"

_ring: "collections.deque[Dict]" = collections.deque(maxlen=RING)
_open = threading.local()  # .rec: the open call's record on this thread
_clock = time.perf_counter_ns


def records(kind: str) -> List[Dict]:
    """The ring's records of `kind` ("train" or "eval"), oldest first: each
    {"kind", "spans": {name: host ns}, "host_syncs": int or None}."""
    return [r for r in list(_ring) if r["kind"] == kind]


class SyncCounter:
    """Counts the blocking host-device waits the entering thread makes in
    the block (`n`).  CUDA sync debug mode turns each wait into a warning,
    raised on the thread that waited; the counter takes those of its own
    thread and hands every other warning, another thread's waits included,
    to the handler that was there.  The mode and the handler are restored
    on exit."""

    def __init__(self):
        self.n = 0

    def __enter__(self) -> "SyncCounter":
        self._thread = threading.get_ident()
        self._mode = torch.cuda.get_sync_debug_mode()
        self._show = warnings.showwarning
        # every wait, not once per line of Python (the default action)
        warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
        self._filter = warnings.filters[0]
        warnings.showwarning = self._seen
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _seen(self, message, category, filename, lineno, file=None, line=None):
        if threading.get_ident() == self._thread and str(message).startswith(SYNC_WARNING):
            self.n += 1
        else:
            self._show(message, category, filename, lineno, file, line)

    def __exit__(self, *exc) -> bool:
        torch.cuda.set_sync_debug_mode(self._mode)
        warnings.showwarning = self._show
        with contextlib.suppress(ValueError):
            warnings.filters.remove(self._filter)
        return False


def count_syncs(fn) -> int:
    """Host-device synchronisations one call of `fn` makes."""
    with SyncCounter() as counter:
        fn()
    return counter.n


class call:
    """One train or eval call's record (see the module docstring); the
    `with` statement yields the record."""

    __slots__ = ("kind", "rec", "_joined", "_syncs")

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self) -> Dict:
        outer = getattr(_open, "rec", None)
        self._joined = outer is not None
        if self._joined:
            self.rec = outer
            return outer
        self.rec = {"kind": self.kind, "spans": {}, "host_syncs": None}
        self._syncs = None
        if _autograd_profiler._is_profiler_enabled and torch.cuda.is_available():
            self._syncs = SyncCounter().__enter__()
        _open.rec = self.rec
        return self.rec

    def __exit__(self, exc_type, *exc) -> bool:
        if self._joined:
            return False
        _open.rec = None
        if self._syncs is not None:
            self._syncs.__exit__(exc_type, *exc)
            self.rec["host_syncs"] = self._syncs.n
        if exc_type is None:
            _ring.append(self.rec)
        return False


def step(kind: str):
    """Decorator: each call of the method is one `call(kind)`, its whole
    body the span `step`."""

    def wrap(fn):
        @functools.wraps(fn)
        def stepped(*args, **kwargs):
            with call(kind), span("step"):
                return fn(*args, **kwargs)

        return stepped

    return wrap


class span:
    """Host ns of the block into the open call's record (see the module
    docstring)."""

    __slots__ = ("name", "_spans", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        rec = getattr(_open, "rec", None)
        self._spans = None if rec is None else rec["spans"]
        if rec is not None:
            self._range = None
            if _autograd_profiler._is_profiler_enabled:
                self._range = record_function(PREFIX + self.name)
                self._range.__enter__()
            self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        spans = self._spans
        if spans is not None:
            dt = _clock() - self._t0
            if self._range is not None:
                self._range.__exit__(exc_type, exc, tb)
            spans[self.name] = spans.get(self.name, 0) + dt
        return False


@contextlib.contextmanager
def trace(out_dir: str):
    """Profile the block into ``<out_dir>/trace.json`` (Chrome trace
    format, the ``mm2d3d/`` span ranges included); yields the profiler
    (`key_averages()` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(out_dir, "trace.json"))
