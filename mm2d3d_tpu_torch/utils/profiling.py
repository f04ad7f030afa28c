"""Profiling hooks (port of `mm2d3d_tpu/utils/profiling.py`).

- `StepTimer`: rolling wall-clock medians per named phase, cheap enough for
  the hot loop; with a CUDA device it synchronises that device at both
  ends of a phase, so a phase's time is the device's work, not its enqueue.
- `trace`: a context manager around `torch.profiler` (CPU, and the CUDA
  device where there is one) that writes a Chrome trace,
  ``<out_dir>/trace.json``.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch


class StepTimer:
    """`device`: the task's device; a CUDA device is synchronised around
    each phase (the counterpart of the JAX package's `device_fence`)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = None if device is None else torch.device(device)
        self._acc: Dict[str, list] = defaultdict(list)

    def _fence(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._fence()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._fence()
            self._acc[name].append(time.perf_counter() - t0)

    def summary(self, reset: bool = True) -> Dict[str, float]:
        out = {f"time/{name}_ms": float(np.median(vals) * 1e3)
               for name, vals in self._acc.items()}
        if reset:
            self._acc.clear()
        return out


@contextlib.contextmanager
def trace(out_dir: str):
    """Profile the block into ``<out_dir>/trace.json`` (Chrome trace
    format); yields the profiler (`key_averages()` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(out_dir, "trace.json"))
