"""Scans evaluated in the profiler-off window over its length (eval cells):
the eval rate, kept per layer beside `eval_batch_ms_p95`."""

from core.readers import scans_per_s


def read(rec):
    return scans_per_s(rec, "eval")
