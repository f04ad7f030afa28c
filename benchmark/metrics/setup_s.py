"""Seconds from process start to the first timed call: imports, the kernel build or load, weights, the pool, the warm-up calls."""

def read(rec):
    return rec["setup_s"]
