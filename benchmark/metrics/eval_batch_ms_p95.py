"""The 95th percentile of the window's per-batch latencies, CUDA events from the call to the end of its work (eval cells)."""

import numpy as np


def read(rec):
    if rec["kind"] != "eval" or not rec["latency_ms"]:
        return None
    return float(np.percentile(rec["latency_ms"], 95))
