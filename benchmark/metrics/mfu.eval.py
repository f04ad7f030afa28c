"""Model FLOPs of the eval calls of the profiler-off window over its length and the bf16 peak (989 TFLOP/s), in %."""

from core.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, "eval")
