"""Host ms in the program's `backward` span (the caller's time in `total.backward()`) per train call, over the profiler-off window."""

from core.spans import span_ms


def read(rec):
    return span_ms(rec, "train", "backward")
