"""Host ms in the program's `net2d` span (the 2D forward) per eval call, over the profiler-off window."""

from core.spans import span_ms


def read(rec):
    return span_ms(rec, "eval", "net2d")
