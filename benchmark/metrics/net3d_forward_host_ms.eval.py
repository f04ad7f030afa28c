"""Host ms in the program's `net3d` span (the 3D forward) per eval call, over the profiler-off window."""

from core.spans import span_ms


def read(rec):
    return span_ms(rec, "eval", "net3d")
