"""Host ms in the program's `topology/coarsen` span (the coarsen chain) per eval call, over the profiler-off window."""

from core.spans import span_ms


def read(rec):
    return span_ms(rec, "eval", "topology/coarsen")
