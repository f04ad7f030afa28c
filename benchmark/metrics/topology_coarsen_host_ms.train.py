"""Host ms in the program's `topology/coarsen` span (the coarsen chain of both builds) per train call, over the profiler-off window."""

from core.spans import span_ms


def read(rec):
    return span_ms(rec, "train", "topology/coarsen")
