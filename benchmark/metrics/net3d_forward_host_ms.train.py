"""Host ms in the program's `net3d` span (both domains' 3D forwards) per train call, over the profiler-off window."""

from core.spans import span_ms


def read(rec):
    return span_ms(rec, "train", "net3d")
