"""Host ms in the program's `optimizer` span (zero_grad, both AdamW steps, both schedules) per train call, over the profiler-off window."""

from core.spans import span_ms


def read(rec):
    return span_ms(rec, "train", "optimizer")
