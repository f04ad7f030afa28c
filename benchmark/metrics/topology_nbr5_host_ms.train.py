"""Host ms in the program's `topology/nbr5` span (level 0's 125-neighbour table of a 5^3 stem, both builds) per train call, over the profiler-off window; nothing where the program builds no such table."""

from core.spans import span_ms


def read(rec):
    return span_ms(rec, "train", "topology/nbr5")
