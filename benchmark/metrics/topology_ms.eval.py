"""Host ms in the benchmark's spans around the topology builds, per eval call, over the profiler-off window."""

from core.readers import topology_ms


def read(rec):
    return topology_ms(rec, "eval")
