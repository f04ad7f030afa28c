"""Device ms per eval call of the kernels the trace puts under the 2D network (its forward, and the backward ops of its forward ops)."""

from core.readers import per_traced_call


def read(rec):
    return per_traced_call(rec, "eval", "net2d", 1e3)
