"""Device kernels in the trace per eval call."""

from core.readers import per_traced_call


def read(rec):
    return per_traced_call(rec, "eval", "kernels")
