"""Device kernels in the trace per train call."""

from core.readers import per_traced_call


def read(rec):
    return per_traced_call(rec, "train", "kernels")
