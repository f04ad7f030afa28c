"""Blocking host-device waits (the program's `host_syncs` counter, CUDA sync debug mode) of the median traced eval call."""

from core.spans import syncs_per_call


def read(rec):
    return syncs_per_call(rec, "eval")
