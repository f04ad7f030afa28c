"""The least time of the traced calls' sparse convolutions (benchmark counts) over the device time of the kernels under them, in %."""

from core.readers import spconv_roofline_pct


def read(rec):
    return spconv_roofline_pct(rec, "eval")
