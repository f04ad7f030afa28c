"""1 - the union of the device activities' intervals over the traced window, in %."""

from core.readers import device_idle_pct


def read(rec):
    return device_idle_pct(rec, "train")
