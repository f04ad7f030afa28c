"""Scans of both domains completed in the window over its length (train cells)."""

from core.readers import scans_per_s


def read(rec):
    return scans_per_s(rec, "train")
