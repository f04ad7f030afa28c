"""torch.cuda.max_memory_allocated over the window, after reset_peak_memory_stats, in GiB."""

def read(rec):
    return None if rec["peak_bytes"] is None else rec["peak_bytes"] / 2 ** 30
