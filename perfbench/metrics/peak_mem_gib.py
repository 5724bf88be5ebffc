"""peak_mem_gib (layer: device): torch.cuda.max_memory_allocated over the
window, after a reset at its start, in GiB."""

UNIT = "GiB"


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
