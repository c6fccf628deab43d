"""torch.cuda.max_memory_allocated over the window (reset at its start), GiB."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
