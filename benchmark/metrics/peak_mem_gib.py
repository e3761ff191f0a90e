"""Device bytes at their peak from the process's start to the window's
end (``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
