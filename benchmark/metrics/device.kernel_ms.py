"""Kernel device time per call in the traced window (the profiler's kernel
events, clipped to the window), in ms."""


def read(run):
    ks = run.kernel_seconds()
    return ks * 1e3 / run.n_calls if ks is not None and run.calls else None
