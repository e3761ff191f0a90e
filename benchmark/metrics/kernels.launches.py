"""CUDA kernels the device ran per call in the traced window (the
profiler's kernel events; copies and memsets not counted)."""


def read(run):
    if run.timeline is None or not run.calls:
        return None
    lo, hi = run.window
    n = sum(1 for o in run.timeline.kernels if lo <= o.start < hi)
    return n / run.n_calls
