"""Share of the traced window in which no device operation runs: the union
of the profiler's kernel, copy and memset intervals against the window."""
from benchmark.harness.trace import busy_intervals


def read(run):
    if run.timeline is None:
        return None
    lo, hi = run.window
    busy = sum(e - s for s, e in busy_intervals(run.timeline.ops, lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))
