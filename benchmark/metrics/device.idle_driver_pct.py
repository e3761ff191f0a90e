"""Share of the traced window in which no device operation runs while
the innermost open program span is the batch driver's planning, enqueue
or stream ordering (``batch.plan``, ``batch.enqueue``, ``batch.order``):
the device waiting on the driver's host work.  Nothing without a device
timeline or spans."""
import os

from benchmark.harness.registry import load_module
from benchmark.harness.trace import busy_intervals, idle_gaps

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    got = spans.window_spans(run)
    if run.timeline is None or got is None:
        return None
    lo, hi = run.window
    idle = idle_gaps(busy_intervals(run.timeline.ops, lo, hi), lo, hi)
    driver = spans.innermost_intervals(
        got, ("batch.plan", "batch.enqueue", "batch.order"), lo, hi)
    return 100.0 * spans.overlap_ns(idle, driver) / (hi - lo)
