"""Field batches an ``edismax`` call makes (its ``score_batch_device``
calls): the ``field_batches`` counts of the ``composer.edismax`` spans
that start in the window, summed, over the number of those spans.
Nothing where the program recorded no such span (an untraced run) or
does not count them (a port from before the count)."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    lo, hi = run.window
    calls = [s for s in got if s.name == "composer.edismax" and
             lo <= s.start_ns < hi]
    if not any("field_batches" in s.counts for s in calls):
        return None
    return sum(s.counts.get("field_batches", 0) for s in calls) / len(calls)
