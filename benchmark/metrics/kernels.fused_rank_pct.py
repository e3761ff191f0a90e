"""Share of the rows the window's ranked groups ranked by the fused pass
(the similarity computed inside K3's tile pass, no score block stored):
100 (1 - ranked_unfused_rows / ranked_rows), both summed over the
``batch.enqueue`` spans that start in the window, where the batch driver
counts them (``dense.count_ranked``).  Nothing where no group was
ranked, the program recorded no span (an untraced run), or it does not
count them (a port from before the fused pass)."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    got = spans.window_spans(run)
    if got is None:
        return None
    lo, hi = run.window
    runs = [s for s in got if s.name == "batch.enqueue" and
            lo <= s.start_ns < hi]
    ranked = sum(s.counts.get("ranked_rows", 0) for s in runs)
    if not ranked:
        return None
    unfused = sum(s.counts.get("ranked_unfused_rows", 0) for s in runs)
    return 100.0 * (1.0 - unfused / ranked)
