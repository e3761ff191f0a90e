"""Milliseconds a call spends enqueueing its batches' device work
(``batch.enqueue``: ``run_plan``'s pool fills, slot uploads and group
launches), per call of the window.  Nothing where the program recorded
no span (an untraced run)."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.duration_ms(run, "batch.enqueue")
