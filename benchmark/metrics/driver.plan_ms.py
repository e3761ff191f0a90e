"""Milliseconds a call spends planning its batches (``batch.plan``:
``plan_batch``'s dedup, classification, chunks, waves and pool
reservations), per call of the window.  Nothing where the program
recorded no span (an untraced run)."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.duration_ms(run, "batch.plan")
