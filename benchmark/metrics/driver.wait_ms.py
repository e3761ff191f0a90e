"""Milliseconds a call's host spends blocked on the device
(``batch.wait``: the result copy's event in ``assemble``, the composer's
final copy, the facade's copies on the sharded path), per call of the
window.  Nothing where the program recorded no span (an untraced run)."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.duration_ms(run, "batch.wait")
