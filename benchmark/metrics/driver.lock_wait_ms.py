"""Milliseconds a call waits for the index lock (``batch.lock_wait``:
``SlotMaps.held``, from entry to the lock, outermost holds), per call of
the window: the wait beside ``driver.hold_ms``'s hold, near nothing with
one client.  Nothing where the program recorded no span (an untraced
run)."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.duration_ms(run, "batch.lock_wait")
