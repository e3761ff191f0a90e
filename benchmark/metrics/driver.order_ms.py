"""Milliseconds a call spends ordering the pools across streams
(``batch.order``: ``SlotMaps.held``'s wait on the last holder's CUDA
event on entry and the record of its own on exit, every hold), per call
of the window: the part of ``driver.hold_ms`` outside the plan and the
enqueue.  Nothing where the program recorded no span (an untraced run,
or an index off the card)."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.duration_ms(run, "batch.order")
