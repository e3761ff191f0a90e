"""Share of the tf pool rows the window's plans requested that were
resident: 100 (1 - tf_fills / tf_rows), counted by ``dense.reserve``
on the ``batch.plan`` spans.  Nothing where no plan requested a tf
row, or the program recorded no span."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.hit_pct(run, "tf_rows", "tf_fills")
