"""Share of the plane pool rows the window's plans requested that were
resident: 100 (1 - plane_fills / plane_rows), counted by ``dense.reserve``
on the ``batch.plan`` spans.  Nothing where no plan requested a plane
row, or the program recorded no span."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.hit_pct(run, "plane_rows", "plane_fills")
