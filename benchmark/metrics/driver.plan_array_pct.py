"""Share of the distinct queries the window's plans classified that the
batch driver's array pass took (the resolved single-term queries):
100 (1 - plan_loop_rows / plan_rows), counted by ``batch._classify`` on
the ``batch.plan`` spans.  Nothing where no plan classified a query, the
program recorded no span (an untraced run), or it does not count them."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.hit_pct(run, "plan_rows", "plan_loop_rows")
