"""Self time of the composer's spans (``composer.edismax`` and its
``composer.phases``: parsing, compositions, phase folds, the ranking's
launch) per call of the window, in ms: the inside
twin of ``composer.host_ms``, without the field batches and the waits.
Nothing where the program recorded no composer span."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.self_ms(run, "composer.")
