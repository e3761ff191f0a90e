"""Milliseconds an ``edismax`` call spends in its phrase phases
(``composer.phases``: ``solr._ngram_phases``, the pf / pf2 / pf3 field
batches and their folds), per call of the window: the part of the call
the phases cost, field batches included.  Nothing where the program
recorded no phase span."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.duration_ms(run, "composer.phases")
