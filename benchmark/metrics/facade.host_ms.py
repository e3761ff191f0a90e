"""Self time of the facade's spans (``facade.score_batch``,
``facade.score_batch_device``: argument checks, token-to-id resolution,
slop lists, unpacking; the lock's wait, the streams' ordering, the plan,
the enqueue, the assembly and the waits are their children) per call of
the window, in ms.  Nothing where the program recorded no span (an
untraced run)."""
import os

from benchmark.harness.registry import load_module

spans = load_module(os.path.join(os.path.dirname(__file__), "_spans.py"),
                    "benchmark_metric__spans")


def read(run):
    return spans.self_ms(run, "facade.")
