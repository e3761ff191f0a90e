"""What a run records for the metric readers: set-up stages, the window's
calls, the index lock's hold, host spans and the device timeline."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from benchmark.harness.trace import Timeline

# host spans of the traced run, innermost first
FIELD_CALL = "edismax.field_call"   # a composer's score_batch_device call
CLIENT_CALL = "client_call"         # one client call
SPAN_KINDS = (FIELD_CALL, CLIENT_CALL)


class Setup:
    """Seconds of each set-up stage, by name (a stage may recur: one per
    index)."""

    def __init__(self):
        self.stages: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.setdefault(name, []).append(time.perf_counter() - t0)

    def seconds(self, name: str) -> Optional[float]:
        got = self.stages.get(name)
        return sum(got) if got else None


@dataclass
class CallRecord:
    client: int
    i: int
    start: int            # perf_counter_ns
    end: int
    n_queries: int
    answers: Optional[list] = None     # [(scores, indices)], one a query
    error: Optional[str] = None


@dataclass
class Run:
    """One run as the readers see it."""
    setup_s: float
    setup: Setup
    calls: List[CallRecord]
    window: Tuple[int, int]               # perf_counter_ns
    hold_s: float                         # the index locks' hold, summed
    peak_bytes: int
    device_kind: str
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    timeline: Optional[Timeline] = None
    work_bytes: Optional[Callable[[], int]] = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def n_queries(self) -> int:
        return sum(c.n_queries for c in self.calls)

    def latencies_ms(self) -> List[float]:
        return [(c.end - c.start) / 1e6 for c in self.calls]

    def kernel_seconds(self) -> Optional[float]:
        if self.timeline is None:
            return None
        lo, hi = self.window
        return sum(max(0, min(o.end, hi) - max(o.start, lo))
                   for o in self.timeline.kernels) / 1e9
