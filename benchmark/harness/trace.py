"""The traced run's device timeline: ``torch.profiler`` with CUDA activity
only (no CPU operator events, which would slow the host path it
measures), its events kept in memory and reduced here.  No trace file is
written.

The profiler stamps device events on its own clock.  A marker kernel
(``torch.cuda._sleep``) launched right after a host timestamp ties that
clock to the host's ``perf_counter_ns``, so the idle gaps can be named by
the host spans the benchmark recorded (client calls, composer field
calls); the launch's own latency, microseconds, is the alignment's error.
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

MARKER = "spin_kernel"


@dataclass
class DeviceOp:
    name: str
    start: int      # host perf_counter_ns
    end: int
    kernel: bool    # False for a copy or a memset


@dataclass
class Timeline:
    ops: List[DeviceOp]
    window: Tuple[int, int]   # host perf_counter_ns

    @property
    def kernels(self) -> List[DeviceOp]:
        return [o for o in self.ops if o.kernel]


def busy_intervals(ops: Sequence[DeviceOp], lo: int, hi: int
                   ) -> List[Tuple[int, int]]:
    """The union of the ops' intervals, clipped to [lo, hi]."""
    spans = sorted((max(o.start, lo), min(o.end, hi)) for o in ops
                   if o.end > lo and o.start < hi)
    out: List[Tuple[int, int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_gaps(busy: Sequence[Tuple[int, int]], lo: int, hi: int
              ) -> List[Tuple[int, int]]:
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


class HostState:
    """What the host was doing at a time: the innermost kind of span open
    then (``kinds`` lists the span names innermost first), or
    "client_loop" where none is.  Spans of one kind may overlap (client
    threads): a kind is open at t where some span that began by t ends
    after it."""

    def __init__(self, spans: Sequence[Tuple[str, int, int]],
                 kinds: Sequence[str]):
        self.kinds = []
        for kind in kinds:
            mine = sorted((s, e) for n, s, e in spans if n == kind)
            starts = [s for s, _ in mine]
            ends, top = [], -1
            for _, e in mine:
                top = max(top, e)
                ends.append(top)
            self.kinds.append((kind, starts, ends))

    def at(self, t: int) -> str:
        for kind, starts, ends in self.kinds:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] > t:
                return kind
        return "client_loop"


def kernel_base(name: str) -> str:
    """A kernel's bare function name: no namespace, template arguments or
    parameters."""
    name = short_name(name).replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("::")[-1].strip()


def short_name(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:120]


def breakdown(tl: Timeline, spans: Sequence[Tuple[str, int, int]],
              kinds: Sequence[str]) -> Dict[str, list]:
    """The device operations that took most time, and the idle time of
    the window by what the host was doing (``HostState``), each at most
    ten entries, in seconds."""
    lo, hi = tl.window
    by_op: Dict[str, int] = {}
    for o in tl.ops:
        s, e = max(o.start, lo), min(o.end, hi)
        if e > s:
            by_op[short_name(o.name)] = by_op.get(short_name(o.name), 0) + e - s
    state = HostState(spans, kinds)
    by_state: Dict[str, int] = {}
    for s, e in idle_gaps(busy_intervals(tl.ops, lo, hi), lo, hi):
        name = state.at((s + e) // 2)
        by_state[name] = by_state.get(name, 0) + e - s
    top = sorted(by_op.items(), key=lambda x: -x[1])[:10]
    gaps = sorted(by_state.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, v / 1e9] for n, v in top],
            "idle_gaps": [[n, v / 1e9] for n, v in gaps]}


class DeviceTrace:
    """Profile the device from ``start()`` to ``stop()``."""

    def __init__(self):
        self._prof = None
        self._mark = 0
        self._window = (0, 0)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self._window = (time.perf_counter_ns(), 0)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._window = (self._window[0], time.perf_counter_ns())
        self._prof.__exit__(None, None, None)

    def timeline(self) -> Optional[Timeline]:
        """The device operations on the host clock, or None where the
        profiler recorded none (or no marker to align them by)."""
        from torch.autograd import DeviceType

        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            raw.append((e.name(), int(s), int(s + d)))
        marks = [s for n, s, _ in raw if MARKER in n]
        if not marks:
            return None
        shift = min(marks) - self._mark
        ops = [DeviceOp(n, s - shift, e - shift,
                        not n.startswith(("Memcpy", "Memset")))
               for n, s, e in raw if MARKER not in n]
        return Timeline(ops, self._window) if ops else None

