"""Observability: program spans, device traces and device-memory
accounting.

The JAX package's ``utils/profiling.py`` over torch: ``trace`` writes a
Chrome trace of ``torch.profiler`` (CPU activity, and CUDA activity where
a card is present), the program's spans among its events, and
``hbm_report`` keeps the JAX package's keys for the index's tensors and
pools, with the card's own counters from ``torch.cuda`` for an index that
lives on one.

**Spans.**  The call path brackets each layer's work in a ``span``, or
makes a function's calls spans (``spanned``): the facade's ``facade.*``,
the batch driver's ``batch.*``, the composer's ``composer.*``.  It adds
counts to the innermost open one (``count``).  A
span records its name, its start and end on ``time.perf_counter_ns`` (the
clock a device trace is aligned to), its id, its parent's id, the id of
the outermost span open on its thread (the request), the thread and its
counts.  Spans are recorded while ``recording()`` is open, or while a
``torch.profiler`` session runs anywhere in the process; otherwise
``span`` returns a shared no-op context and ``count`` returns at once.
A span adds no device event and never waits for the device: the
``batch.wait`` spans bracket waits the call path makes anyway.  The
buffer keeps the newest ``CAPACITY`` spans and counts those it drops;
``trace`` takes out the spans it writes, and whoever opens
``recording()`` (or a profiler) around a long-lived process empties the
buffer with ``clear()`` once it has read it.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _torch_profiler

CAPACITY = 1 << 18


class Span:
    """One span; times are ``perf_counter_ns``.  A recorded span is also
    the context that times its block."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "thread", "counts", "_rec", "_stack")

    def __init__(self, rec: "Recorder", name: str, counts: Optional[dict]):
        """A span of ``rec`` opened on this thread: the child of its
        innermost open span."""
        self._rec = rec
        self.name = name
        self.id = next(rec._ids)
        self.counts = counts if counts is not None else {}
        self.start_ns = self.end_ns = 0
        self._stack, self.thread = rec.thread_state()
        if self._stack:
            top = self._stack[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent, self.request = 0, self.id

    def __enter__(self) -> "Span":
        self._stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        stack, self._stack = self._stack, None
        if stack and stack[-1] is self:
            stack.pop()
        self._rec.finish(self)

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{(self.end_ns - self.start_ns) / 1e3:.1f} us, "
                f"{self.counts})")


class Recorder:
    """The spans of a process: each thread's stack of open spans, and a
    buffer of finished ones that drops its oldest past ``capacity``."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self.forced = 0          # open ``recording()`` blocks
        self.dropped = 0
        self._done: deque = deque()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def thread_state(self) -> tuple:
        """This thread's (stack of open spans, native thread id), the id
        read once a thread (a system call)."""
        try:
            return self._local.state
        except AttributeError:
            self._local.state = ([], threading.get_native_id())
            return self._local.state

    def finish(self, sp: Span) -> None:
        with self._lock:
            if len(self._done) >= self.capacity:
                self._done.popleft()
                self.dropped += 1
            self._done.append(sp)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._done)

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self.dropped = 0

    def take(self, since_ns: int) -> List[Span]:
        """Take out the spans that start at or after ``since_ns``."""
        with self._lock:
            mine = [s for s in self._done if s.start_ns >= since_ns]
            self._done = deque(s for s in self._done
                               if s.start_ns < since_ns)
        return mine


class _Off:
    """The shared context of a span that is not recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()
RECORDER = Recorder()


def active() -> bool:
    """Whether spans are recorded now: inside ``recording()``, or while a
    ``torch.profiler`` session runs (its flag is the process's, whichever
    thread opened it)."""
    return bool(RECORDER.forced or _torch_profiler._is_profiler_enabled)


def span(name: str, **counts):
    """A context that records the block as a span named ``name`` (with
    ``counts`` to start its counts) where ``active()``."""
    if not (RECORDER.forced or _torch_profiler._is_profiler_enabled):
        return _OFF
    return Span(RECORDER, name, counts)


def spanned(name: str):
    """Decorate a function so that each of its calls is a span named
    ``name`` where ``active()``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if RECORDER.forced or _torch_profiler._is_profiler_enabled:
                with Span(RECORDER, name, None):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``key`` of this thread's innermost open span."""
    if not (RECORDER.forced or _torch_profiler._is_profiler_enabled):
        return
    stack = RECORDER.thread_state()[0]
    if stack:
        counts = stack[-1].counts
        counts[key] = counts.get(key, 0) + n


def mark(name: str, start_ns: int, end_ns: int) -> None:
    """Record a span timed by the caller (``perf_counter_ns``), as a child
    of this thread's innermost open span."""
    if not (RECORDER.forced or _torch_profiler._is_profiler_enabled):
        return
    sp = Span(RECORDER, name, None)
    sp.start_ns, sp.end_ns, sp._stack = int(start_ns), int(end_ns), None
    RECORDER.finish(sp)


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``CAPACITY``)."""
    return RECORDER.spans()


def dropped() -> int:
    """Spans dropped, oldest first, since the buffer was last cleared."""
    return RECORDER.dropped


def clear() -> None:
    RECORDER.clear()


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    rec = RECORDER
    with rec._lock:
        rec.forced += 1
    try:
        yield rec
    finally:
        with rec._lock:
            rec.forced -= 1


_MARKER = "profiling.spans_marker"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome trace (``chrome://tracing``,
    Perfetto) into ``log_dir`` as ``trace-<time>.json``, the block's
    program spans among its events (``cat`` "program_span", on the rows
    of their threads, their counts and ids under ``args``).  A marker
    event that ends just after a host timestamp ties the spans' clock to
    the trace's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        # the marker's end is stamped right after the host's timestamp
        # (its start can trail the profiler's first-event set-up)
        with record_function(_MARKER):
            mark_ns = time.perf_counter_ns()
        yield prof
    path = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    mine = RECORDER.take(mark_ns)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ends = [float(e["ts"]) + float(e.get("dur", 0)) for e in events
            if e.get("name") == _MARKER and "ts" in e]
    if not ends or not mine:
        return
    shift_us = ends[0] - mark_ns / 1e3
    events += [{"ph": "X", "cat": "program_span", "name": s.name,
                "pid": os.getpid(), "tid": s.thread,
                "ts": s.start_ns / 1e3 + shift_us,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"id": s.id, "parent": s.parent,
                         "request": s.request, **s.counts}}
               for s in mine]
    with open(path, "w") as f:
        json.dump(doc, f)


def hbm_report(index=None) -> Dict[str, int]:
    """Bytes of the index's device tensors and pools (a ``SearchArray`` or
    a ``DeviceIndex``); for a sharded array (``mesh=``) also
    ``sharded.<name>``, its shards' ``hdrs``, ``pays``, ``doc_lens``,
    ``plane_pool`` and ``tf_pool`` summed over shards and counted in
    ``index.total``; and for an index on a card (or, with no index, any
    card present) the device's own counters: ``device.bytes_in_use``
    (``torch.cuda.memory_allocated``), ``device.peak_bytes_in_use``
    (``max_memory_allocated``) and ``device.bytes_limit`` (the card's
    total memory).  An index on the CPU reports no ``device.*`` key."""
    report: Dict[str, int] = {}
    device = None
    if index is not None:
        sharded = getattr(getattr(index, "_state", None), "sharded", None)
        dev = index.dev if hasattr(index, "dev") else index
        device = dev.device
        for name in ("hdrs", "pays", "doc_lens"):
            t = getattr(dev, name, None)
            if t is not None:
                report[f"index.{name}"] = t.numel() * t.element_size()
        # serving pools: the largest allocations an operator sees (the
        # plane pool's budget alone is gigabytes); residency beside them,
        # read under the maps' lock (a query may be filling them)
        with dev.maps.lock:
            pools = [(dev.plane_pool, len(dev.maps.plane_slot), "plane_pool"),
                     (dev.tf_pool, len(dev.maps.tf_slot), "tf_pool")]
        for pool, used, label in pools:
            if pool is not None:
                report[f"pool.{label}"] = pool.numel() * pool.element_size()
                report[f"pool.{label}.slots_used"] = used
                report[f"pool.{label}.slots_total"] = int(pool.shape[0])
        if sharded is not None:
            for name in ("hdrs", "pays", "doc_lens", "plane_pool",
                         "tf_pool"):
                ts = []
                for d in sharded.device_indexes():
                    with d.maps.lock:
                        t = getattr(d, name)
                    if t is not None:
                        ts.append(t)
                if ts:
                    report[f"sharded.{name}"] = sum(
                        t.numel() * t.element_size() for t in ts)
        report["index.total"] = sum(
            v for k, v in report.items()
            if k.startswith(("index.", "sharded."))
            or (k.startswith("pool.") and not k.endswith(("slots_used",
                                                           "slots_total"))))
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and device.type == "cuda":
        report["device.bytes_in_use"] = int(torch.cuda.memory_allocated(device))
        report["device.peak_bytes_in_use"] = int(
            torch.cuda.max_memory_allocated(device))
        report["device.bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    return report


def format_hbm_report(index=None) -> str:
    rep = hbm_report(index)
    lines = ["HBM report", "----------"]
    for k, v in rep.items():
        lines.append(f"{k:28s} {v / 1e6:10.2f} MB")
    return "\n".join(lines)
