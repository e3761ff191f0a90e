"""The port's program spans and pool counts (``utils/profiling.py``): how
spans nest, per request and per thread; that recording off records
nothing and changes no result; the plane and tf pools' row and fill
counts against a hand count; the gate that a ``torch.profiler`` session
opens in every thread; the bounded buffer; the index lock's wait; and
the spans in ``trace``'s Chrome trace; the span decorator."""
import json
import os
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
from torch.profiler import ProfilerActivity, profile

from searcharray_tpu_torch import SearchArray, edismax
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.utils import profiling

JOIN_TIMEOUT_S = 120
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
QUERIES = ["alpha", ["alpha", "beta"], "gamma", ["beta", "gamma", "eta"],
           ["alpha", "beta"], "theta"]
SLOPS = [0, 0, 0, 2, 0, 0]
EDISMAX = dict(qf=["title^2", "body"], mm="2<75%", tie=0.1,
               pf=["title", "body"], pf2=["body"], top_k=5)


def make_docs(n=600, seed=11):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=rng.integers(1, 30)))
            for _ in range(n)]


DOCS = make_docs()


def index(docs=DOCS):
    return SearchArray.index(docs, workers=1, device="cpu", autowarm=False)


def frame():
    return pd.DataFrame({"title": index([d[:24] for d in DOCS]),
                         "body": index()})


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def by_id(spans):
    return {s.id: s for s in spans}


def assert_nested(spans):
    """Every span inside its parent's interval, on its parent's thread,
    in its parent's request; a root is its own request."""
    ids = by_id(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent == 0:
            assert s.request == s.id
            continue
        p = ids[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
        assert s.thread == p.thread and s.request == p.request


def test_spans_nest_with_parent_and_request_ids():
    arr, df = index(), frame()
    with profiling.recording():
        arr.score_batch(QUERIES, slop=SLOPS, top_k=3)
        edismax(df, q="alpha beta gamma", **EDISMAX)
    spans = profiling.spans()
    assert_nested(spans)
    ids = by_id(spans)
    roots = [s for s in spans if s.parent == 0]
    assert [r.name for r in roots] == ["facade.score_batch",
                                       "composer.edismax"]
    facade, composer = roots
    assert [s.name for s in spans if s.parent == facade.id] == [
        "batch.lock_wait", "batch.plan", "batch.enqueue", "batch.assemble"]
    assert [s.name for s in spans if s.parent == composer.id] == [
        "facade.score_batch_device", "facade.score_batch_device",
        "composer.phases", "batch.wait"]
    # one field batch a field under the composer (its terms and its
    # grams), the phases' folds alone under theirs, and the batch driver's
    # spans under each field batch; the composer counts its field batches
    fields = [s for s in spans if s.name == "facade.score_batch_device"]
    assert [ids[f.parent].name for f in fields] == [
        "composer.edismax", "composer.edismax"]
    phases = next(s for s in spans if s.name == "composer.phases")
    assert not [s for s in spans if s.parent == phases.id]
    assert composer.counts == {"field_batches": 2}
    for f in fields:
        assert f.request == composer.id
        assert {s.name for s in spans if s.parent == f.id} >= {
            "batch.plan", "batch.enqueue", "batch.assemble"}
    # counts on the plans and, for the ranked batch, on its enqueue: the
    # rows of its ranked groups (its five distinct queries, every one
    # fused: top 3 of whole rows); the edismax field batches rank nothing
    enqueue = next(s for s in spans if s.name == "batch.enqueue")
    assert enqueue.parent == facade.id
    assert enqueue.counts == {"ranked_rows": 5}
    assert all(s.counts == {} for s in spans
               if s.name != "batch.plan" and s not in (enqueue, composer))


def test_spans_nest_per_thread_across_four_threads():
    arr = index()
    want = arr.score_batch(QUERIES, slop=SLOPS, top_k=3)
    calls, n = 6, 4
    results = [[] for _ in range(n)]
    errors = []
    start = threading.Barrier(n)

    def worker(i):
        try:
            start.wait()
            for _ in range(calls):
                results[i].append(arr.score_batch(QUERIES, slop=SLOPS,
                                                  top_k=3))
        except BaseException as e:   # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(JOIN_TIMEOUT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for got in results:
        assert len(got) == calls
        for s, ix in got:
            assert s.tobytes() == want[0].tobytes()
            assert np.array_equal(ix, want[1])
    spans = profiling.spans()
    assert_nested(spans)
    roots = [s for s in spans if s.parent == 0]
    assert len(roots) == n * calls
    assert {r.name for r in roots} == {"facade.score_batch"}
    assert len({r.thread for r in roots}) == n
    ids = by_id(spans)
    for s in spans:
        assert ids[s.request].name == "facade.score_batch"
    for name in ("batch.lock_wait", "batch.plan", "batch.enqueue",
                 "batch.assemble"):
        assert sum(1 for s in spans if s.name == name) == n * calls


def run_calls(arr, df):
    out = []
    for _ in range(3):   # the second call promotes the repeated phrase
        out.append(arr.score_batch(QUERIES, slop=SLOPS, top_k=4))
        out.append((arr.score_batch(QUERIES, slop=SLOPS),))
        out.append(edismax(df, q="alpha beta gamma", **EDISMAX)[0])
        out.append((edismax(df, q="beta eta", **{**EDISMAX,
                                                  "top_k": None})[0],))
    return [a for parts in out for a in parts]


def test_recording_off_records_nothing_and_changes_no_result():
    assert not profiling.active()
    off = run_calls(index(), frame())
    assert profiling.spans() == [] and profiling.dropped() == 0
    with profiling.recording():
        assert profiling.active()
        on = run_calls(index(), frame())
    assert not profiling.active()
    assert len(profiling.spans()) > 0
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_pool_counts_equal_a_hand_count(monkeypatch):
    """tf pool of 4 rows, plane pool of 8; LRU eviction.  Per call, the
    (plane rows, plane fills, tf rows, tf fills) its plan reserved."""
    monkeypatch.setattr(dense, "TF_POOL_MAX_SLOTS", 4)
    monkeypatch.setattr(dense, "PLANE_POOL_MAX_SLOTS", 8)
    arr = index()
    ab = ["alpha", "beta"]
    script = [
        # three terms: three tf rows, all missing
        (["alpha", "beta", "gamma"], (0, 0, 3, 3)),
        # alpha resident, delta missing; the pool is full (4)
        (["alpha", "delta"], (0, 0, 2, 1)),
        # a phrase's first sight: its two planes
        ([ab], (2, 2, 0, 0)),
        # its second: promoted into the tf pool; its row pulls its planes
        # (resident) and evicts the least recent term, beta
        ([ab], (2, 0, 1, 1)),
        # its third: the cached row
        ([ab], (0, 0, 1, 0)),
        # beta was evicted, epsilon is new: gamma and alpha go
        (["beta", "eps"], (0, 0, 2, 2)),
        ([ab], (0, 0, 1, 0)),
        # alpha and gamma were evicted: delta and beta go
        (["alpha", "gamma"], (0, 0, 2, 2)),
        # the phrase row is still resident beside them
        ([ab, "gamma"], (0, 0, 2, 0)),
    ]
    with profiling.recording():
        for queries, _ in script:
            arr.score_batch(queries, top_k=3)
    plans = [s for s in profiling.spans() if s.name == "batch.plan"]
    keys = ("plane_rows", "plane_fills", "tf_rows", "tf_fills")
    got = [tuple(s.counts.get(k, 0) for k in keys) for s in plans]
    assert got == [want for _, want in script]
    assert arr.dev.maps.tf_cap == 4
    sig = (tuple(arr.term_dict.get_term_id(w) for w in ab), 0)
    assert sig in arr.dev.maps.tf_slot


def test_recording_turns_on_under_the_torch_profiler_in_every_thread():
    arr = index()
    seen = {}

    def second():
        seen["active"] = profiling.active()
        arr.score_batch(["alpha", "gamma"], top_k=2)

    assert not profiling.active()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.active()
        arr.score_batch(["alpha"], top_k=2)
        t = threading.Thread(target=second)
        t.start()
        t.join(JOIN_TIMEOUT_S)
    assert not t.is_alive()
    assert seen["active"] is True
    assert not profiling.active()
    roots = [s for s in profiling.spans() if s.parent == 0]
    assert [r.name for r in roots] == ["facade.score_batch"] * 2
    assert roots[0].thread != roots[1].thread
    tf_rows = [s.counts["tf_rows"] for s in profiling.spans()
               if s.name == "batch.plan"]
    assert tf_rows == [1, 2]
    arr.score_batch(["alpha"], top_k=2)
    assert len([s for s in profiling.spans() if s.parent == 0]) == 2


def test_a_full_buffer_drops_the_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder(3))
    with profiling.recording():
        for i in range(5):
            with profiling.span(f"s{i}", i=i):
                profiling.count("n", 2)
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4"]
    assert [s.counts for s in profiling.spans()] == [
        {"i": i, "n": 2} for i in (2, 3, 4)]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_the_lock_wait_span_grows_while_a_second_thread_waits_on_the_lock():
    maps = index().dev.maps
    held, release = threading.Event(), threading.Event()
    hold_s = 0.2

    def holder():
        with maps.held(()):
            held.set()
            release.wait(JOIN_TIMEOUT_S)

    holds0 = maps.holds
    with profiling.recording():
        t = threading.Thread(target=holder)
        t.start()
        assert held.wait(JOIN_TIMEOUT_S)
        timer = threading.Timer(hold_s, release.set)
        timer.start()
        t0 = time.perf_counter()
        with maps.held(()):
            waited = time.perf_counter() - t0
            with maps.held(()):      # a nested hold waits for nothing
                pass
        t.join(JOIN_TIMEOUT_S)
        timer.join(JOIN_TIMEOUT_S)
    assert not t.is_alive()
    assert maps.holds == holds0 + 2
    # one span for each outermost hold, none for the nested one
    waits = [s for s in profiling.spans() if s.name == "batch.lock_wait"]
    assert len(waits) == 2
    grown = max(s.end_ns - s.start_ns for s in waits) / 1e9
    assert hold_s * 0.5 <= grown <= waited + 0.05


def test_trace_writes_the_program_spans_on_the_trace_timeline(tmp_path):
    arr = index()
    arr.score_batch(QUERIES, slop=SLOPS, top_k=3)
    with profiling.trace(str(tmp_path)):
        arr.score_batch(QUERIES, slop=SLOPS, top_k=3)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(mine) == {"facade.score_batch", "batch.lock_wait",
                         "batch.plan", "batch.enqueue", "batch.assemble"}
    facade = mine["facade.score_batch"]
    assert mine["batch.plan"]["args"]["parent"] == facade["args"]["id"]
    assert mine["batch.plan"]["args"]["tf_rows"] > 0
    assert facade["tid"] == threading.get_native_id()
    # the written spans are taken out of the buffer
    assert profiling.spans() == []
    # the call's operators lie inside its span, to well under a
    # millisecond (unaligned clocks differ by days)
    lo, hi = facade["ts"], facade["ts"] + facade["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    assert ops
    slack = 1000.0
    assert all(lo - slack <= e["ts"] <= hi + slack for e in ops)
    enq = mine["batch.enqueue"]
    assert any(enq["ts"] - slack <= e["ts"] <= enq["ts"] + enq["dur"]
               for e in ops)


def test_spanned_records_each_call_and_passes_through_when_off():
    @profiling.spanned("facade.test")
    def f(x, y=1):
        """doc"""
        profiling.count("n", x)
        if x < 0:
            raise ValueError(x)
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert f(2, y=3) == 5
    assert profiling.spans() == []
    with profiling.recording():
        assert f(1) == 2
        with pytest.raises(ValueError):
            f(-1)
        with profiling.span("outer"):
            f(4)
    got = profiling.spans()
    assert [(s.name, s.counts) for s in got] == [
        ("facade.test", {"n": 1}), ("facade.test", {"n": -1}),
        ("facade.test", {"n": 4}), ("outer", {})]
    assert got[0].parent == got[1].parent == 0
    assert got[2].parent == got[3].id
    # a raising call leaves no span open on the thread
    assert profiling.RECORDER.thread_state()[0] == []
