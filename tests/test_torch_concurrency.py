"""Concurrent queries on the port: many threads on one index give, bit for
bit, what the same calls give one after another.

The reference documents thread-parallel querying (its test_tmdb.py:285
and test_msmarco.py:454; the JAX package's tests/test_concurrency.py).
The first six cases are that file's, against the port on the CPU.  The
rest are stress patterns: each thread's calls are also made serially on
a second index built from the same docs, and every threaded result must
equal its serial twin exactly.  The pools are shrunk so that the
threads' waves evict each other's rows: what keeps the results right is
the slot maps' lock (``SlotMaps.held``), not room to spare.  The GIL's
switch interval is cut during the stress cases, so threads interleave
inside a batch's planning and fills."""
import sys
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from searcharray_tpu_torch import SearchArray, edismax
from searcharray_tpu_torch.pandas_ext import array as array_mod
from searcharray_tpu_torch.parallel.sharded import default_mesh
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.utils.profiling import hbm_report

THREADS = 8
N_DOCS = 2000
JOIN_TIMEOUT_S = 120


def make_corpus(n, seed=3):
    """tests/test_concurrency.py's corpus: zipf draws over 502 words."""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i}" for i in range(500)] + ["common", "term"])
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    return [
        " ".join(rng.choice(vocab, size=rng.integers(2, 40), p=probs))
        for _ in range(n)
    ]


DOCS = make_corpus(N_DOCS)


def index(docs=DOCS, **kw):
    return SearchArray.index(docs, workers=1, device="cpu", **kw)


def run_threads(fn, n=THREADS):
    """fn(i) on n threads started together; their results, in thread
    order, and the exceptions they raised."""
    results = [None] * n
    errors = []
    start = threading.Barrier(n)

    def worker(i):
        try:
            start.wait()
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 (reported by the caller)
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    return results, errors


def assert_bit_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype, what
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), what


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """torch's CPU ops on one thread each while these tests run: every
    Python thread that calls an op would otherwise bring up a team of
    intra-op threads of its own, and 8 such teams oversubscribe the
    machine (the other test workers' too)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# tests/test_concurrency.py's cases, against the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def frame():
    return pd.DataFrame({"body": index()}), DOCS


def test_concurrent_queries_deterministic(frame):
    df, _ = frame
    expected, _ = edismax(df, q="common term w3", qf=["body"], pf=["body"])
    results, errors = run_threads(
        lambda i: edismax(df, q="common term w3", qf=["body"],
                          pf=["body"])[0])
    assert not errors
    for r in results:
        assert np.allclose(r, expected)


def test_multithreaded_build_matches_single(frame):
    _, docs = frame
    multi = SearchArray.index(docs, workers=4, batch_size=333, device="cpu")
    single = SearchArray.index(docs, workers=1, batch_size=100_000,
                               device="cpu")
    for q in ("common", "w3", "w77"):
        assert np.allclose(multi.score(q), single.score(q)), q
    assert np.array_equal(
        multi.termfreqs(["common", "term"]), single.termfreqs(["common", "term"])
    )


def test_batch_size_independence(frame):
    _, docs = frame
    a = SearchArray.index(docs, batch_size=100, device="cpu")
    b = SearchArray.index(docs, batch_size=100_000, device="cpu")
    assert np.allclose(a.score("common"), b.score("common"))
    assert a.docfreq("common") == b.docfreq("common")


def test_repeat_queries_deterministic(frame):
    df, _ = frame
    first, _ = edismax(df, q="common w5", qf=["body"], pf2=["body"])
    for _ in range(3):
        again, _ = edismax(df, q="common w5", qf=["body"], pf2=["body"])
        assert np.array_equal(first, again)


def test_hbm_report(frame):
    df, _ = frame
    arr = df["body"].array
    arr.score("common")  # force device upload
    rep = hbm_report(arr)
    assert rep["index.hdrs"] > 0
    assert rep["index.total"] >= rep["index.hdrs"] + rep["index.pays"]


def test_hbm_and_memory_report_account_pools(frame):
    df, _ = frame
    arr = df["body"].array
    arr.score_batch([["common", "w5"], "w3"])  # fills both pools
    rep = hbm_report(arr)
    assert rep.get("pool.plane_pool", 0) > 0
    assert rep.get("pool.tf_pool", 0) > 0
    assert rep["pool.plane_pool.slots_used"] >= 1
    assert rep["index.total"] >= rep["pool.plane_pool"] + rep["pool.tf_pool"]
    txt = arr.memory_report()
    assert "Plane Pool" in txt and "TF Pool" in txt


# ---------------------------------------------------------------------------
# stress: threaded calls against the same calls made serially
# ---------------------------------------------------------------------------
TERMS = [f"w{i}" for i in range(100)]
BIGRAMS = [[f"w{i // 10}", f"w{i % 10 + 10}"] for i in range(100)]
QQ = BIGRAMS + TERMS


def rotated(i):
    """Thread i's request: the 200 queries rotated by 20 i, so the
    threads' waves differ."""
    r = (20 * i) % len(QQ)
    return QQ[r:] + QQ[:r]


@pytest.fixture
def contended(monkeypatch):
    """Small pools (the waves of one call evict each other's rows, and
    every thread's waves evict the others') and a short GIL switch
    interval."""
    monkeypatch.setattr(dense, "TF_POOL_MAX_SLOTS", 24)
    monkeypatch.setattr(dense, "PLANE_POOL_MAX_SLOTS", 12)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def test_pools_are_shrunk_for_the_stress_cases(contended):
    """The stress cases' batches need more pool rows than the pools hold:
    one call's waves already evict its own earlier rows."""
    arr = index()
    dev = arr.dev
    assert dense.tf_capacity(dev) == 24
    assert dense.plane_capacity(dev) == 12
    arr.score_batch(rotated(0), top_k=5)
    # 100 distinct terms passed through 24 tf rows, 20 planes through 12
    assert dev.maps.tf_cap == 24 and len(dev.maps.tf_slot) <= 24
    assert dev.maps.plane_cap == 12 and len(dev.maps.plane_slot) <= 12


def test_threaded_score_batch_equals_serial(contended):
    arr, ref = index(), index()
    calls = 3
    want = [[ref.score_batch(rotated(i), top_k=5) for _ in range(calls)]
            for i in range(THREADS)]
    got, errors = run_threads(
        lambda i: [arr.score_batch(rotated(i), top_k=5)
                   for _ in range(calls)])
    assert not errors, errors
    for i in range(THREADS):
        for c in range(calls):
            assert_bit_equal(got[i][c][0], want[i][c][0], f"scores {i}/{c}")
            assert_bit_equal(got[i][c][1], want[i][c][1], f"indices {i}/{c}")


def test_threaded_score_batch_dense_scores_equal_serial(contended):
    """Full score rows (no top-k), mixed exact and slop phrases."""
    arr, ref = index(), index()
    slops = [0, 2] * 50 + [0] * 100

    def call(a, i):
        return a.score_batch(rotated(i), slop=slops)

    want = [call(ref, i) for i in range(THREADS)]
    got, errors = run_threads(lambda i: call(arr, i))
    assert not errors, errors
    for i in range(THREADS):
        assert_bit_equal(got[i], want[i], f"thread {i}")


ED_QUERIES = ["common term w3", "w1 w11 w2", "w3 w13 common w4",
              "term w5 w15"]
ED_KW = dict(qf=["title^2", "body"], pf=["body"], pf2=["title", "body"],
             ps=2, mm="2<75%", tie=0.1)


def ed_frame():
    titles = [" ".join(d.split()[:6]) for d in DOCS]
    return pd.DataFrame({"title": index(titles), "body": index()})


def test_threaded_edismax_on_a_cold_frame_equals_serial(contended):
    """Mixed edismax (pf, pf2, ps=2) from 8 threads on a frame no query
    has touched: the first calls attach the device indexes and start the
    pools of both fields concurrently."""
    df, ref = ed_frame(), ed_frame()
    calls = 3

    def call(frame, i, c):
        return edismax(frame, q=ED_QUERIES[(i + c) % len(ED_QUERIES)],
                       **ED_KW)[0]

    want = [[call(ref, i, c) for c in range(calls)] for i in range(THREADS)]
    got, errors = run_threads(
        lambda i: [call(df, i, c) for c in range(calls)])
    assert not errors, errors
    for i in range(THREADS):
        for c in range(calls):
            assert_bit_equal(got[i][c], want[i][c], f"thread {i} call {c}")


def test_threaded_score_batch_device_equals_serial(contended):
    arr, ref = index(), index()

    def call(a, i):
        return a.score_batch_device(rotated(i),
                                    slop=[0, 1] * 100).numpy().copy()

    want = [call(ref, i) for i in range(THREADS)]
    got, errors = run_threads(lambda i: call(arr, i))
    assert not errors, errors
    for i in range(THREADS):
        assert_bit_equal(got[i], want[i], f"thread {i}")


def test_threaded_rows_subset_equals_serial(contended):
    """score_batch_device(rows=): the K8b path over pooled planes."""
    arr, ref = index(), index()
    rows = np.random.default_rng(5).choice(N_DOCS, 300, replace=False)

    def call(a, i):
        return a.score_batch_device(rotated(i), rows=rows).numpy().copy()

    want = [call(ref, i) for i in range(THREADS)]
    got, errors = run_threads(lambda i: call(arr, i))
    assert not errors, errors
    for i in range(THREADS):
        assert_bit_equal(got[i], want[i], f"thread {i}")


def test_threaded_single_queries_equal_serial(contended):
    """score / termfreqs / topk of terms, phrases and slop phrases: the
    single-query paths that fill pool rows (the term tf row, the plane
    fill, the phrase-tf cache's promotion)."""
    arr, ref = index(), index()

    def calls(a, i):
        out = []
        for q in rotated(i)[:40]:
            out.append(a.score(q))
            if isinstance(q, list):
                out.append(a.score(q, slop=2))
                out.append(a.termfreqs(q, slop=1))
            out.append(a.topk(q, k=5)[0])
        return out

    want = [calls(ref, i) for i in range(THREADS)]
    got, errors = run_threads(lambda i: calls(arr, i))
    assert not errors, errors
    for i in range(THREADS):
        for j, (g, w) in enumerate(zip(got[i], want[i])):
            assert_bit_equal(g, w, f"thread {i} call {j}")


def test_threaded_mesh_equals_serial(contended):
    """A 4 x 2 CPU mesh (two lanes of four shards) under 8 threads:
    ranked and full-score batches."""
    mesh = default_mesh(devices=[torch.device("cpu")] * 8)
    arr, ref = index(mesh=mesh), index(mesh=mesh)

    def call(a, i):
        qq = rotated(i)[:120]
        ranked = a.score_batch(qq, top_k=5)
        full = a.score_batch_device(qq[::3], slop=2).numpy().copy()
        return ranked, full

    want = [call(ref, i) for i in range(THREADS)]
    got, errors = run_threads(lambda i: call(arr, i))
    assert not errors, errors
    for i in range(THREADS):
        (gs, gi), gf = got[i]
        (ws, wi), wf = want[i]
        assert_bit_equal(gs, ws, f"scores {i}")
        assert_bit_equal(gi, wi, f"indices {i}")
        assert_bit_equal(gf, wf, f"full {i}")


def test_a_wave_reads_its_phrase_rows_after_earlier_waves_evict_them(
        contended):
    """One thread, no race: in this call order a call's first waves evict
    cached phrase rows that its later waves read, whose terms' planes
    those waves must then fill.  Waves are cut after the reservations
    before them (``batch._waves``), so each fits the plane pool; cut all
    at once, the third call raised "dense pool exhausted".  Each call
    equals the same call on a fresh index bit for bit."""
    arr = index()
    slop = [0, 1] * 100
    for i in (0, 6, 1):
        got = arr.score_batch_device(rotated(i), slop=slop).numpy()
        want = index().score_batch_device(rotated(i), slop=slop).numpy()
        assert_bit_equal(got, want, f"call {i}")


def test_no_result_is_a_view_of_a_pool_row():
    """The next holder of the maps may refill any pool row, so no call
    returns a view of one: a one-group term batch kept on the device (its
    output placed as it is), cached phrase rows, and a term's scores."""
    from searcharray_tpu_torch.search import scoring

    arr = index()
    dev = arr.dev
    for _ in range(2):   # the second call scores the phrase's cached row
        outs = [arr.score_batch_device(["w1", "w2"]),
                arr.score_batch_device([["w1", "w11"]]),
                scoring.score_term_dense(dev, dev.vocab.get_term_id("w3"))]
        pools = {p.untyped_storage().data_ptr()
                 for p in (dev.tf_pool, dev.plane_pool) if p is not None}
        assert len(pools) == 2
        for out in outs:
            assert out.untyped_storage().data_ptr() not in pools


def test_two_threads_attach_one_device_index(monkeypatch):
    """Two threads searching a fresh array attach one DeviceIndex (a slow
    attach widens the window in which both could build one)."""
    built = []

    class SlowAttach(array_mod.DeviceIndex):
        def __init__(self, *a, **kw):
            threading.Event().wait(0.05)
            super().__init__(*a, **kw)
            built.append(self)

    arr = index(autowarm=False)
    monkeypatch.setattr(array_mod, "DeviceIndex", SlowAttach)
    got, errors = run_threads(lambda i: (arr.dev, arr.score("common")), n=2)
    assert not errors, errors
    assert len(built) == 1
    assert got[0][0] is got[1][0] is arr.dev
    assert_bit_equal(got[0][1], got[1][1], "scores")


def test_pool_exhaustion_under_threads_releases_the_lock(monkeypatch):
    """A batch the pool cannot take raises in its own thread and leaves
    no slot assigned and the maps free: the other threads' calls go on
    and are right."""
    monkeypatch.setattr(dense, "PLANE_POOL_MAX_SLOTS", 8)
    arr, ref = index(), index()
    too_many = list(range(9))   # nine planes at once in a pool of eight

    def call(a, i):
        if i % 2:
            for _ in range(3):
                with pytest.raises(RuntimeError, match="pool exhausted"):
                    dense.ensure_planes(a.dev, too_many)
            return None
        return a.score_batch(rotated(i)[:60], top_k=5)

    want = [None if i % 2 else call(ref, i) for i in range(THREADS)]
    got, errors = run_threads(lambda i: call(arr, i))
    assert not errors, errors
    for i in range(0, THREADS, 2):
        assert_bit_equal(got[i][0], want[i][0], f"scores {i}")
        assert_bit_equal(got[i][1], want[i][1], f"indices {i}")
    maps = arr.dev.maps
    assert maps.lock.acquire(blocking=False)
    maps.lock.release()
    assert set(maps.plane_slot.values()).isdisjoint(maps.plane_free)
    assert len(maps.plane_slot) + len(maps.plane_free) == maps.plane_cap


def test_counters_are_exact_under_threads(contended):
    """The engine's and the wrappers' counters add up under threads: the
    same calls made from 12 threads count what they count serially."""
    from searcharray_tpu_torch.ops.cuda import score as kc
    from searcharray_tpu_torch.search import batch

    def counts():
        return (dense.DISPATCHES[0], batch.CAND_GROUPS[0],
                kc.topk.launches, kc.similarity.launches)

    n = 12   # more threads than the test machine's cores

    def run(parallel):
        arrs = [index() for _ in range(n)]   # one pool state each
        before = counts()
        if parallel:
            _, errors = run_threads(
                lambda i: arrs[i].score_batch(rotated(i), top_k=5), n=n)
            assert not errors, errors
        else:
            for i in range(n):
                arrs[i].score_batch(rotated(i), top_k=5)
        return [a - b for a, b in zip(counts(), before)]

    serial = run(False)
    assert serial[0] > 0
    # the wrappers count their launches on CPU tensors too only where a
    # kernel ran; the engine's counters count every group
    assert run(True) == serial
