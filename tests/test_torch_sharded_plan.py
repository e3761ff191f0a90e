"""One plan per batch for every shard (``search/batch.py:plan_batch``,
``run_plan``; ``parallel/sharded.py``).

A sharded batch is deduplicated, classified, chunked and partitioned into
waves once, over slot maps that every shard of a query part shares, and
each shard runs that plan on its own slices.  Checked here on the 400-doc
corpus of tests/test_sharded.py and a 4 x 2 CPU mesh: one plan per call on
each sharded path, equal pools on every shard, bit-equality with the
unsharded port (a term absent from a shard, uneven shards), the JAX
module's count of candidate programs, and the single-device path's
launch counts pinned as they were before the split."""
import contextlib

import numpy as np
import pandas as pd
import pytest
import torch

from searcharray_tpu.index.builder import build_index as jbuild
from searcharray_tpu.parallel import sharded as jsh
from searcharray_tpu.search import candidates as jcand
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.index import store as tstore
from searcharray_tpu_torch.index.builder import build_index as tbuild
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.parallel import sharded as tsh
from searcharray_tpu_torch.search import batch
from searcharray_tpu_torch.search import candidates as tcand
from searcharray_tpu_torch.search import dense as tdense
from test_sharded import make_corpus

TOL = dict(rtol=1e-6, atol=1e-7)

# the kernel wrappers the batch driver calls (each counted per call: on
# the CPU a wrapper runs its plain version and its launch counter stays 0)
WRAPPERS = ("score_term", "score_term_rows", "segment_sum", "topk",
            "plane_fill", "phrase_chain", "span_window", "merge_step",
            "cand_rows", "cand_minis", "span_sparse", "similarity",
            "rank_rows")

# a fixed mixed batch: terms (one missing), exact phrases (one twice, a
# repeated term, 34 terms: past K5's cap), slop phrases (w > 18, a term
# three times)
PIN_QUERIES = ["alpha", "beta", "nope", ["alpha", "beta"], ["alpha", "beta"],
               ["gamma", "delta", "eps"], ["eta", "eta"],
               ["alpha", "gamma"], ["beta", "zeta", "eta"],
               ["theta", "theta", "theta"], ["alpha", "beta"] * 17,
               ["zeta", "alpha"]]
PIN_SLOPS = [0, 0, 0, 0, 0, 0, 0, 2, 25, 1, 0, 1]


def pin_docs():
    docs = make_corpus()
    docs[13] = "alpha rareterm beta alpha rareterm beta"
    docs[321] = "rareterm gamma rareterm beta"
    return docs


@contextlib.contextmanager
def counting():
    """Count every kernel wrapper's calls, DISPATCHES and CAND_GROUPS."""
    calls = dict.fromkeys(WRAPPERS, 0)
    orig = {name: getattr(kc, name) for name in WRAPPERS}

    def spy(name):
        def f(*a, **kw):
            calls[name] += 1
            return orig[name](*a, **kw)
        return f

    for name in WRAPPERS:
        setattr(kc, name, spy(name))
    d0, c0 = batch.DISPATCHES[0], batch.CAND_GROUPS[0]
    try:
        yield calls
    finally:
        for name in WRAPPERS:
            setattr(kc, name, orig[name])
        calls["DISPATCHES"] = batch.DISPATCHES[0] - d0
        calls["CAND_GROUPS"] = batch.CAND_GROUPS[0] - c0


@contextlib.contextmanager
def patched(mod, **values):
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def single_device_counts():
    """Per call of a fixed sequence on a fresh single-device index: the
    counters' deltas and every wrapper's calls."""
    arr = SearchArray.index(pin_docs(), device="cpu", autowarm=False)
    dev = arr.dev
    qt = [arr._resolve_tids(arr._check_token_arg(q)) for q in PIN_QUERIES]
    exact = [q for q, s in zip(qt, PIN_SLOPS) if s == 0]
    rows = np.flatnonzero(arr.score("alpha") > 0)[::3]
    steps = {
        "first": lambda: batch.score_batch_fused(dev, qt, top_k=5,
                                                 slop=PIN_SLOPS),
        "second": lambda: batch.score_batch_fused(dev, qt, top_k=5,
                                                  slop=PIN_SLOPS),
        "as_device": lambda: batch.score_batch_fused(dev, qt, as_device=True,
                                                     slop=PIN_SLOPS),
        "rows": lambda: batch.score_batch_fused(dev, exact, rows=rows),
    }
    out = {}
    for name, fn in steps.items():
        with counting() as calls:
            fn()
        out[name] = calls
    with patched(tcand, CAND_MIN_DOCS=0, CAND_TERM_MIN_DOCS=0,
                 CAND_MAX_FRAC=0), counting() as calls:
        batch.score_batch_fused(dev, qt, top_k=3, slop=PIN_SLOPS)
    out["candidates"] = calls
    sparse = SearchArray.index(pin_docs(), device="cpu", autowarm=False)
    with patched(tdense, DENSE_TERM_BYTES_LIMIT=0), counting() as calls:
        batch.score_batch_fused(sparse.dev, qt, top_k=5, slop=PIN_SLOPS)
    out["sparse"] = calls
    return out


# single_device_counts() on the code before the plan / run split: the
# nonzero counters of each call.  Since the fused ranking pass, each ranked
# group's K10 + K3 pair over whole rows with k <= 64 is one ``rank_rows``
# launch: one ``topk`` and one ``similarity`` fewer for each.
PINNED = {
    "first": {"DISPATCHES": 11, "score_term_rows": 1, "segment_sum": 35,
              "topk": 1, "plane_fill": 1, "phrase_chain": 3,
              "span_window": 2, "merge_step": 33, "span_sparse": 2,
              "similarity": 2, "rank_rows": 7},
    "second": {"DISPATCHES": 9, "segment_sum": 35, "topk": 1,
               "phrase_chain": 3, "span_window": 2, "merge_step": 33,
               "span_sparse": 2, "similarity": 2, "rank_rows": 2},
    "as_device": {"DISPATCHES": 4, "segment_sum": 35, "merge_step": 33,
                  "span_sparse": 2, "similarity": 4},
    "rows": {"DISPATCHES": 2, "segment_sum": 33, "merge_step": 33,
             "similarity": 2},
    "candidates": {"DISPATCHES": 9, "CAND_GROUPS": 6, "segment_sum": 35,
                   "topk": 7, "phrase_chain": 3, "span_window": 2,
                   "merge_step": 33, "cand_rows": 6, "cand_minis": 5,
                   "span_sparse": 2, "similarity": 8, "rank_rows": 1},
    "sparse": {"DISPATCHES": 10, "segment_sum": 39, "topk": 1,
               "merge_step": 33, "span_sparse": 4, "similarity": 4,
               "rank_rows": 6},
}


def test_single_device_launch_counts_pinned():
    """The single-device path is the S = 1 case of the plan: the same
    launches per call as before the split (a fused ranking launch where a
    K10 and a K3 launch were)."""
    got = single_device_counts()
    assert {step: {k: v for k, v in calls.items() if v}
            for step, calls in got.items()} == PINNED


@pytest.fixture(scope="module", autouse=True)
def jax_programs_left_as_found():
    """The JAX sharded module's program cache as this module found it
    (tests/test_sharded.py counts the programs a batch adds to it)."""
    before = set(jsh._pool_cache)
    yield
    for key in set(jsh._pool_cache) - before:
        del jsh._pool_cache[key]


def tmesh():
    return tsh.default_mesh(devices=[torch.device("cpu")] * 8)


def bits(x):
    x = x.numpy() if torch.is_tensor(x) else x
    return np.asarray(x, np.float32).view(np.int32)


def same_bits(got, want, what=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=str(what))


class Pair:
    """One corpus as a port ShardedIndex and a port unsharded array."""

    def __init__(self, docs, mesh=None):
        self.docs = docs
        self.t = tsh.ShardedIndex.build(tbuild(docs), mesh=mesh or tmesh())
        self.single = SearchArray.index(docs, device="cpu", autowarm=False)

    def tids(self, queries):
        tid = self.single._resolve_tid
        return [[tid(t) for t in ([q] if isinstance(q, str) else q)]
                for q in queries]

    def want(self, qt, **kw):
        return batch.score_batch_fused(self.single.dev, qt, **kw)


def pools_in_step(sh: tsh.ShardedIndex, single: SearchArray):
    """Every shard of a lane reads the lane's one slot map, and each of its
    pool rows holds that row's key on the shard's own docs: a term's tf
    and a cached phrase's freqs (the unsharded index's, at the shard's
    columns), a term's plane (K4's plain version on the shard's slice)."""
    for view in sh.lanes:
        maps = view.maps
        for d, dev in enumerate(view.members):
            assert dev.maps is maps
            lo, n = int(sh.shard_starts[d]), dev.corpus_size
            if dev.tf_pool is not None:
                assert dev.tf_pool.shape == (maps.tf_cap, n)
                for key, slot in maps.tf_slot.items():
                    q, sl = (([key], 0) if not isinstance(key, tuple)
                             else (list(key[0]), key[1]))
                    want = batch.score_batch_fused(single.dev, [q],
                                                   kind="none", slop=sl)[0]
                    np.testing.assert_array_equal(
                        dev.tf_pool[slot].numpy(), want[lo: lo + n],
                        err_msg=f"shard {d} tf row {key}")
            if dev.plane_pool is not None:
                assert dev.plane_pool.shape[0] == maps.plane_cap
                for t, slot in maps.plane_slot.items():
                    off, ln, _ = dev.term_span(t)
                    row = torch.zeros((1, dev.plane_pool.shape[1]),
                                      dtype=torch.int32)
                    kc.plane_fill_plain(dev.hdrs, dev.pays, np.array([off]),
                                        np.array([ln]), np.array([0]), row)
                    assert torch.equal(dev.plane_pool[slot], row[0]), (d, t)


@pytest.fixture(scope="module")
def pair():
    return Pair(pin_docs())


SERVING = ["alpha", "beta", ["alpha", "beta"], ["gamma", "delta"],
           ["eta", "eta"], "rareterm", ["rareterm", "beta"], "nope",
           ["alpha", "beta"], ["alpha", "beta", "gamma"]]
TERMS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta",
         "rareterm", "alpha"]
SLOPPED = (["alpha", ["alpha", "beta"], ["alpha", "beta"], ["gamma", "eta"],
            ["beta", "zeta", "eta"], ["theta", "theta", "theta"],
            ["rareterm", "gamma"]], [0, 0, 2, 1, 25, 1, 2])


def path_calls(pair, tmp_path):
    """(name, the sharded call, the unsharded result it equals)."""
    sh, single = pair.t, pair.single
    qs = pair.tids(SERVING)
    qt = pair.tids(TERMS)
    qm, sm = pair.tids(SLOPPED[0]), SLOPPED[1]
    rows = np.random.default_rng(1).permutation(len(pair.docs))[:120]
    exact = [q for q, s in zip(qm, sm) if s == 0] + qs
    ors = [["alpha", "gamma"], ["rareterm"], ["eta", "eta", "nope"]]
    ors_want = np.stack([sum((single.score(t) for t in q),
                             np.zeros(len(pair.docs), np.float32))
                         for q in ors])

    def store():
        tstore.save_index(single._built, str(tmp_path))
        tstore.save_shards(single._built, str(tmp_path), 4)
        return tsh.ShardedIndex.load(str(tmp_path), mesh=tmesh())

    return [
        ("serving", lambda s: s.score_batch_device(qs),
         pair.want(qs)),
        ("terms", lambda s: s.score_batch_device(qt), pair.want(qt)),
        ("mixed_slop", lambda s: s.score_batch_device(qm, slop=sm),
         pair.want(qm, slop=sm)),
        ("rows", lambda s: s.score_batch_device(exact, rows=rows),
         pair.want(exact)[:, rows]),
        ("topk", lambda s: s.topk(qm, 5, slop=sm)[0],
         pair.want(qm, top_k=5, slop=sm)[0]),
        ("score_queries", lambda s: s.score_queries(ors), ors_want),
        ("phrase_freqs", lambda s: s.phrase_freqs(["alpha", "beta"]),
         single.termfreqs(["alpha", "beta"])),
        ("span_freqs", lambda s: s.span_freqs(["rareterm", "beta"], 3),
         single.termfreqs(["rareterm", "beta"], slop=3)),
        ("store", lambda s: store().score_batch_device(qm, slop=sm),
         pair.want(qm, slop=sm)),
    ]


PATHS = ["serving", "terms", "mixed_slop", "rows", "topk", "score_queries",
         "phrase_freqs", "span_freqs", "store"]


@pytest.mark.parametrize("name", PATHS)
def test_one_plan_per_call(pair, tmp_path, name):
    """Each sharded path plans once per call, its pools stay in step on
    every shard, and it answers as the unsharded port, bit for bit."""
    (call, want), = [(c, w) for n, c, w in path_calls(pair, tmp_path)
                     if n == name]
    for _ in range(2):   # the second call reads (and promotes into) pools
        plans = tsh.PLANS[0]
        got = call(pair.t)
        assert tsh.PLANS[0] - plans == 1
        same_bits(got, want, name)
    pools_in_step(pair.t, pair.single)


@pytest.mark.parametrize("ps", [{}, {"ps": 2, "ps2": 1}],
                         ids=["exact", "slop"])
def test_edismax_phases_plan_once_each(ps):
    """edismax over sharded fields: each field's score_batch_device call
    (its query terms and its pf / pf2 grams, one call a field) is one
    plan, and the ranking equals the unsharded frame's bit for bit."""
    from searcharray_tpu_torch import edismax

    docs = pin_docs()
    titles = [d[:30] for d in docs]
    sharded = pd.DataFrame({
        "body": SearchArray.index(docs, device="cpu", mesh=tmesh(),
                                  autowarm=False),
        "title": SearchArray.index(titles, device="cpu", mesh=tmesh(),
                                   autowarm=False)})
    single = pd.DataFrame({
        "body": SearchArray.index(docs, device="cpu", autowarm=False),
        "title": SearchArray.index(titles, device="cpu", autowarm=False)})
    calls = []
    sbd = tsh.ShardedIndex.score_batch_device

    def spy(self, *a, **kw):
        calls.append(1)
        return sbd(self, *a, **kw)

    kw = dict(qf=["title^2", "body"], mm="2<75%", tie=0.1,
              pf=["title", "body"], pf2=["body"], **ps)
    tsh.ShardedIndex.score_batch_device = spy
    try:
        for q in ("alpha beta gamma", "rareterm beta", "eta eta delta"):
            calls.clear()
            plans = tsh.PLANS[0]
            got = edismax(sharded, q=q, top_k=5, **kw)
            assert len(calls) == 2 and tsh.PLANS[0] - plans == len(calls)
            want = edismax(single, q=q, top_k=5, **kw)
            same_bits(got[0], want[0], q)
            np.testing.assert_array_equal(got[1], want[1])
    finally:
        tsh.ShardedIndex.score_batch_device = sbd
    for col in ("body", "title"):
        pools_in_step(sharded[col].array._state.sharded, single[col].array)


def test_pools_in_step_through_promotion_and_eviction(monkeypatch):
    """Pools of 4 tf rows and 4 planes: a batch wider than them splits
    into waves that evict, repeated phrases promote into the phrase-tf
    cache; every shard's rows follow the one slot map throughout and the
    scores stay the unsharded port's."""
    monkeypatch.setattr(tdense, "TF_POOL_MAX_SLOTS", 4)
    monkeypatch.setattr(tdense, "PLANE_POOL_MAX_SLOTS", 4)
    pair = Pair(pin_docs())
    monkeypatch.undo()
    qm, sm = pair.tids(SLOPPED[0]), SLOPPED[1]
    monkeypatch.setattr(tdense, "TF_POOL_MAX_SLOTS", 4)
    monkeypatch.setattr(tdense, "PLANE_POOL_MAX_SLOTS", 4)
    qt, qs = pair.tids(TERMS), pair.tids(SERVING)
    evicted = set()
    for qq, sl in [(qt, 0), (qs, 0), (qm, sm), (qs, 0), (qm, sm), (qt, 0)]:
        before = set(pair.t.lanes[0].maps.tf_slot)
        got = pair.t.score_batch_device(qq, slop=sl)
        evicted |= before - set(pair.t.lanes[0].maps.tf_slot)
        monkeypatch.undo()
        same_bits(got, pair.want(qq, slop=sl))
        pools_in_step(pair.t, pair.single)
        monkeypatch.setattr(tdense, "TF_POOL_MAX_SLOTS", 4)
        monkeypatch.setattr(tdense, "PLANE_POOL_MAX_SLOTS", 4)
    maps = pair.t.lanes[0].maps
    assert maps.tf_cap == 4 and maps.plane_cap == 4 and evicted
    assert any(isinstance(k, tuple) for k in maps.phrase_recipes)


def absent_docs(n=400):
    """"solo" only in shard 0's docs, "duo" only in shards 1 and 2."""
    docs = make_corpus(n, seed=7)
    for d in (3, 40, 77):
        docs[d] = "solo alpha solo beta " + docs[d]
    for d in (120, 180, 250):
        docs[d] = "duo gamma alpha duo " + docs[d]
    return docs


ABSENT = (["solo", "duo", ["solo", "alpha"], ["alpha", "solo"],
           ["duo", "gamma", "alpha"], ["solo", "beta"], ["duo", "alpha"],
           ["solo", "solo"], ["duo", "solo"]], [0, 0, 0, 0, 0, 2, 3, 1, 0])


@pytest.mark.parametrize("n_docs", [400, 397])
def test_absent_terms_and_uneven_shards(n_docs, monkeypatch):
    """A term absent from a shard takes its slot there too (a zero row);
    with uneven shards the scores equal the unsharded port's bit for bit
    and the JAX module's within rtol 1e-6, on the dense routes and with
    the candidate engine forced."""
    docs = absent_docs(n_docs)
    pair = Pair(docs)
    jidx = jsh.ShardedIndex.build(jbuild(docs), mesh=jsh.default_mesh())
    assert pair.t.shard_sizes[-1] == n_docs - 300
    qt, sl = pair.tids(ABSENT[0]), ABSENT[1]
    shard_len = pair.t.lanes[0].lengths[:, pair.single._resolve_tid("solo")]
    assert shard_len[0] > 0 and not shard_len[1:].any()
    want = pair.want(qt, slop=sl)
    for forced in (False, True):
        if forced:
            for mod in (tcand, jcand):
                monkeypatch.setattr(mod, "CAND_MIN_DOCS", 0)
                monkeypatch.setattr(mod, "CAND_TERM_MIN_DOCS", 0)
                monkeypatch.setattr(mod, "CAND_MAX_FRAC", 0)
        for _ in range(2):
            got = pair.t.score_batch_device(qt, slop=sl).numpy()
            same_bits(got, want, f"forced={forced}")
            np.testing.assert_allclose(
                got, np.asarray(jidx.score_batch_device(qt, slop=sl)), **TOL)
            pools_in_step(pair.t, pair.single)
    # ranked on the dense routes (a forced candidate query's zero-score
    # tail differs from the full-corpus groups', search/candidates.py)
    monkeypatch.undo()
    vals, idx = pair.t.topk(qt, 4, slop=sl)
    wv, wi = pair.want(qt, top_k=4, slop=sl)
    same_bits(vals, wv)
    np.testing.assert_array_equal(idx.numpy(), wi)


FORCED_BATCHES = {
    "pin": (PIN_QUERIES[:10] + PIN_QUERIES[11:],
            PIN_SLOPS[:10] + PIN_SLOPS[11:]),
    "absent": ABSENT,
}


@pytest.mark.parametrize("name", list(FORCED_BATCHES))
def test_candidate_programs_equal_jax(name, monkeypatch):
    """With the candidate thresholds forced, a batch counts the JAX
    module's candidate programs: one a chunk, for every shard."""
    docs = absent_docs() if name == "absent" else pin_docs()
    pair = Pair(docs)
    jidx = jsh.ShardedIndex.build(jbuild(docs), mesh=jsh.default_mesh())
    queries, slops = FORCED_BATCHES[name]
    qt = pair.tids(queries)
    for mod in (tcand, jcand):
        monkeypatch.setattr(mod, "CAND_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "CAND_TERM_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "CAND_MAX_FRAC", 0)
    t0, j0 = tsh.CAND_PROGRAMS[0], jsh.CAND_PROGRAMS[0]
    got = pair.t.score_batch_device(qt, slop=slops).numpy()
    want = np.asarray(jidx.score_batch_device(qt, slop=slops))
    assert tsh.CAND_PROGRAMS[0] - t0 == jsh.CAND_PROGRAMS[0] - j0 > 0
    np.testing.assert_allclose(got, want, **TOL)
    monkeypatch.undo()
    same_bits(got, pair.want(qt, slop=slops))


def test_two_lanes_plan_once_each():
    """A mesh whose two query parts name different devices has two lanes,
    each its own slot map: a call plans once per lane, and answers as the
    unsharded port."""
    cpu, cpu0 = torch.device("cpu"), torch.device("cpu", 0)
    pair = Pair(pin_docs(), mesh=tsh.Mesh([[cpu, cpu0]] * 4))
    assert len(pair.t.lanes) == 2
    assert pair.t.lanes[0].maps is not pair.t.lanes[1].maps
    qm, sm = pair.tids(SLOPPED[0]), SLOPPED[1]
    for qq, sl in [(qm, sm), (qm[:1], sm[:1])]:
        plans = tsh.PLANS[0]
        got = pair.t.score_batch_device(qq, slop=sl)
        assert tsh.PLANS[0] - plans == min(2, len(qq))
        same_bits(got, pair.want(qq, slop=sl))
    pools_in_step(pair.t, pair.single)


def test_reshard_starts_with_empty_maps():
    """``__setitem__`` re-shards on the same mesh: the new shards share
    fresh slot maps; a pickle round trip drops the sharded runtime."""
    import pickle

    docs = pin_docs()
    arr = SearchArray.index(docs, device="cpu", mesh=tmesh(), autowarm=False)
    arr.score_batch(SERVING)
    old = arr._state.sharded
    assert old.lanes[0].maps.tf_slot
    arr[5] = SearchArray.index(["alpha alpha zeta"], device="cpu",
                               autowarm=False)[0]
    new = arr._state.sharded
    assert new is not old and not new.lanes[0].maps.tf_slot
    docs[5] = "alpha alpha zeta"
    same_bits(arr.score_batch(SERVING),
              SearchArray.index(docs, device="cpu",
                                autowarm=False).score_batch(SERVING))
    assert pickle.loads(pickle.dumps(arr))._state.sharded is None


def test_a_shard_without_a_pool_keeps_the_shared_maps():
    """The shared slot maps start a pool once: a fill on a shard that has
    no pool tensor yet allocates it at the maps' capacity and takes a free
    slot, never restarting the free list that another shard's rows hold."""
    sh = tsh.ShardedIndex.build(tbuild(pin_docs()), mesh=tmesh())
    s0, s1 = sh.lanes[0].members[:2]
    maps = sh.lanes[0].maps
    assert s0.maps is s1.maps is maps and maps.plane_cap == 0
    alpha, beta = (sh.vocab.get_term_id(t) for t in ("alpha", "beta"))
    tdense.ensure_batch(s0, plane_tids=[alpha])
    cap = maps.plane_cap
    assert cap == tdense.plane_capacity(maps) > 1 and s1.plane_pool is None
    tdense.ensure_batch(s1, plane_tids=[beta])
    assert maps.plane_cap == cap and s1.plane_pool.shape[0] == cap
    assert len(set(maps.plane_slot.values())) == 2
    assert len(maps.plane_free) == cap - 2
