"""Port parity for doc-axis sharding (``parallel/sharded.py``).

The JAX package's ``ShardedIndex`` runs on the 8 virtual CPU devices of
tests/conftest.py (``default_mesh()``: 4 doc shards x 2 query parts); the
port's on ``default_mesh(devices=["cpu"] * 8)``, the same layout, with the
kernels' plain versions.  Each case of tests/test_sharded.py holds the
port to the JAX package (scores rtol 1e-6, freqs exact, top-k indices
equal) and to the port's unsharded index, bit for bit; then the
partition array for array, uneven and empty shards, ties across shard
edges, ``rows=``, forced candidate routes, per-shard pools, the shard
store both ways and the merge's width."""
import numpy as np
import pytest
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.index import store as jstore
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
from searcharray_tpu_torch.search import phrase as tphrase
from searcharray_tpu_torch.search import spans as tspans
from test_sharded import make_corpus

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def jax_programs_left_as_found():
    """The JAX sharded module caches its programs by shape in a module
    dict, and tests/test_sharded.py counts the programs a batch adds to
    it; the programs this module's JAX calls built go when it ends, so a
    later module in the same process finds the cache as it was."""
    before = set(jsh._pool_cache)
    yield
    for key in set(jsh._pool_cache) - before:
        del jsh._pool_cache[key]


def tmesh():
    return tsh.default_mesh(devices=[torch.device("cpu")] * 8)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def same_bits(got, want, what=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=str(what))


class Trio:
    """One corpus as a JAX ShardedIndex, a port ShardedIndex and a port
    unsharded array (on the CPU)."""

    def __init__(self, docs):
        self.docs = docs
        self.j = jsh.ShardedIndex.build(jbuild(docs), mesh=jsh.default_mesh())
        self.t = tsh.ShardedIndex.build(tbuild(docs), mesh=tmesh())
        self.single = SearchArray.index(docs, device="cpu", autowarm=False)

    def tids(self, queries):
        tid = self.single._resolve_tid
        return [[tid(t) for t in ([q] if isinstance(q, str) else q)]
                for q in queries]


@pytest.fixture(scope="module")
def corpus():
    return make_corpus()


@pytest.fixture(scope="module")
def trio(corpus):
    return Trio(corpus)


def test_mesh_layout():
    mesh = tmesh()
    assert mesh.shape == dict(jsh.default_mesh().shape)
    assert mesh.devices.size == 8
    assert tsh.default_mesh(devices=["cpu"] * 3).shape == {"docs": 3,
                                                            "queries": 1}
    sharded = tsh.ShardedIndex.build(tbuild(make_corpus(40)), mesh=mesh)
    # entries that repeat a device share one DeviceIndex, pools included,
    # and the four shards on one device divide its pools' budgets
    assert [len(reps) for reps in sharded.shards] == [1, 1, 1, 1]
    assert all(d.pool_share == 4 for d in sharded.device_indexes())


@pytest.mark.parametrize("n_docs,S", [(400, 4), (397, 4), (3, 4), (400, 1),
                                      (41, 3)])
def test_partition_equals_jax(corpus, n_docs, S):
    docs = corpus[:n_docs]
    got = tsh.ShardedIndex.partition(tbuild(docs), S)
    want = jsh.ShardedIndex.partition(jbuild(docs), S)
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(value), err_msg=name)


# (tests/test_sharded.py case, queries) of score_queries
QUERY_CASES = {
    "single_term": [["alpha"]],
    "multi_term_or": [["alpha", "gamma", "zeta"]],
    "query_batch": [["alpha"], ["beta", "gamma"], ["missingterm"],
                    ["eta", "eta"]],
}


@pytest.mark.parametrize("case", list(QUERY_CASES))
def test_score_queries(trio, case):
    queries = QUERY_CASES[case]
    got = trio.t.score_queries(queries).numpy()
    np.testing.assert_allclose(got, np.asarray(trio.j.score_queries(queries)),
                               **TOL)
    for g, q in zip(got, queries):
        want = np.zeros(len(trio.docs), np.float32)
        for t in q:
            want = want + trio.single.score(t)
        same_bits(g, want, q)


def test_uneven_corpus_sizes(corpus):
    trio = Trio(corpus[:397])
    got = trio.t.score_queries([["delta"]]).numpy()[0]
    assert got.shape == (397,)
    np.testing.assert_allclose(
        got, np.asarray(trio.j.score_queries([["delta"]]))[0], **TOL)
    same_bits(got, trio.single.score("delta"))


# (tests/test_sharded.py case, tokens, slop or None for an exact phrase,
# kind)
FREQ_CASES = [
    ("phrase", ["alpha", "beta"], None, "none"),
    ("phrase_score", ["alpha", "beta"], None, "bm25"),
    ("trigram", ["alpha", "beta", "gamma"], None, "none"),
    ("missing_term", ["alpha", "notthere"], None, "none"),
    ("slop", ["alpha", "beta"], 2, "none"),
    ("slop_score", ["alpha", "gamma"], 3, "bm25"),
    ("slop_repeated_term", ["alpha", "alpha"], 2, "none"),
    ("slop_wide", ["beta", "zeta", "eta"], 25, "none"),
]


@pytest.mark.parametrize("case", FREQ_CASES, ids=[c[0] for c in FREQ_CASES])
def test_phrase_and_span_freqs(trio, case):
    _, tokens, slop, kind = case
    if slop is None:
        got = trio.t.phrase_freqs(tokens, kind=kind).numpy()
        want_j = np.asarray(trio.j.phrase_freqs(tokens, kind=kind))
        want_t = (trio.single.termfreqs(tokens) if kind == "none"
                  else trio.single.score(tokens))
    else:
        got = trio.t.span_freqs(tokens, slop, kind=kind).numpy()
        want_j = np.asarray(trio.j.span_freqs(tokens, slop, kind=kind))
        want_t = (trio.single.termfreqs(tokens, slop=slop) if kind == "none"
                  else trio.single.score(tokens, slop=slop))
    if kind == "none":
        np.testing.assert_array_equal(got, want_j)
    else:
        np.testing.assert_allclose(got, want_j, **TOL)
    same_bits(got, want_t, tokens)
    if tokens[-1] == "notthere":
        assert not got.any()
    else:
        assert got.max() > 0


@pytest.mark.parametrize("tokens,slop", [
    (["notthere"], None), (["notthere"], 1), (["notthere", "alpha"], None),
    (["alpha", "notthere"], 2), (["notthere", "nowhere", "alpha"], 1)])
def test_freqs_with_a_missing_token_are_zeros(trio, tokens, slop):
    """A token outside the vocabulary gives zeros, however many tokens
    the phrase has, as the JAX module's freqs do (checked before the
    phrase's length)."""
    if slop is None:
        got = trio.t.phrase_freqs(tokens).numpy()
        want = np.asarray(trio.j.phrase_freqs(tokens))
    else:
        got = trio.t.span_freqs(tokens, slop).numpy()
        want = np.asarray(trio.j.span_freqs(tokens, slop))
    assert got.shape == want.shape == (len(trio.docs),)
    np.testing.assert_array_equal(got, want)
    assert not got.any()


@pytest.mark.parametrize("slop", [None, 0, 2])
def test_freqs_of_one_token_raise(trio, slop):
    """A phrase of one known token is no phrase: both freqs raise, as the
    unsharded port's do (the JAX module's phrase_freqs raises too; its
    span_freqs returns a row)."""
    tid = trio.tids([["alpha"]])[0]
    for fn in ((lambda: trio.t.phrase_freqs(["alpha"]),
                lambda: tphrase.phrase_freqs_dense(trio.single.dev, tid))
               if slop is None else
               (lambda: trio.t.span_freqs(["alpha"], slop),
                lambda: tspans.span_freqs_dense(trio.single.dev, tid, slop))):
        with pytest.raises(ValueError, match="at least two terms"):
            fn()
    if slop is None:
        with pytest.raises(Exception):
            trio.j.phrase_freqs(["alpha"])


def ranked_equal(got, want, k):
    """Top-k scores within the tolerance, indices equal where the k-th
    score is above 0 (the zero tail ties)."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gs, ws, **TOL)
    for q in range(len(gi)):
        if ws[q, k - 1] > 0:
            np.testing.assert_array_equal(gi[q], wi[q])


def test_topk_queries(trio):
    queries = [["alpha"], ["beta", "gamma"], ["zeta", "theta"]]
    got = trio.t.topk_queries(queries, k=5)
    assert got[0].shape == (3, 5) and got[1].dtype == np.int64
    ranked_equal(got, trio.j.topk_queries(queries, k=5), 5)
    dense = trio.t.score_queries(queries).numpy()
    for q in range(3):
        order = np.lexsort((np.arange(dense.shape[1]), -dense[q]))[:5]
        np.testing.assert_array_equal(got[1][q], order)


def test_topk_fn_matches_host_argsort(trio):
    dense = trio.t.score_queries([["alpha", "delta"], ["zeta"]])
    scores, idx = trio.t.topk_fn(dense.shape, 7)(dense)
    host = dense.numpy()
    for q in range(2):
        order = np.lexsort((np.arange(host.shape[1]), -host[q]))[:7]
        same_bits(scores[q].numpy(), host[q][order])
        np.testing.assert_array_equal(idx[q].numpy(), order)
    jdense = trio.j.score_queries([["alpha", "delta"], ["zeta"]])
    ranked_equal((scores, idx), trio.j.topk_fn(jdense.shape, 7)(jdense), 7)


# score_batch_device batches: (name, queries, slop)
BATCHES = [
    ("bigrams", [["alpha", "beta"], ["gamma", "delta"], ["eps", "zeta"]] * 3
     + [["alpha", "beta", "gamma"], "alpha", "beta", "missingterm"], 0),
    ("same_term", [["eta", "eta"], ["alpha", "alpha", "beta"]], 0),
    ("slop1", [["alpha", "beta"], ["gamma", "delta"], ["eta", "eta"],
               ["alpha", "beta", "alpha"], "alpha", ["alpha", "missing"]], 1),
    ("slop3", [["alpha", "beta"], ["gamma", "delta"], ["eta", "eta"],
               ["alpha", "beta", "alpha"], "alpha", ["alpha", "missing"]], 3),
    ("slop25", [["alpha", "beta"], ["gamma", "delta"]], 25),
    ("mixed_slop", ["alpha", ["alpha", "beta"], ["alpha", "beta"],
                    ["gamma", "delta"]], [0, 0, 2, 1]),
]


@pytest.mark.parametrize("name,queries,slop", BATCHES,
                         ids=[b[0] for b in BATCHES])
def test_score_batch_device(trio, name, queries, slop):
    qt = trio.tids(queries)
    got = trio.t.score_batch_device(qt, slop=slop)
    assert got.shape == (len(queries), len(trio.docs))
    want_t = batch.score_batch_fused(trio.single.dev, qt, slop=slop)
    same_bits(got.numpy(), want_t, name)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(trio.j.score_batch_device(qt, slop=slop)),
        **TOL)
    # ranked per shard and merged: the unsharded index's top-k
    vals, idx = trio.t.topk(qt, 5, slop=slop)
    wv, wi = batch.score_batch_fused(trio.single.dev, qt, top_k=5, slop=slop)
    np.testing.assert_array_equal(idx.numpy(), wi)
    same_bits(vals.numpy(), wv)


@pytest.mark.parametrize("name,queries,slop", BATCHES[:1] + BATCHES[-1:],
                         ids=["bigrams", "mixed_slop"])
def test_facade_score_batch(corpus, name, queries, slop):
    """The facade on a mesh against the JAX package's facade on one."""
    arr = SearchArray.index(corpus, device="cpu", mesh=tmesh(),
                            autowarm=False)
    jarr = JSearchArray.index(corpus, mesh=jsh.default_mesh(),
                              autowarm=False)
    single = SearchArray.index(corpus, device="cpu", autowarm=False)
    got = arr.score_batch(queries, slop=slop)
    np.testing.assert_allclose(got, jarr.score_batch(queries, slop=slop),
                               **TOL)
    same_bits(got, single.score_batch(queries, slop=slop))
    gs, gi = arr.score_batch(queries, top_k=5, slop=slop)
    ranked_equal((gs, gi), jarr.score_batch(queries, top_k=5, slop=slop), 5)
    ss, si = single.score_batch(queries, top_k=5, slop=slop)
    np.testing.assert_array_equal(gi, si)
    same_bits(gs, ss)


def test_empty_shard_and_uneven_shards():
    """3 docs on 4 shards: the last shard holds none; 397 docs: the last
    holds 97."""
    for docs in (["alpha beta", "beta alpha alpha", "gamma"],
                 make_corpus(397, seed=3)):
        trio = Trio(docs)
        sizes = trio.t.shard_sizes
        assert sizes.sum() == len(docs) and sizes[-1] == (
            len(docs) - 3 * -(-len(docs) // 4))
        qt = trio.tids(["alpha", ["alpha", "beta"], ["beta", "alpha"],
                        "gamma", "nope"])
        for slop in (0, 2):
            got = trio.t.score_batch_device(qt, slop=slop).numpy()
            same_bits(got, batch.score_batch_fused(trio.single.dev, qt,
                                                   slop=slop))
            np.testing.assert_allclose(
                got, np.asarray(trio.j.score_batch_device(qt, slop=slop)),
                **TOL)
        k = min(5, len(docs))
        vals, idx = trio.t.topk(qt, k)
        wv, wi = batch.score_batch_fused(trio.single.dev, qt, top_k=k)
        np.testing.assert_array_equal(idx.numpy(), wi)
        rows = np.arange(len(docs))[::-1]
        same_bits(trio.t.score_batch_device(qt, rows=rows).numpy(),
                  batch.score_batch_fused(trio.single.dev, qt)[:, rows])


def test_ties_across_shard_edges():
    """Equal scores planted on both sides of every shard edge: the merge
    returns the smallest doc ids among them, as K3 on the whole axis
    (and the JAX package) does."""
    docs = make_corpus(400, seed=9)
    for d in (0, 99, 100, 101, 199, 200, 299, 300, 399):
        docs[d] = "tie tie alpha"
    trio = Trio(docs)
    qt = trio.tids(["tie", ["tie", "alpha"], ["tie", "tie"]])
    vals, idx = trio.t.topk(qt, 5)
    np.testing.assert_array_equal(idx.numpy(), [[0, 99, 100, 101, 199]] * 3)
    wv, wi = batch.score_batch_fused(trio.single.dev, qt, top_k=5)
    np.testing.assert_array_equal(idx.numpy(), wi)
    same_bits(vals.numpy(), wv)
    jd = trio.j.score_batch_device(qt)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(trio.j.topk_fn(jd.shape, 5)(jd)[1]))


def test_rows_scoring(corpus):
    docs = list(corpus)
    docs[5] = "alpha beta gamma alpha beta"
    docs[371] = "alpha beta eta"
    trio = Trio(docs)
    qt = trio.tids([["alpha", "beta"], "alpha", ["alpha", "beta", "gamma"],
                    ["beta", "beta"], "nope", "alpha"])
    rows = np.flatnonzero(trio.single.score("alpha") > 0)
    assert len(rows) > 8
    dense = trio.t.score_batch_device(qt).numpy()
    perm = np.random.default_rng(3).permutation(len(rows))
    for r in (rows, rows[perm]):
        got = trio.t.score_batch_device(qt, rows=r).numpy()
        same_bits(got, dense[:, r])
        same_bits(got, batch.score_batch_fused(trio.single.dev, qt,
                                               rows=np.sort(r))[
            :, np.argsort(np.argsort(r))])
        np.testing.assert_allclose(
            got, np.asarray(trio.j.score_batch_device(qt, rows=r)), **TOL)
    with pytest.raises(ValueError):
        trio.t.score_batch_device(qt, rows=rows, slop=2)
    with pytest.raises(ValueError):
        trio.t.score_batch_device(qt, rows=[len(docs)])


def test_candidate_routing_forced(corpus, monkeypatch):
    """The candidate thresholds patched to 0 on both packages: rare
    queries take cterm / cphrase / cspan on every shard, the results
    equal the dense routes bit for bit and the JAX package's forced
    routes within the tolerance."""
    docs = list(corpus)
    docs[13] = "alpha rareterm beta alpha rareterm beta"
    docs[321] = "rareterm gamma rareterm beta"
    trio = Trio(docs)
    qt = trio.tids([["rareterm"], ["alpha"], ["rareterm", "beta"],
                    ["alpha", "beta"], ["rareterm", "gamma"],
                    ["alpha", "beta", "alpha"]])
    slops = [0, 0, 0, 0, 2, 0]
    want = trio.t.score_batch_device(qt, slop=slops).numpy()
    wv, wi = trio.t.topk(qt, 3, slop=slops)
    for mod in (tcand, jcand):
        monkeypatch.setattr(mod, "CAND_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "CAND_TERM_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "CAND_MAX_FRAC", 0)
    before = tsh.CAND_PROGRAMS[0]
    got = trio.t.score_batch_device(qt, slop=slops).numpy()
    n_cand = tsh.CAND_PROGRAMS[0] - before
    jbefore = jsh.CAND_PROGRAMS[0]
    jgot = np.asarray(trio.j.score_batch_device(qt, slop=slops))
    # one program a candidate chunk for every shard, as the JAX module
    # counts: the cterm, cphrase and cspan groups' chunks
    assert n_cand == jsh.CAND_PROGRAMS[0] - jbefore >= 3
    same_bits(got, want)
    np.testing.assert_allclose(got, jgot, **TOL)
    gv, gi = trio.t.topk(qt, 3, slop=slops)
    same_bits(gv.numpy(), wv.numpy())
    # both routes rank the same docs wherever the 3rd score is above 0
    for q in range(len(qt)):
        if wv[q, -1] > 0:
            np.testing.assert_array_equal(gi[q].numpy(), wi[q].numpy())


def test_shard_pool_residency_and_eviction(corpus, monkeypatch):
    """Repeated batches reuse each shard's pool-resident planes and tf
    rows (no slot moves); a plane pool of two slots sends the phrases to
    the sparse chain with the same scores."""
    trio = Trio(corpus)
    qt = trio.tids([["alpha", "beta"], ["gamma", "delta"]] * 2
                   + ["alpha", "gamma", "zeta"])
    want = trio.t.score_batch_device(qt).numpy()
    shards = trio.t.device_indexes()
    assert all(d.plane_pool is not None and d.tf_pool is not None
               for d in shards)
    planes = [dict(d.maps.plane_slot) for d in shards]
    tfs = [dict(d.maps.tf_slot) for d in shards]
    same_bits(trio.t.score_batch_device(qt).numpy(), want)
    assert [dict(d.maps.plane_slot) for d in shards] == planes
    assert [{k: v for k, v in d.maps.tf_slot.items()
             if not isinstance(k, tuple)} for d in shards] == tfs
    monkeypatch.setattr(tdense, "PLANE_POOL_MAX_SLOTS", 2)
    fresh = tsh.ShardedIndex.build(tbuild(corpus), mesh=tmesh())
    same_bits(fresh.score_batch_device(qt).numpy(), want)
    assert all(d.plane_pool is None for d in fresh.device_indexes())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_store_both_ways(corpus, tmp_path, writer):
    """A store (index and S=4 partition) written by either package loads
    in the other, memory-mapped, and answers as the built index does."""
    jarr = JSearchArray.index(corpus, autowarm=False)
    tarr = SearchArray.index(corpus, device="cpu", autowarm=False)
    d = str(tmp_path)
    if writer == "jax":
        jstore.save_index(jarr._built, d)
        jstore.save_shards(jarr._built, d, 4)
    else:
        tstore.save_index(tarr._built, d)
        tstore.save_shards(tarr._built, d, 4)
    built = tsh.ShardedIndex.build(tarr._built, mesh=tmesh())
    loaded = tsh.ShardedIndex.load(d, mesh=tmesh())
    for a, b in zip(loaded.device_indexes(), built.device_indexes()):
        assert torch.equal(a.hdrs, b.hdrs) and torch.equal(a.pays, b.pays)
        np.testing.assert_array_equal(a.postings.data, b.postings.data)
    qt = [[tarr._resolve_tid(t) for t in q]
          for q in (["alpha"], ["alpha", "beta"], ["eta", "eta"])]
    for slop in (0, 2):
        same_bits(loaded.score_batch_device(qt, slop=slop).numpy(),
                  built.score_batch_device(qt, slop=slop).numpy())
    jloaded = jsh.ShardedIndex.load(d, mesh=jsh.default_mesh())
    np.testing.assert_allclose(
        np.asarray(jloaded.score_batch_device(qt)),
        loaded.score_batch_device(qt).numpy(), **TOL)
    with pytest.raises(FileNotFoundError):
        tstore.load_shards(d, 7)


def test_merge_stays_narrow(trio, monkeypatch):
    """Every K3 call of a sharded top-k after the per-shard ones ranks at
    most S * k candidates a query, never the doc axis."""
    calls = []
    topk = kc.topk

    def spy(x, k):
        calls.append(tuple(x.shape))
        return topk(x, k)

    monkeypatch.setattr(kc, "topk", spy)
    qt = trio.tids(["alpha", ["alpha", "beta"], ["eta", "eta"]])
    S, k = trio.t.num_shards, 6
    merges = tsh.TOPK_MERGES[0]
    trio.t.topk(qt, k, slop=[0, 0, 2])
    per_shard = [c for c in calls if c[-1] == trio.t.max_shard_docs]
    assert len(per_shard) == S
    merge = calls[len(per_shard):]
    assert merge == [(3, S * k)]
    assert max(c[-1] for c in merge) < len(trio.docs)
    assert tsh.TOPK_MERGES[0] == merges + 1


@pytest.mark.parametrize("tail", ["pad", "word", "payload", "short"])
def test_a_shard_row_attaches_only_with_a_pad_tail(corpus, tail,
                                                   monkeypatch):
    """A shard row runs on past its shard's words and bucket pad to the
    partition's width; that tail is cut only where every entry is pad
    (PAD_HDR32 headers, zero payloads).  A row with a word or a payload
    past the shard's words, or too short, is stale and derived again."""
    from searcharray_tpu_torch.index import device as tdevice
    from searcharray_tpu_torch.ops.kernels import PAD_HDR32

    built = tbuild(corpus)
    stats = (built.vocab, built.avg_doc_length, built.doc_freqs)
    parts = tsh.ShardedIndex.partition(built, 4)
    W = int(np.asarray(parts["lengths"][0]).sum())
    hdrs, pays = parts["hdrs"].copy(), parts["pays"].copy()
    want = tsh.ShardedIndex._from_parts(parts, tmesh(), *stats).shards[0][0]
    assert hdrs.shape[1] > W + want.max_bucket   # a longer tail than a store's
    if tail == "word":
        hdrs[0, -1] = hdrs[0, 0]
    elif tail == "payload":
        pays[0, -1] = 1
    elif tail == "short":
        hdrs, pays = hdrs[:, :W + 1], pays[:, :W + 1]
    assert hdrs[0, W] == PAD_HDR32
    derived = []
    derive = tdevice.derive_attach_arrays
    monkeypatch.setattr(tdevice, "derive_attach_arrays",
                        lambda *a, **kw: derived.append(1) or derive(*a, **kw))
    got = tsh.ShardedIndex._from_parts(
        {**parts, "hdrs": hdrs, "pays": pays}, tmesh(), *stats).shards[0][0]
    # rows changed: none, shard 0's, or every shard's (cut short)
    stale = {"pad": 0, "word": 1, "payload": 1, "short": 4}[tail]
    assert len(derived) == stale
    assert torch.equal(got.hdrs, want.hdrs)
    assert torch.equal(got.pays, want.pays)
