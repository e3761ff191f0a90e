"""Port parity, end to end through both facades: the same numpy-seeded
corpus indexed by ``searcharray_tpu.SearchArray`` and by
``searcharray_tpu_torch.SearchArray(device="cpu")``."""
import numpy as np
import pandas as pd
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import similarity as jsim
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch import SearchArray, TermsDtype
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.search import batch, dense

SIMS = ["bm25_similarity", "bm25_legacy_similarity", "bm25_impact",
        "classic_similarity"]
TERMS = ["alpha", "w0", "w44", "nope"]
QUERIES = ["alpha", "w0", "w44", "nope", "alpha", "w3", "beta", "w0",
           ["gamma"]]


def make_docs(n=700, seed=11):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta"] + [f"w{i}" for i in range(50)]
    return [" ".join(rng.choice(vocab, size=rng.integers(1, 30)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def pair():
    docs = make_docs()
    return JSearchArray.index(docs), SearchArray.index(docs, device="cpu")


@pytest.fixture(scope="module")
def long_doc_pair():
    """A corpus whose one 250k-token doc makes dense planes too large
    (blk_bits 14), so batches take the sparse term group (K2)."""
    rng = np.random.default_rng(0)
    vocab = [f"t{i}" for i in range(30)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 20)))
            for _ in range(9000)]
    docs[5] = " ".join(rng.choice(vocab, size=250_000))
    return JSearchArray.index(docs), SearchArray.index(docs, device="cpu")


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("sim", SIMS)
def test_score_matches_jax(pair, term, sim):
    jarr, tarr = pair
    want = jarr.score(term, similarity=getattr(jsim, sim)())
    got = tarr.score(term, similarity=getattr(tsim, sim)())
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("term", TERMS)
def test_term_stats_match_jax(pair, term):
    jarr, tarr = pair
    np.testing.assert_array_equal(tarr.termfreqs(term), jarr.termfreqs(term))
    np.testing.assert_array_equal(
        tarr.termfreqs(term, min_posn=18, max_posn=35),
        jarr.termfreqs(term, min_posn=18, max_posn=35))
    assert tarr.docfreq(term) == jarr.docfreq(term)
    np.testing.assert_array_equal(tarr.doclengths(), jarr.doclengths())


def test_custom_similarity_matches_jax(pair):
    jarr, tarr = pair

    def sim(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        return term_freqs * 2.0 + doc_lens / avg_doc_lens

    np.testing.assert_allclose(tarr.score("alpha", similarity=sim),
                               jarr.score("alpha", similarity=sim),
                               rtol=1e-6)


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("k", [1, 10, 50])
def test_topk_matches_jax(pair, term, k):
    jarr, tarr = pair
    ws, wi = jarr.topk(term, k=k)
    gs, gi = tarr.topk(term, k=k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("sim", SIMS)
def test_score_batch_topk_matches_jax(pair, block, sim):
    jarr, tarr = pair
    ws, wi = jarr.score_batch(QUERIES, similarity=getattr(jsim, sim)(),
                              top_k=10)
    out = tarr.score_batch(QUERIES, similarity=getattr(tsim, sim)(),
                           top_k=10, block=block)
    gs, gi = out if block else out()
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)


def test_score_batch_dense_matches_jax(pair):
    jarr, tarr = pair
    np.testing.assert_allclose(tarr.score_batch(QUERIES),
                               jarr.score_batch(QUERIES),
                               rtol=1e-6, atol=1e-7)


def test_score_batch_dedups_and_zeroes_misses(pair):
    _, tarr = pair
    before = batch.DISPATCHES[0]
    scores, idx = tarr.score_batch(["w7", "w7", "zzz", "w7"], top_k=5)
    # one tf fill at most + one group launch for the single distinct term
    assert batch.DISPATCHES[0] - before <= 2
    np.testing.assert_array_equal(scores[0], scores[1])
    np.testing.assert_array_equal(idx[0], idx[3])
    np.testing.assert_array_equal(scores[2], np.zeros(5, np.float32))
    np.testing.assert_array_equal(idx[2], np.arange(5))


def test_sliced_view_matches_jax(pair):
    jarr, tarr = pair
    jv, tv = jarr[100:400:3], tarr[100:400:3]
    np.testing.assert_allclose(tv.score("alpha"), jv.score("alpha"),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.score_batch(QUERIES),
                               jv.score_batch(QUERIES), rtol=1e-6, atol=1e-7)
    ws, wi = jv.score_batch(QUERIES, top_k=10)
    gs, gi = tv.score_batch(QUERIES, top_k=10)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    ws, _ = jv.topk("w3", k=5)
    gs, _ = tv.topk("w3", k=5)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)


def test_block_false_needs_top_k_and_full_view(pair):
    _, tarr = pair
    with pytest.raises(ValueError):
        tarr.score_batch(["alpha"], block=False)
    with pytest.raises(ValueError):
        tarr[:10].score_batch(["alpha"], top_k=3, block=False)


def test_long_docs_take_the_sparse_term_group(long_doc_pair):
    jarr, tarr = long_doc_pair
    assert tarr.dev.blk_bits == 14 and not dense.dense_eligible(tarr.dev)
    qs = ["t1", "t2", "nope", "t1", "t29"]
    before = kc.segment_sum.launches  # counts card launches only
    ws, wi = jarr.score_batch(qs, top_k=10)
    gs, gi = tarr.score_batch(qs, top_k=10)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    assert kc.segment_sum.launches == before
    np.testing.assert_allclose(tarr.score("t3"), jarr.score("t3"),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tarr.score_batch(qs), jarr.score_batch(qs),
                               rtol=1e-6, atol=1e-7)


def test_empty_corpus():
    jarr = JSearchArray.index([])
    tarr = SearchArray.index([], device="cpu")
    assert len(tarr) == len(jarr) == 0
    np.testing.assert_array_equal(tarr.score("a"), jarr.score("a"))
    scores, idx = tarr.score_batch(["a", "b"], top_k=10)
    assert scores.shape == idx.shape == (2, 0)


def test_dtype_survives_concat_and_take(pair):
    jarr, tarr = pair
    s = pd.Series(tarr)
    assert s.dtype.name == "tokenized_text_torch"
    both = pd.concat([s, s], ignore_index=True)
    assert isinstance(both.array, SearchArray)
    assert isinstance(both.dtype, TermsDtype) and len(both) == 2 * len(tarr)
    np.testing.assert_array_equal(both.array.termfreqs("alpha"),
                                  np.tile(tarr.termfreqs("alpha"), 2))
    jboth = pd.concat([pd.Series(jarr), pd.Series(jarr)], ignore_index=True)
    np.testing.assert_allclose(both.array.score("alpha"),
                               jboth.array.score("alpha"), rtol=1e-6,
                               atol=1e-7)
    taken = s.take([5, 0, 5])
    assert isinstance(taken.array, SearchArray)
    assert taken.array[0] == tarr[5] and taken.array[1] == tarr[0]
    np.testing.assert_allclose(taken.array.score("alpha"),
                               tarr.score("alpha")[[5, 0, 5]], rtol=1e-6)
    filled = tarr.take([1, -1], allow_fill=True)
    assert isinstance(filled, SearchArray)
    assert filled[0] == tarr[1] and len(filled[1]) == 0
    assert list(filled.isna()) == [False, True]
    assert tarr.copy().device == "cpu" and filled.device == "cpu"


@pytest.mark.parametrize("other", ["same rows", "one row differs",
                                   "shorter", "empty", "empty both",
                                   "scalar"])
def test_eq_against_a_list_like_matches_jax(other):
    """``SearchArray == list``: a SearchArray is built from the list and
    compared row by row; a length mismatch is False, empty input an empty
    bool array, anything else all False."""
    from searcharray_tpu.pandas_ext.array import Terms as JTerms
    from searcharray_tpu_torch import Terms

    docs = ["alpha beta", "beta gamma epsilon", "", "delta"]
    jarr, tarr = JSearchArray.index(docs), SearchArray.index(docs,
                                                             device="cpu")
    if other == "empty both":
        jarr, tarr = jarr[:0], tarr[:0]

    def rows(terms_cls, arr):
        out = [terms_cls(dict(arr[i].terms()), doc_len=arr[i].doc_len)
               for i in range(len(arr))]
        if other == "one row differs":
            out[1] = terms_cls({"beta": 1}, doc_len=1)
        elif other == "shorter":
            out = out[:-1]
        elif other == "empty":
            out = []
        return out

    if other == "scalar":
        want, got = jarr == 7, tarr == 7
    else:
        want, got = jarr == rows(JTerms, jarr), tarr == rows(Terms, tarr)
    if other in ("shorter", "empty"):
        assert want is False and got is False
        return
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, np.asarray(want, dtype=bool))
    if other == "same rows":
        assert got.all() and len(got) == 4
    elif other == "one row differs":
        assert got.tolist() == [True, False, True, True]


def test_pool_exhaustion_raises_like_jax(monkeypatch):
    monkeypatch.setattr(jdense, "TF_POOL_MAX_SLOTS", 16)
    monkeypatch.setattr(dense, "TF_POOL_MAX_SLOTS", 16)
    docs = make_docs(seed=3)
    jarr = JSearchArray.index(docs, autowarm=False)
    tarr = SearchArray.index(docs, device="cpu", autowarm=False)
    assert dense.tf_capacity(tarr.dev) == jdense.tf_capacity(jarr.dev) == 16
    tids = list(range(17))
    with pytest.raises(RuntimeError, match="exhausted"):
        jdense.ensure_tfs(jarr.dev, tids)
    with pytest.raises(RuntimeError, match="exhausted"):
        dense.ensure_tfs(tarr.dev, tids)
    # the port fails before assigning any slot (the JAX package keeps the
    # first 16 assignments, for rows it never filled)
    assert len(tarr.dev.maps.tf_slot) == 0
    # a batch wider than the pool splits into waves in both packages (on
    # a fresh JAX index: the one above keeps its stale assignments)
    qs = [f"w{i}" for i in range(40)]
    ws, wi = JSearchArray.index(docs, autowarm=False).score_batch(qs, top_k=5)
    gs, gi = tarr.score_batch(qs, top_k=5)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("call", ["phrase_score", "phrase_batch",
                                  "setitem", "positions", "mesh",
                                  "data_dir"])
def test_unported_parts_raise(pair, call, tmp_path):
    jarr, tarr = pair
    if call == "phrase_score":
        # ported: a windowed phrase takes the sparse chain
        got = tarr.score(["alpha", "beta"], min_posn=0, max_posn=17)
        np.testing.assert_allclose(
            got, jarr.score(["alpha", "beta"], min_posn=0, max_posn=17),
            rtol=1e-6, atol=1e-7)
        assert got.max() > 0
        return
    if call == "phrase_batch":
        # ported: a slop phrase in a batch takes the dense window kernel
        ws, wi = jarr.score_batch([["alpha", "beta"]], top_k=3, slop=2)
        gs, gi = tarr.score_batch([["alpha", "beta"]], top_k=3, slop=2)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
        assert gs[0, 0] > 0
        # ported too: a window wider than a slot takes the sparse kernel
        ws, wi = jarr.score_batch([["alpha", "beta"]], top_k=3, slop=20)
        gs, gi = tarr.score_batch([["alpha", "beta"]], top_k=3, slop=20)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
        assert gs[0, 0] > 0
        # ported too: scores over a subset of rows
        rows = np.arange(0, len(tarr), 3)
        got = tarr.score_batch_device([["alpha", "beta"], "alpha"],
                                      rows=rows)
        want = np.asarray(jarr.score_batch_device(
            [["alpha", "beta"], "alpha"], rows=rows))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        assert got.shape == (2, len(rows)) and got.max() > 0
        return
    if call == "setitem":
        # ported: an assignment re-indexes the row as the JAX package does
        # (on copies: the fixture's arrays stay as they are)
        jm, tm = jarr.copy(), tarr.copy()
        jm[0] = JSearchArray.index(["alpha zeta"])[0]
        tm[0] = SearchArray.index(["alpha zeta"], device="cpu")[0]
        for q in ("zeta", "alpha", ["alpha", "zeta"]):
            np.testing.assert_array_equal(tm.score(q), jm.score(q))
        assert tm.score("zeta")[0] > 0 and tarr.docfreq("zeta") == 0
        return
    if call == "positions":
        # ported: the positions of a term per row, as the JAX package's
        for got, want in zip(tarr.positions("alpha"), jarr.positions("alpha")):
            np.testing.assert_array_equal(got, want)
        return
    if call == "data_dir":
        # ported: the postings memory-mapped from a file under data_dir
        docs = make_docs(n=50, seed=5)
        arr = SearchArray.index(docs, device="cpu", data_dir=str(tmp_path))
        assert arr._built.postings.mmap_path.startswith(str(tmp_path))
        np.testing.assert_array_equal(
            arr.score("alpha"), SearchArray.index(docs, device="cpu")
            .score("alpha"))
        return
    # ported (item 14): a mesh of CPU devices shards the index, and
    # score_batch answers as the JAX package's sharded array does
    from searcharray_tpu.parallel.sharded import default_mesh as jmesh
    from searcharray_tpu_torch.parallel.sharded import default_mesh

    docs = make_docs(n=50, seed=5)
    arr = SearchArray.index(docs, device="cpu",
                            mesh=default_mesh(devices=["cpu"] * 8))
    assert arr._state.sharded.num_shards == 4
    jsharded = JSearchArray.index(docs, mesh=jmesh())
    qs = ["alpha", ["alpha", "beta"]]
    gs, gi = arr.score_batch(qs, top_k=3)
    ws, wi = jsharded.score_batch(qs, top_k=3)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)


def test_index_defaults_to_cuda_and_is_lazy():
    arr = SearchArray.index(["a b", "b c"], autowarm=False)
    assert arr.device == "cuda"
    assert arr._state.dev is None  # nothing touched a device yet
