"""Port parity for slop phrases on the dense plane engine: K6's plain
version against the JAX package's window program on random planes, and
the facade (``termfreqs``, ``score``, ``score_batch``, ``topk`` with
``slop``) against the JAX facade on one numpy-seeded index, which
``from_numpy_state`` carries from the JAX build into the port.  The slop
queries the dense window kernel cannot take run the sparse neighbourhood
kernel's plain version (K9) and are held to the JAX facade too, with both
pools left as they were."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import similarity as jsim
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch.index.device import from_numpy_state
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.pandas_ext.array import _IndexState
from searcharray_tpu_torch.search import batch, dense, spans
from test_slop import SLOP_CASES, simple_tokenizer
from test_torch_build import numpy_state
from test_torch_phrase import crafted_pair, random_planes

SIMS = ["bm25_similarity", "bm25_legacy_similarity", "bm25_impact",
        "classic_similarity"]


def carried_pair(docs, tokenizer=None, **kw):
    """The JAX package's array over ``docs`` and the port's array over the
    same built index, carried across as numpy arrays."""
    tok = {} if tokenizer is None else {"tokenizer": tokenizer}
    jarr = JSearchArray.index(docs, **tok, **kw)
    tdev = from_numpy_state(numpy_state(jarr._built), "cpu")
    tarr = SearchArray([], device="cpu", **tok)
    tarr._attach(_IndexState(tdev.built, "cpu", tdev))
    return jarr, tarr


def pool_state(dev):
    m = dev.maps
    return (dict(m.plane_slot), dict(m.tf_slot), list(m.plane_free),
            list(m.tf_free), dict(m.phrase_hits), dict(m.phrase_recipes))


# ---------------------------------------------------------------------------
# K6's plain version on random planes
# ---------------------------------------------------------------------------
SPANS = [
    # (terms as planes, multiplicities, anchor)
    ([0, 1], (1, 1), 0), ([0, 1], (1, 1), 1), ([2], (2,), 0),
    ([0, 1, 2], (1, 1, 1), 2), ([0, 1], (2, 1), 1), ([3, 1, 2], (2, 1, 2), 0),
    ([0, 1, 2, 3, 4], (1,) * 5, 3), ([5, 4, 3, 2, 1, 0], (1, 2, 1, 1, 2, 1), 4),
]


@pytest.mark.parametrize("slots", [1, 2, 8])
@pytest.mark.parametrize("w", [1, 2, 4, 9, 14, 15, 17, 18])
@pytest.mark.parametrize("terms,mults,anchor", SPANS)
def test_window_plain_matches_jax(terms, mults, anchor, w, slots):
    num_docs = 257
    planes = random_planes(w * 10 + slots + len(terms), 6, num_docs, slots)
    # sparse enough that not every window holds every term
    planes[np.random.default_rng(w).random(planes.shape) < 0.6] = 0
    want = np.asarray(jdense.span_counts_dense_planes(
        [jnp.asarray(planes[t]) for t in terms], anchor, w, num_docs, slots,
        mults=mults))
    pool = torch.from_numpy(planes.view(np.int32))
    got = K.span_counts_dense_planes_plain([pool[t] for t in terms], anchor,
                                           w, num_docs, slots, mults=mults)
    np.testing.assert_array_equal(got.numpy(), want)
    # the K6 wrapper's CPU path: two queries, rows of a larger f32 table
    out = torch.full((4, num_docs), -1.0)
    blk_bits = slots.bit_length() - 1
    before = kc.span_window.launches
    kc.span_window(pool, [terms, terms], w, mults, anchor=anchor,
                   num_docs=num_docs, blk_bits=blk_bits, out=out,
                   out_rows=[3, 1])
    assert kc.span_window.launches == before  # the CPU launches nothing
    np.testing.assert_array_equal(out[[3, 1]].numpy(), np.stack([want] * 2))
    assert (out[[0, 2]] == -1).all()


def test_window_plain_defaults_to_multiplicity_one():
    planes = random_planes(3, 2, 100, 2)
    pool = torch.from_numpy(planes.view(np.int32))
    want = np.asarray(jdense.span_counts_dense_planes(
        [jnp.asarray(p) for p in planes], 0, 5, 100, 2))
    got = K.span_counts_dense_planes_plain(list(pool), 0, 5, 100, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_wrapper_rejects_what_the_kernel_does_not_take():
    pool = torch.zeros((3, 80), dtype=torch.int32)
    kw = dict(num_docs=10, blk_bits=3)
    with pytest.raises(ValueError, match="window"):
        kc.span_window(pool, [[0, 1]], 19, (1, 1), **kw)
    with pytest.raises(ValueError, match="window"):
        kc.span_window(pool, [[0, 1]], 0, (1, 1), **kw)
    with pytest.raises(ValueError, match="multiplicities"):
        kc.span_window(pool, [[0, 1]], 4, (1, 3), **kw)
    with pytest.raises(ValueError, match="multiplicity"):
        kc.span_window(pool, [[0, 1]], 4, (1,), **kw)
    with pytest.raises(ValueError, match="anchor"):
        kc.span_window(pool, [[0, 1]], 4, (1, 1), anchor=2, **kw)
    with pytest.raises(ValueError, match="out of range"):
        kc.span_window(pool, [[0, 3]], 4, (1, 1), **kw)
    with pytest.raises(ValueError, match="distinct row"):
        kc.span_window(pool, [[0, 1], [1, 2]], 4, (1, 1),
                       out=torch.zeros((2, 10)), out_rows=[1, 1], **kw)
    with pytest.raises(ValueError):
        K.span_counts_dense_planes_plain([pool[0]], 0, 4, 10, 8, mults=(3,))


@pytest.mark.parametrize("anchor", [0, 1])
def test_last_slot_bit17_window_reads_across_the_doc_boundary(anchor):
    """The shifts run over the flat slot axis, so "a" at the last position
    of doc 0's last slot and "b" at position 0 of doc 1 are one apart: the
    JAX package counts the anchor there, and so must the port."""
    jdev, tdev = crafted_pair()
    tids = [0, 1][::1 - 2 * anchor]
    for slop in (1, 5, 17):
        want = np.asarray(jdense.score_span_dense(
            jdev, tids, 0, len(tids) + slop - 1, "none", 1.2, 0.75, 1.0))
        # a one-query batch: the ``dspan`` group, K6 on pooled planes, its
        # anchor the query's first term (both terms have one word)
        assert spans.takes_dense_span(tdev, tids, slop)
        assert spans.anchor_of(tdev, tids) == 0
        got = batch.score_batch_fused(tdev, [tids], "none", slop=[slop],
                                      as_device=True)[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == 1
        assert set(tdev.maps.plane_slot) == set(tids)


# ---------------------------------------------------------------------------
# the facade against the JAX facade
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SLOP_CASES))
def test_slop_scenarios(name):
    phrase, doc, slop, match = SLOP_CASES[name]
    jarr, tarr = carried_pair([doc, " empty ", doc + " " + doc, " empty"] * 25,
                              tokenizer=simple_tokenizer)
    toks = simple_tokenizer(phrase)
    sparse = name == "same_term_far_apart_no_match"  # a term three times
    for s in range(slop, max(slop, 10)):
        if s == 0:
            continue  # slop 0 is the exact phrase (test_torch_phrase.py)
        if sparse or len(toks) + s - 1 > 18:
            # the sparse kernel's query: no pool is touched
            before = pool_state(tarr.dev)
            tarr.score(toks, slop=s)
            assert pool_state(tarr.dev) == before
        want = jarr.score(toks, slop=s)
        got = tarr.score(toks, slop=s)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(tarr.termfreqs(toks, slop=s),
                                      jarr.termfreqs(toks, slop=s))
        assert np.all((got[::2] > 0) == match), f"slop {s}"
        assert np.all(got[1::2] == 0), f"slop {s} matched an empty doc"


@pytest.mark.parametrize("off", [14, 15, 16, 17, 18])
def test_slop_cross_block_boundary(off):
    doc = " ".join(["pad"] * off) + " alpha gap gap beta"
    jarr, tarr = carried_pair([doc, "nothing here"])
    got = tarr.termfreqs(["alpha", "beta"], slop=2)
    np.testing.assert_array_equal(got,
                                  jarr.termfreqs(["alpha", "beta"], slop=2))
    assert got[0] > 0 and got[1] == 0


def test_slop_zero_equals_exact():
    jarr, tarr = carried_pair(
        ["foo bar baz qux", "foo baz bar qux", "bar foo"] * 10)
    exact = tarr.termfreqs(["foo", "bar"])
    np.testing.assert_array_equal(exact, tarr.termfreqs(["foo", "bar"],
                                                        slop=0))
    np.testing.assert_array_equal(exact, jarr.termfreqs(["foo", "bar"],
                                                        slop=0))


def test_same_term_within_window():
    """"the the the" has a term three times: both packages run it on
    their sparse kernels (width <= 4 holds positions 1, 3, 5 at slop 2,
    width <= 3 does not at slop 1); the pair "the the" takes the dense
    window in both."""
    jarr, tarr = carried_pair(
        ["dig the well the whole the way down", "no such words"] * 10)
    got3 = tarr.termfreqs(["the", "the", "the"], slop=2)
    np.testing.assert_array_equal(
        got3, jarr.termfreqs(["the", "the", "the"], slop=2))
    assert np.all(got3[::2] > 0) and np.all(got3[1::2] == 0)
    got1 = tarr.termfreqs(["the", "the", "the"], slop=1)
    np.testing.assert_array_equal(
        got1, jarr.termfreqs(["the", "the", "the"], slop=1))
    assert np.all(got1 == 0)
    for slop in (1, 2, 3):
        got = tarr.termfreqs(["the", "the"], slop=slop)
        np.testing.assert_array_equal(
            got, jarr.termfreqs(["the", "the"], slop=slop))
    assert np.all(got[::2] > 0) and np.all(got[1::2] == 0)


def test_width_bound_is_sound():
    jarr, tarr = carried_pair(["foo " + " ".join(["x"] * 49) + " bar"])
    for slop in (1, 9, 17):
        got = tarr.termfreqs(["foo", "bar"], slop=slop)
        assert got[0] == 0 == jarr.termfreqs(["foo", "bar"], slop=slop)[0]
    # slop 49 needs a window of 50 positions: the sparse kernel's; one
    # position less and the pair is out of reach
    for slop, want in ((48, 0), (49, 1), (60, 1), (400, 1)):
        got = tarr.termfreqs(["foo", "bar"], slop=slop)
        assert got[0] == want == jarr.termfreqs(["foo", "bar"],
                                                slop=slop)[0]


def test_unordered_within_window():
    jarr, tarr = carried_pair(["beta alpha", "alpha beta",
                               "beta gap gap gap alpha"])
    for slop in (1, 4):
        got = tarr.termfreqs(["alpha", "beta"], slop=slop)
        np.testing.assert_array_equal(
            got, jarr.termfreqs(["alpha", "beta"], slop=slop))
    assert got[2] > 0
    assert tarr.termfreqs(["alpha", "beta"], slop=1)[2] == 0


def random_docs(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(vocab, size=rng.integers(3, 80)))
            for _ in range(n)]


DENSE_SLOP = [(["a", "b"], 1), (["a", "b"], 5), (["a", "b", "c"], 3),
              (["d", "e"], 15), (["a", "c", "e"], 10)]
REPEATED_SLOP = [(["a", "b", "a"], 1), (["a", "b", "a"], 4), (["a", "a"], 2),
                 (["b", "a", "b", "a"], 6)]


@pytest.fixture(scope="module")
def dense_pair():
    vocab = ["a", "b", "c", "d", "e"] + [f"x{i}" for i in range(50)]
    return carried_pair(random_docs(9, 500, vocab))


@pytest.fixture(scope="module")
def repeated_pair():
    vocab = ["a", "b", "c"] + [f"x{i}" for i in range(20)]
    docs = random_docs(17, 400, vocab) + ["a b a", "a x0 x1 b x2 a"]
    return carried_pair(docs)


@pytest.mark.parametrize("q,slop", DENSE_SLOP)
def test_dense_slop_matches_sparse_kernel(dense_pair, q, slop):
    """The JAX package holds its dense window to its sparse kernel on this
    corpus; the port is held to the JAX facade."""
    jarr, tarr = dense_pair
    got = tarr.termfreqs(q, slop=slop)
    np.testing.assert_array_equal(got, jarr.termfreqs(q, slop=slop))
    assert got.sum() > 0
    for sim in SIMS:
        np.testing.assert_allclose(
            tarr.score(q, similarity=getattr(tsim, sim)(), slop=slop),
            jarr.score(q, similarity=getattr(jsim, sim)(), slop=slop),
            rtol=1e-6, atol=0)


@pytest.mark.parametrize("q,slop", REPEATED_SLOP)
def test_dense_slop_repeated_terms_matches_sparse(repeated_pair, q, slop):
    jarr, tarr = repeated_pair
    got = tarr.termfreqs(q, slop=slop)
    np.testing.assert_array_equal(got, jarr.termfreqs(q, slop=slop))
    assert got.sum() > 0
    np.testing.assert_allclose(tarr.score(q, slop=slop),
                               jarr.score(q, slop=slop), rtol=1e-6, atol=0)


def test_a_term_three_times_raises(repeated_pair):
    """Nothing raises any more: a term three times runs the sparse kernel
    in both packages, and the port's pools keep only what the batch's
    one-term query put there."""
    jarr, tarr = repeated_pair
    before = pool_state(tarr.dev)
    got = tarr.termfreqs(["c", "c", "c"], slop=5)
    np.testing.assert_array_equal(got,
                                  jarr.termfreqs(["c", "c", "c"], slop=5))
    assert got.sum() > 0
    np.testing.assert_allclose(tarr.score(["c", "c", "c"], slop=5),
                               jarr.score(["c", "c", "c"], slop=5),
                               rtol=1e-6, atol=0)
    assert pool_state(tarr.dev) == before
    gs, gi = tarr.score_batch(["a", ["c", "c", "c"]], slop=5, top_k=3)
    ws, wi = jarr.score_batch(["a", ["c", "c", "c"]], slop=5, top_k=3)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    assert pool_state(tarr.dev)[0] == before[0]   # no plane was filled


def test_custom_similarity_with_slop_matches_jax(dense_pair):
    jarr, tarr = dense_pair

    def sim(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        return term_freqs * doc_freqs.sum() + doc_lens / avg_doc_lens

    for q, slop in ((["a", "b"], 2), (["a", "nope"], 2)):
        np.testing.assert_allclose(tarr.score(q, similarity=sim, slop=slop),
                                   jarr.score(q, similarity=sim, slop=slop),
                                   rtol=1e-6)
    np.testing.assert_allclose(
        tarr.score_batch([["a", "b"], "c"], similarity=sim, slop=[3, 0]),
        jarr.score_batch([["a", "b"], "c"], similarity=sim, slop=[3, 0]),
        rtol=1e-6)


MIXED = ["a", ["a", "b"], ["a", "b"], ["c", "d", "e"], ["a", "b", "a"], "x3",
         ["a", "b"], ["e", "d"], ["a", "nope"], ["b", "b"]]
MIXED_SLOP = [0, 0, 2, 2, 3, 2, 2, 15, 2, 4]


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("sim", SIMS)
def test_score_batch_mixing_exact_and_slop_matches_jax(block, sim):
    """Per-query slop lists mixing 0 and more, a repeated (query, slop)
    pair, a one-term query with slop, a vocabulary miss: three calls (the
    window group, the promotion into "phs" rows, the cached rows)."""
    vocab = ["a", "b", "c", "d", "e"] + [f"x{i}" for i in range(50)]
    jarr, tarr = carried_pair(random_docs(21, 400, vocab))
    for _ in range(3):
        ws, wi = jarr.score_batch(MIXED, similarity=getattr(jsim, sim)(),
                                  top_k=10, slop=MIXED_SLOP)
        out = tarr.score_batch(MIXED, similarity=getattr(tsim, sim)(),
                               top_k=10, slop=MIXED_SLOP, block=block)
        gs, gi = out if block else out()
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        tarr.score_batch(MIXED, slop=MIXED_SLOP),
        jarr.score_batch(MIXED, slop=MIXED_SLOP), rtol=1e-6, atol=0)
    # one slop for the whole batch
    np.testing.assert_allclose(tarr.score_batch(MIXED, slop=2),
                               jarr.score_batch(MIXED, slop=2), rtol=1e-6,
                               atol=0)


def test_topk_and_sliced_views_with_slop_match_jax(dense_pair):
    jarr, tarr = dense_pair
    for q, slop in DENSE_SLOP[:3]:
        ws, wi = jarr.topk(q, k=7, slop=slop)
        gs, gi = tarr.topk(q, k=7, slop=slop)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    jv, tv = jarr[50:400:3], tarr[50:400:3]
    for q, slop in DENSE_SLOP[:3]:
        np.testing.assert_array_equal(tv.termfreqs(q, slop=slop),
                                      jv.termfreqs(q, slop=slop))
        np.testing.assert_allclose(tv.score(q, slop=slop),
                                   jv.score(q, slop=slop), rtol=1e-6, atol=0)
    qs, sl = [q for q, _ in DENSE_SLOP], [s for _, s in DENSE_SLOP]
    np.testing.assert_allclose(tv.score_batch(qs, slop=sl),
                               jv.score_batch(qs, slop=sl), rtol=1e-6,
                               atol=0)
    ws, wi = jv.score_batch(qs, slop=sl, top_k=5)
    gs, gi = tv.score_batch(qs, slop=sl, top_k=5)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)


def test_a_one_term_query_ignores_slop(dense_pair):
    jarr, tarr = dense_pair
    np.testing.assert_array_equal(tarr.termfreqs("a", slop=3),
                                  tarr.termfreqs("a"))
    np.testing.assert_allclose(tarr.score(["a"], slop=30),
                               jarr.score(["a"], slop=30), rtol=1e-6)
    gs, gi = tarr.score_batch(["a", ["b"]], slop=[40, 2], top_k=4)
    ws, wi = jarr.score_batch(["a", ["b"]], slop=[40, 2], top_k=4)
    np.testing.assert_array_equal(gi, wi)


def phrase_sigs(dev):
    return {k for k in dev.tf_slot if isinstance(k, tuple)}


@pytest.fixture()
def cache_pair():
    rng = np.random.default_rng(11)
    vocab = ["red", "fox", "jumps", "dog", "the", "lazy"] + [
        f"w{i}" for i in range(40)]
    corpus = [" ".join(rng.choice(vocab, size=rng.integers(6, 30)))
              for _ in range(400)]
    corpus += ["red fox jumps the lazy dog red fox", "red the fox red fox"]
    return carried_pair(corpus)


def test_promotion_parity_slop_and_mults(cache_pair):
    """Repeated slop phrases are promoted into "phs" rows of the tf pool on
    their second hit, filled by the window kernel, and read back as rows."""
    jarr, tarr = cache_pair
    qs = [["red", "jumps"], ["red", "fox", "red"]]  # incl. multiplicity 2
    launches, runs = [], []
    for _ in range(3):
        before = dense.DISPATCHES[0]
        runs.append(tarr.score_batch(qs, slop=2))
        launches.append(dense.DISPATCHES[0] - before)
        np.testing.assert_allclose(runs[-1], jarr.score_batch(qs, slop=2),
                                   rtol=1e-6, atol=0)
        if len(runs) == 1:
            assert not phrase_sigs(tarr.dev.maps)
    tid = tarr.term_dict.get_term_id
    want = {(tuple(tid(t) for t in q), 2) for q in qs}
    assert phrase_sigs(tarr.dev.maps) == want == phrase_sigs(jarr.dev)
    for sig in want:
        tids, fkey = tarr.dev.maps.phrase_recipes[sig]
        assert fkey[0] == "phs" and fkey[2] == 0 and len(tids) == fkey[1] == 2
        assert (tids, fkey) == tuple(jarr.dev.phrase_recipes[sig])
    np.testing.assert_array_equal(runs[1], runs[0])
    np.testing.assert_array_equal(runs[2], runs[0])
    assert launches[2] == 1  # one dterm group on the cached rows, no fill
    # exact (slop 0) and slop 2 are distinct cache entries
    exact = [tarr.score_batch(qs) for _ in range(2)]
    np.testing.assert_array_equal(exact[0], exact[1])
    np.testing.assert_allclose(exact[0], jarr.score_batch(qs), rtol=1e-6,
                               atol=0)
    assert not np.allclose(runs[0], exact[0])
    # the single-query path reads the cached row
    for i, q in enumerate(qs):
        np.testing.assert_array_equal(tarr.score(q, slop=2), runs[0][i])


def test_single_query_slop_promotes_on_second_hit(cache_pair):
    jarr, tarr = cache_pair
    q = ["the", "fox", "the"]
    sig = (tuple(tarr.term_dict.get_term_id(t) for t in q), 3)
    want = jarr.score(q, slop=3)
    got = [tarr.score(q, slop=3) for _ in range(3)]
    assert sig in tarr.dev.maps.tf_slot and tarr.dev.maps.phrase_hits[sig] == 2
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g, got[0])


def test_eviction_and_repromotion_with_slop(cache_pair, monkeypatch):
    jarr, tarr = cache_pair
    monkeypatch.setattr(dense, "TF_POOL_MAX_SLOTS", 4)
    dev = tarr.dev
    dev.tf_pool = None
    dev.maps.tf_slot.clear()
    dev.maps.tf_cap = 0
    dev.maps.phrase_hits.clear()
    phrases = [["red", "fox"], ["the", "fox"], ["red", "jumps"],
               ["lazy", "dog"], ["fox", "the"]]
    want = jarr.score_batch(phrases, slop=[1, 2, 0, 3, 1])
    for _ in range(4):
        np.testing.assert_allclose(
            tarr.score_batch(phrases, slop=[1, 2, 0, 3, 1]), want, rtol=1e-6,
            atol=0)
    assert len(phrase_sigs(dev.maps)) <= 2  # budget = capacity // 2


def test_dedup_is_by_query_and_slop(cache_pair, monkeypatch):
    """["red", "fox"] at slop 0, 2, 2 and 4 is three distinct queries: two
    window groups of one row and one chain group."""
    jarr, tarr = cache_pair
    tids = [tarr.term_dict.get_term_id(t) for t in ("red", "fox")]
    seen = []
    classify = batch._classify

    def spy(dev, queries, kind, slop=0, **kw):
        seen.append((list(queries), list(slop)))
        return classify(dev, queries, kind, slop=slop, **kw)

    monkeypatch.setattr(batch, "_classify", spy)
    qs = [["red", "fox"]] * 4 + ["dog", "dog"]
    sl = [0, 2, 2, 4, 0, 3]
    got = tarr.score_batch(qs, slop=sl)
    assert seen == [([tids, tids, tids, [tarr.term_dict.get_term_id("dog")],
                      [tarr.term_dict.get_term_id("dog")]], [0, 2, 4, 0, 3])]
    np.testing.assert_allclose(got, jarr.score_batch(qs, slop=sl), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(got[1], got[2])
    assert not np.array_equal(got[0], got[1])
    with pytest.raises(ValueError, match="slop length"):
        tarr.score_batch(qs, slop=[1, 2])


def test_canonical_order_puts_the_anchor_first(cache_pair):
    _, tarr = cache_pair
    dev = tarr.dev
    tid = dev.vocab.get_term_id
    q = [tid("the"), tid("lazy"), tid("the")]
    uniq, u_spans, fkey = batch._slop_structure(dev, q, 2)
    lengths = {t: dev.term_span(t)[1] for t in set(q)}
    assert uniq[0] == min(lengths, key=lengths.get)
    assert [s[1] for s in u_spans] == [lengths[t] for t in uniq]
    assert fkey == ("phs", 2, 0, 4, (1, 2) if uniq[0] == tid("lazy")
                    else (2, 1))
    assert spans.unique_terms(q) == ([tid("the"), tid("lazy")], [2, 1])


# ---------------------------------------------------------------------------
# what the dense window kernel cannot take: the sparse kernel's queries,
# held to the JAX facade, with both pools left as they were
# ---------------------------------------------------------------------------
# score_batch and topk take no position window
RAISING = [(call, case)
           for case in ("window", "w19", "three_times", "not_dense",
                        "pool_too_small")
           for call in ("termfreqs", "score", "score_batch", "topk")
           if not (case == "window" and call in ("score_batch", "topk"))]


@pytest.mark.parametrize("call,case", RAISING)
def test_slop_outside_the_dense_window_raises(call, case, monkeypatch):
    vocab = ["a", "b", "c", "d", "e"] + [f"x{i}" for i in range(10)]
    jarr, tarr = carried_pair(random_docs(5, 120, vocab))
    tarr.score_batch(["a", ["a", "b"], "c", ["c", "d"]],
                     slop=[0, 2, 0, 1])  # pools in use
    q, slop, extra = ["a", "b"], 2, {}
    if case == "window":
        extra = dict(min_posn=0, max_posn=17)
    elif case == "w19":
        slop = 18            # 2 + 18 - 1 = 19
    elif case == "three_times":
        q = ["a", "b", "a", "a"]
    elif case == "not_dense":
        monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
        monkeypatch.setattr(jdense, "DENSE_TERM_BYTES_LIMIT", 0)
    else:
        monkeypatch.setattr(dense, "plane_capacity", lambda dev: 2)
        monkeypatch.setattr(jdense, "plane_capacity", lambda dev: 2)
    before = pool_state(tarr.dev)
    if call == "termfreqs":
        got = tarr.termfreqs(q, slop=slop, **extra)
        np.testing.assert_array_equal(
            got, jarr.termfreqs(q, slop=slop, **extra))
        assert got.sum() > 0
    elif call == "score":
        np.testing.assert_allclose(tarr.score(q, slop=slop, **extra),
                                   jarr.score(q, slop=slop, **extra),
                                   rtol=1e-6, atol=0)
    elif call == "score_batch":
        qs, sl = ["c", ["c", "d"], q], [0, 1, slop]
        if case in ("not_dense", "pool_too_small"):
            # the exact phrase takes the sparse chain there
            qs, sl = ["c", q, ["d", "e", "d"]], [0, slop, 3]
        gs, gi = tarr.score_batch(qs, slop=sl, top_k=3)
        ws, wi = jarr.score_batch(qs, slop=sl, top_k=3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    else:
        gs, gi = tarr.topk(q, k=3, slop=slop)
        ws, wi = jarr.topk(q, k=3, slop=slop)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    if case in ("not_dense", "pool_too_small") or call in ("termfreqs",
                                                           "score", "topk"):
        assert pool_state(tarr.dev) == before
    else:
        # the sparse kernel's query is never counted or promoted
        sig = (tuple(tarr.term_dict.get_term_id(t) for t in q), slop)
        assert sig not in tarr.dev.maps.phrase_hits
        assert sig not in tarr.dev.maps.tf_slot


def test_a_slop_phrase_with_an_empty_posting_scores_zero():
    """As in the JAX package, a vocabulary miss or an empty posting gives
    zeros before any shape is looked at, even a shape that would raise."""
    jarr, tarr = carried_pair(["a b c", "b c d"] * 5)
    for q, slop in ((["a", "nope"], 2), (["a", "nope"], 40)):
        np.testing.assert_array_equal(tarr.termfreqs(q, slop=slop),
                                      jarr.termfreqs(q, slop=slop))
        np.testing.assert_array_equal(tarr.score(q, slop=slop),
                                      jarr.score(q, slop=slop))
    gs, gi = tarr.score_batch([["a", "nope"]], slop=40, top_k=2)
    assert not gs.any()
