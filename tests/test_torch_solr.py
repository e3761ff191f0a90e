"""Port parity for the Solr edismax composer: every scenario of
tests/test_solr.py through the port's ``edismax`` / ``edismax_batch`` and
the JAX package's on the same frames (scores rtol 1e-6 and atol 1e-6, the
explain strings equal letter for letter), ``parse_min_should_match``'s
table, and ``SearchArray.score_batch_device`` against the JAX method."""
import numpy as np
import pandas as pd
import pytest
import torch

import searcharray_tpu as jpkg
import searcharray_tpu.solr as jsolr
import searcharray_tpu_torch as tpkg
from searcharray_tpu import similarity as jsim
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch import solr as tsolr
from searcharray_tpu_torch.ops.cuda import score as kc
from test_solr import (
    TITLE_DOCS,
    all_b_tokenizer,
    binary_similarity,
    one_token_lowercase,
)

TOL = dict(rtol=1e-6, atol=1e-6)
BODY_DOCS = ["buzz", "data2", "data3 bar", "bunny funny wunny"]
FC_BODY = ["foo bar", "data2", "data3 bar", "bunny funny wunny"]


def frames(columns):
    """The same columns as a JAX-package frame and a port frame (on the
    CPU); ``columns`` maps a field to (docs, tokenizer or None)."""
    out = []
    for pkg, kw in ((jpkg, {}), (tpkg, {"device": "cpu"})):
        out.append(pd.DataFrame({
            field: pkg.SearchArray.index(
                docs, **({} if tok is None else {"tokenizer": tok}), **kw)
            for field, (docs, tok) in columns.items()}))
    return out


def zipf_docs(seed=13, n=2500):
    rng = np.random.default_rng(seed)
    vocab = ["foo", "bar", "baz", "qux"] + [f"w{i}" for i in range(150)]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    docs = [" ".join(rng.choice(vocab, size=rng.integers(4, 30), p=probs))
            for _ in range(n)]
    docs[7] = "foo bar baz deep phrase " + docs[7]
    return docs


FRAMES = {
    "plain": {"title": (TITLE_DOCS, None), "body": (BODY_DOCS, None)},
    "fc": {"title": (TITLE_DOCS, None),
           "body": (FC_BODY, one_token_lowercase)},
    "all_b": {"title": (TITLE_DOCS, None),
              "body": (BODY_DOCS, all_b_tokenizer)},
}


@pytest.fixture(scope="module")
def frame_pairs():
    return {name: frames(cols) for name, cols in FRAMES.items()}


@pytest.fixture(scope="module")
def zipf_pair():
    docs = zipf_docs()
    return frames({"title": (docs, None),
                   "body": (list(reversed(docs)), None)})


# ---------------------------------------------------------------------------
# parse_min_should_match and the small parsers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "clauses,spec,expected",
    [(10, "50%", 5), (10, "150%", 10), (10, "-50%", 5), (10, "3", 3),
     (10, "-3", 7), (10, "15", 10), (10, "5<70%", 7), (10, "15<70%", 10),
     (10, "3<50% 5<30%", 3), (10, "2<2 5<3 7<40%", 4), (0, "2<75%", 0),
     (3, "2<75%", 2), (2, "2<75%", 2), (4, " 2 < 75% ", 3), (7, "-25%", 6)])
def test_parse_mm(clauses, spec, expected):
    assert tpkg.parse_min_should_match(clauses, spec) == expected
    assert jsolr.parse_min_should_match(clauses, spec) == expected


@pytest.mark.parametrize("spec", ["five%", "five", "5<", ""])
def test_parse_mm_invalid(spec):
    with pytest.raises(ValueError):
        tpkg.parse_min_should_match(10, spec)


def test_the_package_exports_the_composer():
    from searcharray_tpu_torch import (  # noqa: F401
        edismax,
        edismax_batch,
        parse_min_should_match,
    )
    assert edismax is tsolr.edismax and edismax_batch is tsolr.edismax_batch
    assert {"edismax", "edismax_batch"} <= set(tpkg.__all__)
    assert tsolr.parse_field_boosts(["title^2.5", "body"]) == \
        jsolr.parse_field_boosts(["title^2.5", "body"]) == \
        {"title": 2.5, "body": None}
    assert tsolr.parse_field_boosts([]) == {}


def test_get_field_rejects_what_is_not_a_search_field(frame_pairs):
    _, tf = frame_pairs["plain"]
    with pytest.raises(ValueError, match="not in dataframe"):
        tpkg.edismax(tf, q="foo", qf=["nope"])
    tf2 = tf.assign(other=[1, 2, 3, 4])
    with pytest.raises(ValueError, match="not a searcharray field"):
        tpkg.edismax(tf2, q="foo", qf=["other"])
    # a JAX-package column is not the port's array
    jf, _ = frame_pairs["plain"]
    with pytest.raises(ValueError, match="not a searcharray field"):
        tpkg.edismax(jf, q="foo", qf=["title"])


# ---------------------------------------------------------------------------
# every scenario of tests/test_solr.py, the port against the JAX package
# ---------------------------------------------------------------------------
SCENARIOS = {
    "term_centric_max_over_fields": ("plain", dict(q="foo bar",
                                                   qf=["title", "body"])),
    "field_boost": ("plain", dict(q="foo bar", qf=["title^10", "body"])),
    "field_centric_when_tokenizers_disagree": (
        "fc", dict(q="foo bar", qf=["title", "body"])),
    "field_centric_tie": ("fc", dict(q="foo bar", qf=["title", "body"],
                                     tie=0.1)),
    "field_centric_mm_and_boosts": (
        "fc", dict(q="foo bar", qf=["title^3", "body^0.5"], tie=0.4, mm="2")),
    "mm_two": ("plain", dict(q="foo bar", qf=["title", "body"], mm="2")),
    "mm_int": ("plain", dict(q="foo bar", qf=["title", "body"], mm=2)),
    "q_op_and": ("plain", dict(q="foo bar", qf=["title", "body"],
                               q_op="AND")),
    "mm_100_percent": ("plain", dict(q="foo bar", qf=["title", "body"],
                                     mm="100%")),
    "term_centric_tie": ("plain", dict(q="bar", qf=["title", "body"],
                                       tie=0.5)),
    "pf_adds_phrase_score": ("plain", dict(q="foo bar", qf=["title", "body"],
                                           pf=["title"])),
    "pf_single_term_noop": ("plain", dict(q="foo", qf=["title"],
                                          pf=["title"])),
    "pf2_single_term_noop": ("plain", dict(q="foo", qf=["title"],
                                           pf2=["title"])),
    "pf2_two_terms": ("plain", dict(q="foo bar", qf=["title"],
                                    pf2=["title"])),
    "pf3_needs_three_terms": ("plain", dict(q="foo bar", qf=["title"],
                                            pf3=["title"])),
    "pf3_three_terms": ("plain", dict(q="foo bar bar", qf=["title"],
                                      pf3=["title"])),
    "different_analyzers_term_centric": (
        "all_b", dict(q="bar", qf=["title", "body"])),
    "ps_wires_slop_into_pf": ("plain", dict(q="foo baz", qf=["title"],
                                            pf=["title"], ps=2)),
    "ps_exact": ("plain", dict(q="foo baz", qf=["title"], pf=["title"])),
    "ps_loose": ("plain", dict(q="foo bar", qf=["title"], pf=["title"],
                               ps=3)),
    "ps_beyond_the_dense_window": (
        "plain", dict(q="foo baz", qf=["title"], pf=["title"], ps=20)),
    "pf_string_argument": ("plain", dict(q="foo bar", qf="title",
                                         pf="title^3")),
    "boosted_phases": ("plain", dict(q="foo bar bar baz",
                                     qf=["title^2", "body"], tie=0.1,
                                     pf=["title^1.5"], pf2=["title", "body^4"],
                                     pf3=["title^0.25"], ps2=1, ps3=2)),
    "no_terms": ("plain", dict(q="", qf=["title", "body"], pf=["title"])),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_edismax_scenarios_match_jax(frame_pairs, name):
    which, kw = SCENARIOS[name]
    jf, tf = frame_pairs[which]
    want, wexp = jpkg.edismax(jf, **kw)
    got, gexp = tpkg.edismax(tf, **kw)
    assert gexp == wexp
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_the_reference_arithmetic_holds_in_the_port(frame_pairs):
    """The checks tests/test_solr.py makes with the array's own scores."""
    _, tf = frame_pairs["plain"]
    title, body = tf["title"].array, tf["body"].array
    scores, explain = tpkg.edismax(tf, q="foo bar", qf=["title", "body"])
    expected0 = title.score("foo")[0] + title.score("bar")[0]
    expected2 = max(title.score("bar")[2], body.score("bar")[2])
    assert np.allclose(scores, [expected0, 0, expected2, 0])
    assert "title:foo" in explain
    boosted, _ = tpkg.edismax(tf, q="foo bar", qf=["title^10", "body"])
    assert np.allclose(boosted, [10 * expected0, 0,
                                 max(10 * title.score("bar")[2],
                                     body.score("bar")[2]), 0])
    both, _ = tpkg.edismax(tf, q="foo bar", qf=["title", "body"], mm="2")
    assert both[0] > 0 and np.all(both[1:] == 0)
    phrase, _ = tpkg.edismax(tf, q="foo bar", qf=["title", "body"],
                             pf=["title"])
    assert np.allclose(phrase[0], title.score(["foo", "bar"])[0] + expected0)
    exact, _ = tpkg.edismax(tf, q="foo baz", qf=["title"], pf=["title"])
    for ps in (2, 20):   # the dense window's slop, and the sparse kernel's
        sloppy, exp = tpkg.edismax(tf, q="foo baz", qf=["title"],
                                   pf=["title"], ps=ps)
        assert sloppy[0] > exact[0] and f'"foo baz"~{ps})' in exp


def test_the_final_bigram_counts_twice(frame_pairs):
    """The reference appends the last bigram twice; the explain string
    names each bigram once."""
    _, tf = frame_pairs["plain"]
    title = tf["title"].array
    scores, explain = tpkg.edismax(tf, q="foo bar bar baz", qf=["title"],
                                   pf2=["title"])
    main = (title.score("foo") + 2 * title.score("bar") + title.score("baz"))
    grams = (title.score(["foo", "bar"]) + title.score(["bar", "bar"])
             + 2 * title.score(["bar", "baz"]))
    np.testing.assert_allclose(scores, main + np.where(main > 0, grams, 0),
                               rtol=1e-6, atol=1e-6)
    assert explain.count('(title:"bar baz")^1') == 1


@pytest.mark.parametrize("per_field", [False, True])
def test_custom_similarity(frame_pairs, per_field):
    jf, tf = frame_pairs["plain"]

    def tiny(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        return (np.asarray(term_freqs) > 0).astype(np.float32) * 0.0001

    sim = ({"title": binary_similarity, "body": tiny} if per_field
           else binary_similarity)
    kw = dict(q="foo bar", qf=["title", "body"], pf=["title"], ps=1)
    want, wexp = jpkg.edismax(jf, similarity=dict(sim) if per_field else sim,
                              **kw)
    got, gexp = tpkg.edismax(tf, similarity=dict(sim) if per_field else sim,
                             **kw)
    assert gexp == wexp
    np.testing.assert_allclose(got, want, **TOL)
    if not per_field:
        assert np.all(got.astype(np.int64) == got)


@pytest.mark.parametrize("sim", ["bm25_similarity", "bm25_legacy_similarity",
                                 "bm25_impact", "classic_similarity"])
def test_builtin_similarities(zipf_pair, sim):
    jf, tf = zipf_pair
    kw = dict(q="foo bar baz", qf=["title", "body^2"], pf=["title"],
              pf2=["body"], tie=0.2, mm="2")
    want, wexp = jpkg.edismax(jf, similarity=getattr(jsim, sim)(), **kw)
    got, gexp = tpkg.edismax(tf, similarity=getattr(tsim, sim)(), **kw)
    assert gexp == wexp
    np.testing.assert_allclose(got, want, **TOL)
    assert got.max() > 0


ZIPF_KW = dict(q="foo bar baz", qf=["title", "body^2"], pf=["title"],
               pf2=["title", "body"], pf3=["body"])


@pytest.mark.parametrize("extra", [{}, {"ps2": 1}, {"ps": 2, "ps3": 20},
                                   {"ps": 30, "ps2": 18}])
def test_phase_candidate_rows_parity(zipf_pair, extra, monkeypatch):
    """Both packages forced onto their candidate-row phrase phases (cost
    proportional to matches), in the count-and-ids zone and in the middle
    zone, against each other and against the full-corpus mask: the same
    scores and explain strings."""
    jf, tf = zipf_pair
    got, gexp = tpkg.edismax(tf, **ZIPF_KW, **extra)
    full, fexp = jpkg.edismax(jf, **ZIPF_KW, **extra)
    for pkg in (jsolr, tsolr):
        monkeypatch.setattr(pkg, "PHASE_SUBSET_MIN_DOCS", 0)
        monkeypatch.setattr(pkg, "PHASE_SUBSET_MAX_FRAC", 1)
    rows = tsolr._phase_candidate_rows(
        torch.from_numpy(np.where(got > 0, got, 0.0)))
    assert rows is not None and np.array_equal(rows, np.flatnonzero(got))
    sub, sexp = jpkg.edismax(jf, **ZIPF_KW, **extra)
    seen = []
    sbd = tpkg.SearchArray.score_batch_device

    def spy(self, queries, *a, rows=None, **kw):
        seen.append(rows is not None)
        return sbd(self, queries, *a, rows=rows, **kw)

    monkeypatch.setattr(tpkg.SearchArray, "score_batch_device", spy)
    tsub, tsexp = tpkg.edismax(tf, **ZIPF_KW, **extra)
    # every case has an exact phase, which takes the rows
    assert any(seen)
    assert gexp == sexp == fexp == tsexp
    np.testing.assert_allclose(got, sub, **TOL)
    np.testing.assert_allclose(got, full, **TOL)
    np.testing.assert_allclose(tsub, sub, **TOL)
    for pkg in (jsolr, tsolr):
        monkeypatch.setattr(pkg, "PHASE_ROWS_CAP", 4)   # the middle zone
    mid, _ = jpkg.edismax(jf, **ZIPF_KW, **extra)
    tmid, tmexp = tpkg.edismax(tf, **ZIPF_KW, **extra)
    np.testing.assert_allclose(got, mid, **TOL)
    np.testing.assert_allclose(tmid, mid, **TOL)
    assert tmexp == fexp
    (ts, ti), _ = tpkg.edismax(tf, **ZIPF_KW, **extra, top_k=5)
    (js, ji), _ = jpkg.edismax(jf, **ZIPF_KW, **extra, top_k=5)
    np.testing.assert_allclose(ts, js, **TOL)
    assert got[len(tf) - 8] > 0 or got[7] > 0


def same_ranking(scores, idx, want_scores, want_idx, dense):
    """Ranked results agree: the scores within tolerance, and the indices
    equal wherever a score is separated from its neighbours in the
    ranking by more than the tolerance.  Inside a run of scores that tie
    within it the two may order (or, at the cut, choose) differently, so
    there each index is held to its own dense score instead."""
    np.testing.assert_allclose(scores, want_scores, **TOL)
    np.testing.assert_allclose(dense[idx], scores, **TOL)
    s = np.asarray(want_scores, np.float64)
    gap = 2 * (TOL["atol"] + TOL["rtol"] * np.abs(s))
    lone = np.ones(len(s), bool)
    lone[1:] &= (s[:-1] - s[1:]) > gap[1:]
    lone[:-1] &= (s[:-1] - s[1:]) > gap[:-1]
    lone[-1] = False   # the cut may fall inside a tie with what follows
    np.testing.assert_array_equal(np.asarray(idx)[lone],
                                  np.asarray(want_idx)[lone])


def test_edismax_top_k_matches_dense(frame_pairs):
    jf, tf = frame_pairs["plain"]
    kw = dict(q="foo bar", qf=["title^2", "body"], mm=1, tie=0.1,
              pf2=["body"])
    dense, exp1 = tpkg.edismax(tf, **kw)
    (sc, ix), exp2 = tpkg.edismax(tf, top_k=3, **kw)
    assert exp1 == exp2 and ix.dtype == np.int64 and sc.dtype == np.float32
    order = np.lexsort((np.arange(len(dense)), -dense))[:3]
    np.testing.assert_array_equal(ix, order)   # ties to the smallest index
    np.testing.assert_array_equal(sc, dense[order])
    (wsc, wix), wexp = jpkg.edismax(jf, top_k=3, **kw)
    assert wexp == exp2
    same_ranking(sc, ix, wsc, wix, dense)
    (sc9, ix9), _ = tpkg.edismax(tf, top_k=9, **kw)   # k above the rows
    assert sc9.shape == ix9.shape == (4,)


BATCH_QUERIES = ["foo bar", "foo bar baz", "qux", "w5 w9 foo",
                 "zzz_nomatch qux", "foo", "bar baz qux w3", ""]
BATCH_KW = dict(qf=["title^2", "body"], mm="2<75%", tie=0.1,
                pf=["title", "body"], pf2=["body"], pf3=["title"], ps2=1)


@pytest.mark.parametrize("extra", [{}, {"ps": 20, "ps3": 2}])
def test_edismax_batch_differential(zipf_pair, extra):
    """edismax_batch == per-query edismax in the port, and == the JAX
    package's edismax_batch: dense scores, ranked results and explain
    strings, across term counts, mm classes, phases, slop phases on both
    slop kernels, boosts, and no-match and empty queries."""
    jf, tf = zipf_pair
    kw = {**BATCH_KW, **extra}
    dense_b, exp_b = tpkg.edismax_batch(tf, BATCH_QUERIES, **kw)
    assert dense_b.shape == (len(BATCH_QUERIES), len(tf))
    assert dense_b.dtype == np.float32
    (sc_b, ix_b), exp_k = tpkg.edismax_batch(tf, BATCH_QUERIES, top_k=5,
                                             **kw)
    assert exp_k == exp_b and ix_b.dtype == np.int64
    want_b, wexp_b = jpkg.edismax_batch(jf, BATCH_QUERIES, **kw)
    (wsc_b, wix_b), _ = jpkg.edismax_batch(jf, BATCH_QUERIES, top_k=5, **kw)
    assert exp_b == wexp_b
    np.testing.assert_allclose(dense_b, want_b, **TOL)
    for qi, q in enumerate(BATCH_QUERIES):
        same_ranking(sc_b[qi], ix_b[qi], wsc_b[qi], wix_b[qi], dense_b[qi])
        if not q:
            assert np.all(dense_b[qi] == 0)
            continue
        dense, exp = tpkg.edismax(tf, q, **kw)
        assert exp_b[qi] == exp, q
        np.testing.assert_allclose(dense_b[qi], dense, **TOL)
        (sc, ix), _ = tpkg.edismax(tf, q, top_k=5, **kw)
        same_ranking(sc_b[qi], ix_b[qi], sc, ix, dense_b[qi])


def test_edismax_batch_field_centric(frame_pairs):
    jf, tf = frame_pairs["fc"]
    queries = ["foo bar", "bar", "bunny funny"]
    kw = dict(qf=["title", "body"], tie=0.1, pf=["title"])
    dense_b, exp_b = tpkg.edismax_batch(tf, queries, **kw)
    want_b, wexp_b = jpkg.edismax_batch(jf, queries, **kw)
    assert exp_b == wexp_b
    np.testing.assert_allclose(dense_b, want_b, **TOL)
    for qi, q in enumerate(queries):
        dense, exp = tpkg.edismax(tf, q, **kw)
        assert exp_b[qi] == exp, q
        np.testing.assert_allclose(dense_b[qi], dense, **TOL)


def test_edismax_batch_fallback_paths(zipf_pair):
    """A custom similarity and a sliced field take the scalar loop and
    still return batch-shaped results; an empty batch returns empty
    ones."""
    jf, tf = zipf_pair
    queries = ["foo bar", "qux"]
    kw = dict(qf=["title", "body"], similarity=binary_similarity)
    dense_b, exp_b = tpkg.edismax_batch(tf, queries, **kw)
    want_b, wexp_b = jpkg.edismax_batch(jf, queries, **kw)
    assert dense_b.shape == (2, len(tf)) and exp_b == wexp_b
    np.testing.assert_allclose(dense_b, want_b, **TOL)
    (sc, ix), _ = tpkg.edismax_batch(tf, queries, top_k=3, **kw)
    assert sc.shape == (2, 3) and ix.shape == (2, 3)
    sliced_t, sliced_j = tf.iloc[10:900:3], jf.iloc[10:900:3]
    got, gexp = tpkg.edismax_batch(sliced_t, queries, qf=["title", "body"],
                                   pf=["title"], ps=1)
    want, wexp = jpkg.edismax_batch(sliced_j, queries, qf=["title", "body"],
                                    pf=["title"], ps=1)
    assert got.shape == (2, len(sliced_t)) and gexp == wexp
    np.testing.assert_allclose(got, want, **TOL)
    (sc0, ix0), exps = tpkg.edismax_batch(tf, [], qf=["title"], top_k=4)
    assert sc0.shape == (0, 4) and ix0.shape == (0, 4) and exps == []
    dense0, exps = tpkg.edismax_batch(tf, [], qf=["title"])
    assert dense0.shape == (0, len(tf)) and exps == []


def test_the_batch_launches_no_kernel_on_the_cpu(zipf_pair):
    _, tf = zipf_pair
    before = (kc.topk.launches, kc.span_sparse.launches,
              kc.span_window.launches)
    tpkg.edismax_batch(tf, BATCH_QUERIES[:3], top_k=4, ps=20, **{
        k: v for k, v in BATCH_KW.items()})
    assert (kc.topk.launches, kc.span_sparse.launches,
            kc.span_window.launches) == before


# ---------------------------------------------------------------------------
# score_batch_device
# ---------------------------------------------------------------------------
SBD_QUERIES = ["foo", ["foo", "bar"], ["foo", "bar"], ["bar", "baz", "qux"],
               "nope", ["baz", "foo"], ["foo"], ["bar", "bar", "bar"]]
SBD_SLOPS = [0, 0, 2, 1, 0, 25, 3, 6]


@pytest.mark.parametrize("view", ["full", "sliced"])
@pytest.mark.parametrize("slop", [0, 3, SBD_SLOPS])
def test_score_batch_device_matches_jax(zipf_pair, view, slop):
    jf, tf = zipf_pair
    jarr, tarr = jf["title"].array, tf["title"].array
    if view == "sliced":
        jarr, tarr = jarr[5:2000:7], tarr[5:2000:7]
    got = tarr.score_batch_device(SBD_QUERIES, slop=slop)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.device == tarr.dev.device
    assert got.shape == (len(SBD_QUERIES), len(tarr))
    want = np.asarray(jarr.score_batch_device(SBD_QUERIES, slop=slop))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        got.numpy(), tarr.score_batch(SBD_QUERIES, slop=slop))


def test_score_batch_device_custom_similarity_and_errors(zipf_pair):
    jf, tf = zipf_pair
    jarr, tarr = jf["body"].array[::2], tf["body"].array[::2]
    got = tarr.score_batch_device(SBD_QUERIES[:4], binary_similarity,
                                  slop=[0, 1, 0, 2])
    want = np.asarray(jarr.score_batch_device(
        SBD_QUERIES[:4], binary_similarity, slop=[0, 1, 0, 2]))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert tarr.score_batch_device([], binary_similarity).shape == (
        0, len(tarr))
    assert tarr.score_batch_device([]).shape == (0, len(tarr))
    with pytest.raises(ValueError, match="slop length"):
        tarr.score_batch_device(SBD_QUERIES, slop=[1, 2])
    # scores over a subset of rows: the JAX package's, and its refusals
    rows = np.arange(3, len(tf), 11)
    got = tf["body"].array.score_batch_device(SBD_QUERIES, rows=rows,
                                              slop=[0] * len(SBD_QUERIES))
    want = np.asarray(jf["body"].array.score_batch_device(SBD_QUERIES,
                                                          rows=rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    for bad in (dict(slop=1), dict(slop=[0, 1] * 4),
                dict(similarity=binary_similarity)):
        for arr in (tf["body"].array, jf["body"].array):
            with pytest.raises(ValueError, match="rows= requires"):
                arr.score_batch_device(SBD_QUERIES, rows=rows, **bad)
    for arr in (tarr, jarr):
        with pytest.raises(ValueError, match="rows= requires"):
            arr.score_batch_device(["foo"], rows=np.arange(5))
