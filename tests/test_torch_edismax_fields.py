"""edismax's field batches: below the phrase pruning's corpus size each
field scores its query terms and its pf / pf2 / pf3 grams in one
``score_batch_device`` call.  Held bit for bit (float32 bits as int32) to
the composition as four field batches written out here (each field's
terms in one call, then each field's grams in another, K11 through
``_compose_tc`` / ``_compose_fc``, the same phase folds) on term- and
field-centric frames, with and without ``top_k``; the ``field_batches``
count on the ``composer.edismax`` span; the pruned path kept at and above
``PHASE_SUBSET_MIN_DOCS``; a sharded frame against the unsharded one."""
import numpy as np
import pandas as pd
import pytest
import torch

from searcharray_tpu_torch import SearchArray, edismax, solr
from searcharray_tpu_torch.parallel import sharded as tsh
from searcharray_tpu_torch.search.dense import pack_topk
from searcharray_tpu_torch.search.similarity import bm25_similarity
from searcharray_tpu_torch.utils import profiling

WORDS = ["foo", "bar", "baz", "qux", "the", "of"] + [f"w{i}" for i in
                                                   range(60)]


def docs(seed, n=500):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(WORDS) + 1)
    probs /= probs.sum()
    return [" ".join(rng.choice(WORDS, size=rng.integers(3, 24), p=probs))
            for _ in range(n)]


def no_stopwords(text):
    """A title analyzer that drops "the" and "of": queries holding them
    give the fields different term counts (field-centric)."""
    return [t for t in text.lower().split() if t not in ("the", "of")]


def frame_of(kind, **kw):
    body = docs(3)
    title = [" ".join(d.split()[:6]) for d in docs(4)]
    extra = docs(5, n=len(body))
    tok = {"tokenizer": no_stopwords} if kind == "fc" else {}
    return pd.DataFrame({
        "title": SearchArray.index(title, device="cpu", autowarm=False,
                                   **tok, **kw),
        "body": SearchArray.index(body, device="cpu", autowarm=False, **kw),
        "extra": SearchArray.index(extra, device="cpu", autowarm=False,
                                   **kw)})


@pytest.fixture(scope="module")
def frames():
    return {"tc": frame_of("tc"), "fc": frame_of("fc")}


BASE = dict(qf=["title^2", "body"], mm="2<75%", tie=0.1,
            pf=["title", "body"], pf2=["body"])
QUERIES = ["foo", "foo bar", "the foo of bar", "bar baz w3 foo",
           "foo zzmissing bar", "w1 w2 w1"]
CONFIGS = {
    "bench": BASE,
    "qf_only_field": dict(BASE, qf=["title^2", "body", "extra^0.5"]),
    "no_phases": dict(qf=["title", "body"], mm="1"),
    "every_phase_slop": dict(BASE, pf3=["title^0.5", "body"], ps=2, ps2=1,
                             ps3=3),
    "one_field": dict(qf=["body"], pf=["body^3"], pf2=["body"],
                      pf3=["body"], ps2=2),
}


def four_batches(frame, q, qf, mm=None, pf=None, pf2=None, pf3=None, ps=0,
                 ps2=0, ps3=0, tie=0.0, similarity=bm25_similarity(),
                 top_k=None):
    """edismax as four field batches: per field one call for its query
    terms, composed by K11, then per field one call for all its grams,
    each phase's segment summed (the final bigram twice), boosted in
    float32, summed over fields and added where the main query
    matched."""
    (query_fields, phrase_fields, bigram_fields, trigram_fields, mm,
     sims) = solr._settings(qf, mm, pf, pf2, pf3, "OR", similarity)
    n_terms, terms, term_centric = solr.parse_query_terms(
        frame, q, list(query_fields))
    stacks = [frame[f].array.score_batch_device(terms[f],
                                                similarity=sims[f])
              for f in query_fields]
    boosts = [1.0 if b is None else b for b in query_fields.values()]
    if term_centric:
        main = solr._compose_tc(stacks, boosts, float(tie),
                                solr.parse_min_should_match(n_terms, mm))
    else:
        _, msms = solr._fc_explain(query_fields, terms, mm)
        main = solr._compose_fc(stacks, boosts, float(tie), msms)
    grams = {}
    for pi, (fields, ngram, slop) in enumerate([
            (phrase_fields, 0, ps), (bigram_fields, 2, ps2),
            (trigram_fields, 3, ps3)]):
        for field, boost in fields.items():
            ts = terms[field]
            if len(ts) < (ngram or 2):
                continue
            gs = ([ts] if ngram == 0 else
                  [ts[i: i + ngram] for i in range(len(ts) - ngram + 1)])
            grams.setdefault(field, []).append((pi, boost, ngram, slop, gs))
    totals = [None] * 3
    for field, segs in grams.items():
        scores = frame[field].array.score_batch_device(
            [g for *_, gs in segs for g in gs], similarity=sims[field],
            slop=[s for _, _, _, s, gs in segs for _ in gs])
        g0 = 0
        for pi, boost, ngram, _slop, gs in segs:
            seg = scores[g0: g0 + len(gs)]
            g0 += len(gs)
            extra = seg.sum(dim=0)
            if ngram == 2:
                extra = extra + seg[-1]
            extra = extra * float(np.float32(1.0 if boost is None
                                             else boost))
            totals[pi] = extra if totals[pi] is None else totals[pi] + extra
    pos = main > 0
    for extra in totals:
        if extra is not None:
            main = main + torch.where(pos, extra, 0.0)
    if top_k is None:
        return main.numpy()
    k = min(top_k, len(frame))
    return solr._unpack_topk(pack_topk(main, k).numpy(), k)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def assert_same(got, want, top_k):
    if top_k is None:
        np.testing.assert_array_equal(bits(got), bits(want))
        return
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    np.testing.assert_array_equal(got[1], want[1])


def field_batches(frame, q, **kw):
    """(result, explain, the composer span's field_batches count)."""
    profiling.clear()
    with profiling.recording():
        got, explain = edismax(frame, q=q, **kw)
    spans = [s for s in profiling.spans() if s.name == "composer.edismax"]
    profiling.clear()
    assert len(spans) == 1
    return got, explain, spans[0].counts.get("field_batches")


@pytest.mark.parametrize("top_k", [None, 7])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("kind", ["tc", "fc"])
def test_one_batch_a_field_matches_four_batches(frames, kind, config,
                                                top_k):
    frame, kw = frames[kind], CONFIGS[config]
    for q in QUERIES:
        got, _, n = field_batches(frame, q, top_k=top_k, **kw)
        assert_same(got, four_batches(frame, q, top_k=top_k, **kw), top_k)
        assert n == len(solr.parse_field_boosts(kw["qf"]))


def test_a_query_with_fields_of_different_term_counts_is_field_centric(
        frames):
    """The "fc" frame's cases above take the field-centric composition."""
    q = "the foo of bar"
    assert solr.parse_query_terms(frames["fc"], q, ["title", "body"])[2] \
        is False
    assert solr.parse_query_terms(frames["tc"], q, ["title", "body"])[2] \
        is True


def test_two_fields_with_pf_and_pf2_make_two_batches(frames):
    for q in QUERIES[1:]:
        *_, n = field_batches(frames["tc"], q, **BASE)
        assert n == 2


def test_custom_similarity_and_sliced_views(frames):
    """A non-fused similarity (scored per query on the host) and a
    frame of sliced arrays take the same one batch a field."""
    def tiny(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        return (np.asarray(term_freqs) > 0).astype(np.float32) * 0.25

    def sims():
        return {"title": tiny, "body": bm25_similarity(k1=1.4, b=0.6)}

    sliced = frames["tc"].iloc[3::2]
    for frame, sim in ((frames["tc"], sims), (sliced, sims),
                       (sliced, bm25_similarity)):
        for q in ("foo bar", "the foo of bar"):
            got, _, n = field_batches(frame, q, similarity=sim(), **BASE)
            want = four_batches(frame, q, similarity=sim(), **BASE)
            np.testing.assert_array_equal(bits(got), bits(want))
            assert n == 2


def test_a_field_only_in_a_phrase_list_is_refused_as_before(frames):
    """The query is tokenized for the qf fields only (as in the reference
    and the JAX package), so a pf field outside qf has no terms."""
    with pytest.raises(KeyError, match="extra"):
        edismax(frames["tc"], q="foo bar", qf=["body"], pf=["extra"])


@pytest.mark.parametrize("top_k", [None, 7])
def test_the_pruned_path_keeps_four_batches(frames, monkeypatch, top_k):
    """At and above ``PHASE_SUBSET_MIN_DOCS`` the phases wait for the main
    query's matched docs: the qf batches, then the grams at those docs
    (``rows=``), one batch a field more; the same answer."""
    frame = frames["tc"]
    merged = [field_batches(frame, q, top_k=top_k, **BASE)
              for q in QUERIES]
    monkeypatch.setattr(solr, "PHASE_SUBSET_MIN_DOCS", 1)
    monkeypatch.setattr(solr, "PHASE_SUBSET_MAX_FRAC", 1)
    at_rows = []
    sbd = SearchArray.score_batch_device

    def spy(self, queries, *a, rows=None, **kw):
        at_rows.append(rows is not None)
        return sbd(self, queries, *a, rows=rows, **kw)

    monkeypatch.setattr(SearchArray, "score_batch_device", spy)
    for q, (want, want_explain, _) in zip(QUERIES, merged):
        at_rows.clear()
        got, explain, n = field_batches(frame, q, top_k=top_k, **BASE)
        assert_same(got, want, top_k)
        assert explain == want_explain
        phrased = len(solr.parse_query_terms(frame, q, ["body"])[1]["body"])
        assert n == (4 if phrased > 1 else 2) == len(at_rows)
        assert at_rows[2:] == [True] * (n - 2)


def test_a_sharded_frame_takes_one_batch_a_field():
    mesh = tsh.default_mesh(devices=[torch.device("cpu")] * 8)
    sharded = frame_of("tc", mesh=mesh)
    whole = frame_of("tc")
    assert sharded["body"].array._state.sharded is not None
    for kw in (BASE, CONFIGS["every_phase_slop"]):
        for q in QUERIES:
            for top_k in (None, 5):
                got, explain, n = field_batches(sharded, q, top_k=top_k,
                                                **kw)
                want, want_explain = edismax(whole, q=q, top_k=top_k, **kw)
                assert_same(got, want, top_k)
                assert explain == want_explain and n == 2
