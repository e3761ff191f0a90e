"""tests/test_relevance.py against the port on the CPU: the graded-qrels
MRR@10 harness on its 50k-doc corpus (the JAX test's corpus, oracle and
query set, imported from it).  The port's scores agree with the
independent float64 oracle to the JAX test's tolerance, its MRR@10
equals the oracle's, the injected df+1 idf bug fails the harness (the
port's counterpart of the JAX test's private mutation: a ``BuiltIndex``
with shifted ``doc_freqs`` attached through ``_IndexState``), and the
candidate-subset engine, forced on, keeps the MRR.  Every query's scores
are also held to the JAX package's on the same corpus: terms, phrases
and slop phrases bit for bit, edismax to rtol 1e-6."""
import dataclasses

import numpy as np
import pandas as pd
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.solr import edismax as jedismax
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.pandas_ext.array import _IndexState
from searcharray_tpu_torch.search import candidates as cand_mod
from searcharray_tpu_torch.solr import edismax
from test_relevance import (  # noqa: F401 (corpus, titles, oracles: fixtures)
    _query_set,
    corpus,
    mrr_at_k,
    oracles,
    titles,
)


@pytest.fixture(scope="module")
def engine(corpus, titles):  # noqa: F811
    docs, _, _ = corpus
    body = SearchArray.index(docs, device="cpu")
    frame = pd.DataFrame({"body": body,
                          "title": SearchArray.index(titles, device="cpu")})
    return body, frame


@pytest.fixture(scope="module")
def jengine(corpus, titles):  # noqa: F811
    docs, _, _ = corpus
    body = JSearchArray.index(docs)
    return body, pd.DataFrame({"body": body,
                               "title": JSearchArray.index(titles)})


def _edismax_args(q, kw):
    qf = ["body", "title^2.0"] if kw.get("two_fields") else ["body"]
    return dict(q=q, qf=qf, mm=str(kw.get("mm", 1)), tie=kw.get("tie", 0.0),
                pf=["body"] if kw.get("pf") else None,
                pf2=["body"] if kw.get("pf2") else None)


def _engine_scores(body, frame, kind, payload, ed=edismax):
    if kind in ("term", "phrase"):
        return np.asarray(body.score(payload))
    if kind == "slop":
        terms, slop = payload
        return np.asarray(body.score(terms, slop=slop))
    q, kw = payload
    return np.asarray(ed(frame, **_edismax_args(q, kw))[0])


def _oracle_scores(o_body, o_title, kind, payload):
    if kind == "term":
        return o_body.score_term(payload)
    if kind == "phrase":
        return o_body.score_phrase(payload)
    if kind == "slop":
        return o_body.score_slop(*payload)
    q, kw = payload
    fields = {"body": o_body}
    if kw.get("two_fields"):
        fields["title"] = o_title
    return o_body.edismax(
        q, fields, boosts={"body": 1.0, "title": 2.0}, mm=kw.get("mm", 1),
        tie=kw.get("tie", 0.0), pf=["body"] if kw.get("pf") else (),
        pf2=["body"] if kw.get("pf2") else ())


def _run_harness(body, frame, o_body, o_title, queries):
    """The JAX test's harness over the port: score every query in both
    systems, assert score agreement, return both MRR@10 values, the
    per-query reciprocal ranks and the engine's scores."""
    eng_rank, ora_rank, qrels, scores = [], [], [], []
    for kind, payload, rel in queries:
        assert len(rel) > 0, f"empty qrels for {kind} {payload}"
        e = _engine_scores(body, frame, kind, payload)
        s = _oracle_scores(o_body, o_title, kind, payload)
        np.testing.assert_allclose(
            e.astype(np.float64), s, rtol=3e-4, atol=2e-5,
            err_msg=f"score mismatch: {kind} {payload}")
        eng_rank.append(list(np.argsort(-e.astype(np.float32),
                                        kind="stable")[:10]))
        ora_rank.append(list(np.argsort(-s, kind="stable")[:10]))
        qrels.append(rel)
        scores.append(e)
    m_e, rr_e = mrr_at_k(eng_rank, qrels)
    m_o, rr_o = mrr_at_k(ora_rank, qrels)
    return m_e, m_o, rr_e, rr_o, scores


def test_mrr_harness_discriminative(corpus, engine, jengine,  # noqa: F811
                                    oracles):  # noqa: F811
    _, i_a, _ = corpus
    body, frame = engine
    o_body, o_title = oracles
    queries = _query_set(o_body, i_a)
    m_e, m_o, _, rr_o, scores = _run_harness(body, frame, o_body, o_title,
                                             queries)
    assert m_e == pytest.approx(m_o, abs=1e-12)
    assert 0.2 < m_o < 0.9999, f"oracle MRR@10 = {m_o}"
    assert sum(1 for r in rr_o if r < 1.0) >= 4, rr_o
    jbody, jframe = jengine
    for (kind, payload, _), got in zip(queries, scores):
        want = _engine_scores(jbody, jframe, kind, payload, ed=jedismax)
        if kind == "edismax":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=str(payload))
        else:
            np.testing.assert_array_equal(
                got.astype(np.float32).view(np.int32),
                want.astype(np.float32).view(np.int32), err_msg=str(payload))


def test_mutation_idf_off_by_one_fails_harness(corpus, engine,  # noqa: F811
                                               oracles):  # noqa: F811
    """Injected bug: idf computed with df+1.  The harness must fail:
    score agreement breaks AND MRR@10 changes at the 4th decimal (the
    planted flip pair swaps ranks)."""
    _, i_a, i_b = corpus
    body, frame = engine
    o_body, o_title = oracles
    queries = _query_set(o_body, i_a)
    m_clean = _run_harness(body, frame, o_body, o_title, queries)[0]

    mutated = SearchArray([], tokenizer=body.tokenizer, device="cpu")
    mutated._attach(_IndexState(dataclasses.replace(
        body._built, doc_freqs=body._built.doc_freqs + 1, derived=None),
        "cpu"))
    mut_frame = pd.DataFrame({"body": mutated, "title": frame["title"]})
    with pytest.raises(AssertionError):
        _run_harness(mutated, mut_frame, o_body, o_title, queries)

    flip_q = [q for q in queries if q[1] == ("flipa flipb", {"qrels": {i_a}})]
    e, _ = edismax(mut_frame, q="flipa flipb", qf=["body"])
    mut_rank = list(np.argsort(-np.asarray(e), kind="stable")[:10])
    clean_e, _ = edismax(frame, q="flipa flipb", qf=["body"])
    clean_rank = list(np.argsort(-np.asarray(clean_e), kind="stable")[:10])
    assert clean_rank[0] == i_a and mut_rank[0] == i_b, (
        "flip pair did not flip", clean_rank[:3], mut_rank[:3])
    m_mut, _ = mrr_at_k([mut_rank], [flip_q[0][2]])
    m_flip_clean, _ = mrr_at_k([clean_rank], [flip_q[0][2]])
    delta = abs(m_flip_clean - m_mut) / len(queries)
    assert round(m_clean, 4) != round(m_clean - delta, 4), delta


def test_mrr_with_candidate_engine(corpus, engine, oracles,  # noqa: F811
                                   monkeypatch):
    """The candidate-subset engine must not change retrieval quality."""
    _, i_a, _ = corpus
    body, _ = engine
    o_body, o_title = oracles
    queries = [q for q in _query_set(o_body, i_a) if q[0] != "edismax"]
    for name in ("CAND_MIN_DOCS", "CAND_TERM_MIN_DOCS", "CAND_MAX_FRAC"):
        monkeypatch.setattr(cand_mod, name, 0)
    qrels = [rel for _, _, rel in queries]
    specs = [p if kind != "slop" else p[0] for kind, p, _ in queries]
    slops = [0 if kind != "slop" else p[1] for kind, p, _ in queries]
    _scores, idx = body.score_batch(specs, top_k=10, slop=slops)
    m, _ = mrr_at_k([list(r) for r in idx], qrels)
    o_rank = [list(np.argsort(-_oracle_scores(o_body, o_title, kind, p),
                              kind="stable")[:10])
              for kind, p, _ in queries]
    m_o, _ = mrr_at_k(o_rank, qrels)
    assert m == pytest.approx(m_o, abs=1e-12)
