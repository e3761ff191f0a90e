"""tests/test_ranking_regression.py against the port on the CPU: the
frozen top-5 snapshot of the JAX suite (scores and doc ids over a fixed
zipf corpus; top-k and edismax), held to the same tolerances, and every
ranking also to the JAX package's on the same corpus (scores bit for bit
for top-k, rtol 1e-6 for edismax; indices equal)."""
import numpy as np
import pandas as pd
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import edismax as jedismax
from searcharray_tpu_torch import SearchArray, edismax
from test_ranking_regression import GOLDEN, GOLDEN_EDISMAX


def make_corpus():
    rng = np.random.default_rng(20260816)
    vocab = ["what", "is", "the", "of", "star", "trek", "purpose", "cat"] + [
        f"w{i}" for i in range(2000)
    ]
    probs = 1.0 / np.arange(1, len(vocab) + 1) ** 1.07
    probs /= probs.sum()
    return [
        " ".join(rng.choice(vocab, size=rng.integers(8, 60), p=probs))
        for _ in range(2000)
    ]


@pytest.fixture(scope="module")
def corpus_frame():
    corpus = make_corpus()
    docs = SearchArray.index(corpus, device="cpu")
    frame = pd.DataFrame({
        "body": docs,
        "title": SearchArray.index([c[:50] for c in corpus], device="cpu"),
    })
    jdocs = JSearchArray.index(corpus)
    jframe = pd.DataFrame({
        "body": jdocs,
        "title": JSearchArray.index([c[:50] for c in corpus]),
    })
    return docs, frame, jdocs, jframe


@pytest.mark.parametrize("query", list(GOLDEN))
def test_topk_snapshot(corpus_frame, query):
    docs, _, jdocs, _ = corpus_frame
    q = query.split() if " " in query else query
    scores, idx = docs.topk(q, k=5)
    want_scores, want_idx = GOLDEN[query]
    np.testing.assert_allclose(scores, want_scores, atol=2e-4, err_msg=query)
    dense = docs.score(q)
    np.testing.assert_allclose(dense[idx], scores, rtol=1e-6)
    if want_scores[0] > want_scores[1] + 3e-4:
        assert idx[0] == want_idx[0], query
    js, ji = jdocs.topk(q, k=5)
    np.testing.assert_array_equal(idx, ji, err_msg=query)
    np.testing.assert_array_equal(np.asarray(scores, np.float32).view(np.int32),
                                  np.asarray(js, np.float32).view(np.int32))


def _edismax(fn, frame, query):
    if query == "what is":
        return fn(frame, q=query, qf=["body^2", "title"], mm="1", tie=0.3,
                  pf2=["body"])[0]
    return fn(frame, q=query, qf=["body"], mm="2", pf=["body"])[0]


@pytest.mark.parametrize("query", list(GOLDEN_EDISMAX))
def test_edismax_snapshot(corpus_frame, query):
    _, frame, _, jframe = corpus_frame
    sc = _edismax(edismax, frame, query)
    want_scores, want_idx = GOLDEN_EDISMAX[query]
    top = np.argsort(sc)[::-1][:5]
    np.testing.assert_allclose(sc[top], want_scores, atol=2e-4,
                               err_msg=query)
    if want_scores[0] > want_scores[1] + 3e-4:
        assert top[0] == want_idx[0], query
    jsc = np.asarray(_edismax(jedismax, jframe, query))
    np.testing.assert_allclose(sc, jsc, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(top, np.argsort(jsc)[::-1][:5])
