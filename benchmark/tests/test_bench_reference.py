"""The plain reference held to hand counts on tiny corpora."""
import math

import numpy as np
import pytest

from benchmark.harness.compare import judge, judge_one
from benchmark.reference.index import RefIndex
from benchmark.reference.search import (Scores, bf16, edismax,
                                        min_should_match, score_query)

WORDS = ["a", "b", "c", "x"]
VOCAB = {w: i for i, w in enumerate(WORDS)}


def index_of(docs):
    toks = [[VOCAB[w] for w in d.split()] for d in docs]
    return RefIndex(np.array([t for d in toks for t in d], np.int64),
                    np.array([len(d) for d in toks]), VOCAB)


DOCS = ["a b c a b", "b a b c", "c c c c", "a x b"]


def freqs(index, words, slop=0):
    docs, counts = index.freqs(words, slop)
    out = np.zeros(index.n_docs, np.int64)
    out[docs] = counts
    return out.tolist()


def test_term_stats_by_hand():
    ix = index_of(DOCS)
    assert freqs(ix, ["a"]) == [2, 1, 0, 1]
    assert freqs(ix, ["c"]) == [1, 1, 4, 0]
    assert ix.doc_freq(VOCAB["b"]) == 3
    assert ix.words(VOCAB["c"]) == 3       # one posting word per doc here
    assert freqs(ix, ["zzz"]) == [0, 0, 0, 0]


def test_exact_phrases_by_hand():
    ix = index_of(DOCS)
    assert freqs(ix, ["a", "b"]) == [2, 1, 0, 0]
    assert freqs(ix, ["b", "c"]) == [1, 1, 0, 0]
    assert freqs(ix, ["a", "b", "c"]) == [1, 1, 0, 0]
    assert freqs(ix, ["b", "a"]) == [0, 1, 0, 0]


def test_same_term_bigram_counts_by_hand():
    # a run of four "c" in one posting word: 3 pairs less half of its 2
    # triples, rounded up, is 2 (the reference library's correction)
    ix = index_of(DOCS)
    assert freqs(ix, ["c", "c"]) == [0, 0, 2, 0]
    assert freqs(ix, ["c", "c", "c"]) == [0, 0, 2, 0]
    # a pair across posting words (positions 17, 18) counts once
    ix = index_of(["x " * 17 + "c c", "c c c x"])
    assert freqs(ix, ["c", "c"]) == [1, 1]


def test_long_phrase_splits_at_its_rarest_term():
    # "b" is rarest at index 2 of 5 terms: halves [a, a] and [b, a, a];
    # the count is the least of the halves' counts, anywhere in the doc
    ix = index_of(["a a x b a a", "a a x x x", "b a a x a a a a"])
    assert ix.words(VOCAB["b"]) < ix.words(VOCAB["a"])
    assert freqs(ix, ["a", "a", "b", "a", "a"]) == [1, 0, 1]


def test_slop_counts_covered_anchors_by_hand():
    ix = index_of(DOCS)
    # w = 2 + 1 - 1 = 2: a window of 3 positions around each anchor
    assert freqs(ix, ["a", "c"], slop=1) == [2, 1, 0, 0]
    # a term twice (w = 3 + 1 - 1 = 3): a window of 4 positions must hold
    # both "a" and the "b"; every "a" so covered counts
    ix2 = index_of(["a b a", "a b x a", "b a", "a b x x a"])
    assert freqs(ix2, ["a", "b", "a"], slop=1) == [2, 2, 0, 0]


def test_bm25_by_hand():
    ix = index_of(DOCS)
    s = score_query(ix, "a", 0, 1.2, 0.75)
    avgdl = (5 + 4 + 4 + 3) / 4
    idf = math.log1p((4 - 3 + 0.5) / (3 + 0.5))
    want = 2 / (2 + 1.2 * (0.25 + 0.75 * 5 / avgdl)) * idf
    assert s.docs.tolist() == [0, 1, 3]
    assert s.vals[0] == pytest.approx(want, rel=1e-15)
    p = score_query(ix, ["a", "b"], 0, 1.2, 0.75)
    idf2 = idf + math.log1p((4 - 3 + 0.5) / (3 + 0.5))
    assert p.vals[0] == pytest.approx(
        2 / (2 + 1.2 * (0.25 + 0.75 * 5 / avgdl)) * idf2, rel=1e-15)


def test_top_k_ties_go_to_the_smaller_index():
    s = Scores(6, np.array([1, 2, 4]), np.array([0.5, 0.7, 0.5]))
    vals, idx = s.top(4)
    assert idx.tolist() == [2, 1, 4, 0]
    assert vals.tolist() == [0.7, 0.5, 0.5, 0.0]
    d = Scores(5, None, np.array([0.1, 0.3, 0.3, 0.0, 0.3]))
    assert d.top(3)[1].tolist() == [1, 2, 4]


def test_min_should_match():
    assert [min_should_match(n, "2<75%") for n in (1, 2, 3, 4)] == [1, 2, 2, 3]
    assert min_should_match(5, "-25%") == 4
    assert min_should_match(4, "-1") == 3
    assert min_should_match(9, "2<-25% 9<-3") == 7
    assert min_should_match(10, "2<-25% 9<-3") == 7


def test_edismax_by_hand():
    body = index_of(["a b c", "a x", "b c c"])
    title = index_of(["a b", "x", "b c"])
    idx = {"title": title, "body": body}
    got = edismax(idx, "a b", qf=["title^2", "body"], mm="2<75%", tie=0.1,
                  pf=["title", "body"], pf2=["body"], k1=1.2, b=0.75).vals

    def s(ix, q, d):
        sc = score_query(ix, q, 0, 1.2, 0.75)
        return dict(zip(sc.docs.tolist(), sc.vals.tolist())).get(d, 0.0)

    # doc 0 matches both terms in both fields; mm = 2 of 2
    want = 0.0
    for t in ("a", "b"):
        fs = [2 * s(title, t, 0), s(body, t, 0)]
        want += max(fs) + 0.1 * (sum(fs) - max(fs))
    want += s(title, ["a", "b"], 0) + s(body, ["a", "b"], 0)   # pf
    want += 2 * s(body, ["a", "b"], 0)      # pf2: the last bigram twice
    assert got[0] == pytest.approx(want, rel=1e-14)
    assert got[1] == 0.0 and got[2] == 0.0  # one term of two: mm fails


def test_bf16_rounds_to_eight_bits():
    assert bf16(1.0 + 2 ** -9) == 1.0
    assert bf16(1.0 + 2 ** -7) == 1.0 + 2 ** -7
    assert bf16(1.0 + 3 * 2 ** -9) == 1.0 + 2 ** -7   # ties to even


def test_judge_numbers_by_hand():
    ref = Scores(8, np.array([1, 3, 5]), np.array([2.0, 4.0, 1.0]))
    assert judge_one(np.array([4.0, 2.0, 1.0]), np.array([3, 1, 5]), ref,
                     3) == (0.0, 0.0, 0)
    sg, rg, of = judge_one(np.array([4.0, 2.0, 1.01]), np.array([3, 1, 5]),
                           ref, 3)
    assert sg == pytest.approx(0.01 / 4) and rg == 0.0 and of == 0
    # a worse doc ranked in: doc 6 (score 0) in place of doc 5
    sg, rg, of = judge_one(np.array([4.0, 2.0, 0.0]), np.array([3, 1, 6]),
                           ref, 3)
    assert rg == pytest.approx(1.0 / 4) and of == 1   # doc 0 scores 0 too
    # ties to the smaller index: zero-score docs fill in index order
    assert judge_one(np.array([4.0, 2.0, 1.0, 0.0]),
                     np.array([3, 1, 5, 2]), ref, 4)[2] == 1
    assert judge_one(np.array([4.0, 2.0, 1.0, 0.0]),
                     np.array([3, 1, 5, 0]), ref, 4)[2] == 0
    # a doc twice or outside the corpus fails outright
    assert judge_one(np.array([4.0, 4.0, 1.0]), np.array([3, 3, 5]), ref,
                     3)[2] == 1
    assert judge_one(np.array([4.0, 2.0, 1.0]), np.array([3, 1, 99]), ref,
                     3)[0] == float("inf")
    got = judge([(np.array([4.0, 2.0, 1.0]), np.array([3, 1, 5]), ref)] * 2, 3)
    assert got["compared"] == 2 and got["order_faults"] == 0
