"""BM25, ranked top-k and Solr edismax, in float64 over ``RefIndex``.

BM25 in the form the system documents (Lucene 9, no (k1 + 1) factor):
``score = tf / (tf + k1 * ((1 - b) + b * dl / avgdl)) * idf``, ``idf``
the sum of ln(1 + (N - df + 0.5) / (df + 0.5)) over the query's words.
A ranked list orders docs by score, descending, equal scores by the
smaller doc index first; docs that match nothing (score 0) fill it in
index order.

``rnd`` stands for the arithmetic: ``exact`` is float64, ``bf16``
rounds every operation's result to bfloat16, the control that a lower
precision must fail.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.index import RefIndex


def exact(x):
    return np.asarray(x, dtype=np.float64)


def bf16(x):
    """Round to the nearest bfloat16 (ties to even), kept as float64."""
    f = np.asarray(x, dtype=np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


class Scores:
    """One query's scores over ``n`` docs: sparse (``docs`` ascending,
    ``vals`` > 0) with every other doc at 0, or dense (``vals`` of length
    n, ``docs`` None)."""

    def __init__(self, n: int, docs: Optional[np.ndarray], vals: np.ndarray):
        self.n, self.docs, self.vals = n, docs, vals
        self._top: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._equal: Dict[float, np.ndarray] = {}

    def at(self, idx: np.ndarray) -> np.ndarray:
        """Scores of the docs ``idx`` (indices outside [0, n) read NaN)."""
        idx = np.asarray(idx, dtype=np.int64)
        out = np.full(len(idx), np.nan)
        ok = (idx >= 0) & (idx < self.n)
        if self.docs is None:
            out[ok] = self.vals[idx[ok]]
            return out
        want = idx[ok]
        pos = np.searchsorted(self.docs, want)
        hit = pos < len(self.docs)
        hit[hit] = self.docs[pos[hit]] == want[hit]
        got = np.zeros(len(want))
        got[hit] = self.vals[pos[hit]]
        out[ok] = got
        return out

    def equal_before(self, value: float, idx: int) -> int:
        """How many docs below index ``idx`` score exactly ``value``."""
        if self.docs is not None and value == 0:
            return idx - int(np.searchsorted(self.docs, idx))
        m = self._equal.get(value)
        if m is None:
            where = self.vals == value
            m = np.flatnonzero(where) if self.docs is None else self.docs[where]
            self._equal[value] = m
        return int(np.searchsorted(m, idx))

    def top(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, doc indices) of the k best, ties to the smaller
        index."""
        k = min(k, self.n)
        got = self._top.get(k)
        if got is None:
            got = self._top[k] = self._select(k)
        return got

    def _select(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        docs = (np.arange(self.n, dtype=np.int64) if self.docs is None
                else self.docs)
        v = self.vals
        if k < len(v):
            # the docs above the k-th best score in order, then those at
            # it in index order (docs ascend)
            kth = np.partition(v, len(v) - k)[len(v) - k]
            above = np.flatnonzero(v > kth)
            ties = np.flatnonzero(v == kth)[: k - len(above)]
            pick = np.concatenate(
                [above[np.lexsort((docs[above], -v[above]))], ties])
        else:
            pick = np.lexsort((docs, -v))
        idx = docs[pick]
        if len(idx) < k:       # sparse: docs scoring 0 fill in index order
            fill = np.setdiff1d(np.arange(min(self.n, k + len(self.docs))),
                                self.docs, assume_unique=True)
            idx = np.concatenate([idx, fill[: k - len(idx)]])
        return self.at(idx), idx


def bm25(index: RefIndex, docs: np.ndarray, freqs: np.ndarray,
         words: Sequence[str], k1: float, b: float, rnd=exact) -> np.ndarray:
    """BM25 of the docs ``docs`` whose query frequency is ``freqs``."""
    tf = rnd(freqs)
    idf = rnd(index.idf(words))
    norm = rnd(rnd(1.0 - b) + rnd(rnd(b) * rnd(index.dl[docs]
                                                / rnd(index.avgdl))))
    denom = rnd(tf + rnd(rnd(k1) * norm))
    return rnd(rnd(tf / denom) * idf)


def score_query(index: RefIndex, query, slop: int, k1: float, b: float,
                rnd=exact) -> Scores:
    """One term (a string), exact phrase or slop phrase (a list of
    words), sparse."""
    words = [query] if isinstance(query, str) else list(query)
    docs, freqs = index.freqs(words, slop)
    return Scores(index.n_docs, docs, bm25(index, docs, freqs, words, k1, b,
                                           rnd))


def dense_query(index: RefIndex, words: Sequence[str], slop: int, k1: float,
                b: float, rnd=exact) -> np.ndarray:
    s = score_query(index, list(words) if len(words) > 1 else words[0],
                    slop, k1, b, rnd)
    out = np.zeros(index.n_docs)
    out[s.docs] = s.vals
    return out


# -- Solr edismax -----------------------------------------------------
def min_should_match(n: int, spec: str) -> int:
    """Solr's minimum-should-match: an integer, a negative integer (all
    but that many), a percentage (rounded down; negative: all but that
    share), or conditions "a<expr b<expr": the expression of the last
    condition whose bound ``n`` exceeds, all clauses where none does."""
    spec = spec.strip()
    if "<" in spec:
        got = n
        for cond in re.sub(r"\s*<\s*", "<", spec).split():
            bound, expr = cond.split("<")
            if n > int(bound):
                got = min_should_match(n, expr)
        return got
    if spec.endswith("%"):
        pct = int(spec[:-1])
        share = int(n * abs(pct) / 100)
        need = n - share if pct < 0 else share
    else:
        val = int(spec)
        need = n + val if val < 0 else val
    return min(n, max(need, 0))


def parse_boosts(fields: Sequence[str]) -> Dict[str, float]:
    out = {}
    for f in fields:
        name, _, boost = f.partition("^")
        out[name] = float(boost) if boost else 1.0
    return out


def edismax(indexes: Dict[str, RefIndex], q: str, *, qf, mm: str,
            tie: float, pf=(), pf2=(), k1: float, b: float,
            rnd=exact, dense=None) -> Scores:
    """Solr edismax over whitespace-tokenized fields, dense.  Every field
    splits the query into the same terms, so it is term centric: per
    term the best boosted field score plus ``tie`` times the rest, summed
    over the terms where at least mm of them score.  Then, at docs the
    main query matched, the pf fields' whole-phrase scores and the pf2
    fields' bigram scores (the last bigram counted twice, as the
    reference library does), each times its field's boost.  ``dense(field, words)``
    gives a term's or an exact phrase's dense scores (by default computed
    here; a caller may cache them)."""
    qfb = parse_boosts(qf)
    words = q.split()
    n = next(iter(indexes.values())).n_docs

    def dq(field, words):
        if dense is not None:
            return dense(field, words)
        return dense_query(indexes[field], words, 0, k1, b, rnd)

    msm = min_should_match(len(words), mm)
    tot = np.zeros(n)
    cnt = np.zeros(n, dtype=np.int64)
    for word in words:
        fs = [rnd(dq(f, [word]) * rnd(bst)) for f, bst in qfb.items()]
        mx = np.maximum.reduce(fs)
        sm = fs[0]
        for x in fs[1:]:
            sm = rnd(sm + x)
        ts = rnd(mx + rnd(rnd(sm - mx) * rnd(tie)))
        cnt += ts > 0
        tot = rnd(tot + ts)
    main = np.where(cnt >= msm, tot, 0.0)
    extra = np.zeros(n)
    for f, bst in parse_boosts(pf).items():
        if len(words) >= 2:
            extra = rnd(extra + rnd(dq(f, words) * rnd(bst)))
    for f, bst in parse_boosts(pf2).items():
        grams = [words[i: i + 2] for i in range(len(words) - 1)]
        if grams:
            part = np.zeros(n)
            for g in grams + grams[-1:]:
                part = rnd(part + dq(f, g))
            extra = rnd(extra + rnd(part * rnd(bst)))
    return Scores(n, None, np.where(main > 0, rnd(main + extra), main))

