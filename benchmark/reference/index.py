"""A plain inverted index over generated token ids, and the match counts of
the query kinds the benchmark sends.

Built from the token arrays the benchmark generated (the same inputs the
system under test indexes as strings), never from anything the system
made.  Semantics, as the system documents them for the reference
searcharray it ports:

* a term's frequency in a doc is its number of occurrences;
* a term's "posting words" are its distinct (doc, position // 18) pairs:
  the roaringish encoding stores 18 positions a word, and the reference
  library picks a phrase's split and a slop phrase's anchor by them;
* an exact phrase of n terms is matched as one chain, or, where its
  rarest term (fewest posting words, first of equals) sits at index
  2..n-3, as two halves split there (terms [0, split) and [split, n));
  a half's count in a doc is the number of places its terms occur in
  order at consecutive positions, and the phrase's count is the least of
  its halves' counts.  Where a half's first bigram (the first two terms
  of the left half, the last two of the right or of a single chain read
  right to left) is one term twice, the half's count is at most that
  bigram's "same-term" count, the reference library's correction for
  runs of one term: per posting word, its adjacent pairs less half its
  adjacent triples rounded up, plus the pairs that cross from one word
  into the next;
* a slop phrase (slop > 0, n >= 2 terms) counts the positions p of its
  anchor (the distinct term with the fewest posting words, first of
  equals) for which some window [s, s + w], s <= p <= s + w, w = n + slop
  - 1, inside the doc holds at least m_t occurrences of every distinct
  term t, m_t its multiplicity in the query.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

BLOCK = 18  # positions per posting word


class RefIndex:
    """Token ids in document order (``tokens``, one flat array) cut into
    documents by ``lens``; ``vocab`` maps each word to its token id."""

    def __init__(self, tokens: np.ndarray, lens: np.ndarray,
                 vocab: Dict[str, int]):
        self.vocab = vocab
        self.n_docs = int(len(lens))
        self.lens = np.asarray(lens, dtype=np.int64)
        self.bounds = np.zeros(self.n_docs + 1, dtype=np.int64)
        np.cumsum(self.lens, out=self.bounds[1:])
        size = max(len(vocab), int(tokens.max()) + 1 if len(tokens) else 0)
        # 16-bit ids sort by radix in numpy: the whole index in about a
        # second at tens of millions of tokens
        small = size <= np.iinfo(np.uint16).max
        self.tokens = np.asarray(tokens, np.uint16 if small else np.int64)
        self.order = np.argsort(self.tokens, kind="stable")
        self.starts = np.zeros(size + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.tokens, minlength=size),
                  out=self.starts[1:])
        self.doc_of = np.repeat(np.arange(self.n_docs, dtype=np.int64),
                                self.lens)
        self.dl = self.lens.astype(np.float64)
        self.avgdl = float(self.dl.mean()) if self.n_docs else 0.0
        self._stats: Dict[int, Tuple[np.ndarray, np.ndarray, int]] = {}

    # -- terms ---------------------------------------------------------
    def term_id(self, word: str) -> int:
        """The word's token id, or -1 where the corpus never uses it."""
        tid = self.vocab.get(word, -1)
        if tid < 0 or tid + 1 >= len(self.starts):
            return -1
        return tid if self.starts[tid + 1] > self.starts[tid] else -1

    def positions(self, tid: int) -> np.ndarray:
        """Global positions of a term, ascending."""
        return self.order[self.starts[tid]: self.starts[tid + 1]]

    def stats(self, tid: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(docs holding the term ascending, its frequency in each, its
        posting words)."""
        got = self._stats.get(tid)
        if got is None:
            pos = self.positions(tid)
            docs = self.doc_of[pos]
            cut = np.flatnonzero(np.diff(docs)) + 1
            starts = np.concatenate([[0], cut])
            uniq = docs[starts]
            tf = np.diff(np.concatenate([starts, [len(docs)]]))
            word = docs * 16384 + (pos - self.bounds[docs]) // BLOCK
            n_words = int(np.count_nonzero(np.diff(word))) + (len(word) > 0)
            got = (uniq, tf, n_words)
            self._stats[tid] = got
        return got

    def doc_freq(self, tid: int) -> int:
        return len(self.stats(tid)[0])

    def words(self, tid: int) -> int:
        return self.stats(tid)[2]

    # -- match counts (sparse: docs ascending, counts > 0) --------------
    def occurrences(self, tids: Sequence[int]) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """Per doc, the places where ``tids`` occur in order at
        consecutive positions, found from the rarest term's positions."""
        n = len(tids)
        lead = int(np.argmin([self.starts[t + 1] - self.starts[t]
                              for t in tids]))
        start = self.positions(tids[lead]).astype(np.int64) - lead
        docs = self.doc_of[np.clip(start, 0, len(self.doc_of) - 1)]
        ok = (start >= self.bounds[docs]) & (start + n <= self.bounds[docs + 1])
        start, docs = start[ok], docs[ok]
        for j, t in enumerate(tids):
            if j == lead or not len(start):
                continue
            hit = self.tokens[start + j] == t
            start, docs = start[hit], docs[hit]
        return _count_by_doc(docs)

    def same_term(self, tid: int):
        """The same-term count of the bigram (tid, tid), per doc."""
        pos = self.positions(tid).astype(np.int64)
        docs = self.doc_of[pos]
        blk = (pos - self.bounds[docs]) // BLOCK
        pair = (np.diff(pos) == 1) & (np.diff(docs) == 0)
        inside = pair & (np.diff(blk) == 0)
        cross = pair & ~inside
        triple = inside[1:] & inside[:-1]
        # per posting word: its pairs less half its triples, rounded up
        word = docs * 16384 + blk
        words, adj = np.unique(word[1:][inside], return_counts=True)
        con = np.zeros(len(words), np.int64)
        np.add.at(con, np.searchsorted(words, word[2:][triple]), 1)
        per_doc = np.concatenate([np.repeat(words // 16384, adj - (con + 1)
                                            // 2), docs[1:][cross]])
        return _count_by_doc(np.sort(per_doc))

    def half_freqs(self, tids: Sequence[int], first_pair: Tuple[int, int]):
        """One chain half: its occurrences, capped by the same-term count
        where its first bigram is one term twice."""
        docs, counts = self.occurrences(tids)
        a, b = first_pair
        if tids[a] != tids[b]:
            return docs, counts
        sd, sc = self.same_term(tids[a])
        both, i, j = np.intersect1d(docs, sd, assume_unique=True,
                                    return_indices=True)
        got = np.minimum(counts[i], sc[j])
        return both[got > 0], got[got > 0]

    def phrase_freqs(self, tids: Sequence[int]):
        """Exact phrase counts (the split rule in the module doc)."""
        n = len(tids)
        split = int(np.argmin([self.words(t) for t in tids]))
        if split <= 1:
            return self.half_freqs(tids, (0, 1))
        if split >= n - 2:
            return self.half_freqs(tids, (n - 2, n - 1))
        left = self.half_freqs(tids[:split], (0, 1))
        right = self.half_freqs(tids[split:], (n - split - 2, n - split - 1))
        docs, li, ri = np.intersect1d(left[0], right[0], assume_unique=True,
                                      return_indices=True)
        return docs, np.minimum(left[1][li], right[1][ri])

    def slop_freqs(self, tids: Sequence[int], slop: int):
        """Slop phrase counts: covered anchor positions per doc."""
        uniq: List[int] = []
        mults: List[int] = []
        for t in tids:
            if t in uniq:
                mults[uniq.index(t)] += 1
            else:
                uniq.append(t)
                mults.append(1)
        anchor = uniq[int(np.argmin([self.words(t) for t in uniq]))]
        w = len(tids) + slop - 1
        p = self.positions(anchor).astype(np.int64)
        docs = self.doc_of[p]
        lo, hi = self.bounds[docs], self.bounds[docs + 1]
        # the doc's tokens around each anchor, -1 outside the doc
        offs = np.arange(-w, w + 1, dtype=np.int64)
        at = p[:, None] + offs[None, :]
        inside = (at >= lo[:, None]) & (at < hi[:, None])
        near = np.where(inside, self.tokens[np.clip(at, 0, len(self.tokens)
                                                    - 1)].astype(np.int64),
                        -1)
        covered = np.zeros(len(p), dtype=bool)
        counts = []
        for t in uniq:
            c = np.zeros((len(p), 2 * w + 2), dtype=np.int16)
            np.cumsum(near == t, axis=1, out=c[:, 1:])
            counts.append(c)
        for s in range(w + 1):            # window columns [s, s + w]
            ok = np.ones(len(p), dtype=bool)
            for c, m in zip(counts, mults):
                ok &= (c[:, s + w + 1] - c[:, s]) >= m
            covered |= ok
        return _count_by_doc(docs[covered])

    def tf(self, tid: int):
        docs, tf, _ = self.stats(tid)
        return docs, tf

    def freqs(self, words: Sequence[str], slop: int = 0):
        """Sparse (docs, counts) of one query: a term, an exact phrase or
        a slop phrase, given as words.  A word the corpus never uses
        matches nothing."""
        tids = [self.term_id(w) for w in words]
        if not tids or min(tids) < 0:
            return _EMPTY
        if len(tids) == 1:
            return self.tf(tids[0])
        if slop > 0:
            return self.slop_freqs(tids, slop)
        return self.phrase_freqs(tids)

    def idf(self, words: Sequence[str]) -> float:
        """BM25's idf of a query: the sum over its words (repeats
        included) of ln(1 + (N - df + 0.5) / (df + 0.5))."""
        out = 0.0
        for w in words:
            tid = self.term_id(w)
            df = self.doc_freq(tid) if tid >= 0 else 0
            out += float(np.log1p((self.n_docs - df + 0.5) / (df + 0.5)))
        return out


_EMPTY = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))


def _count_by_doc(docs: np.ndarray):
    """Sorted doc ids (repeats allowed) -> (distinct docs, repeats)."""
    if not len(docs):
        return _EMPTY
    cut = np.flatnonzero(np.diff(docs)) + 1
    starts = np.concatenate([[0], cut])
    return docs[starts], np.diff(np.concatenate([starts, [len(docs)]]))
