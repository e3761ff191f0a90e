"""Slop-N phrase matching as a windowed bitmap test.

A doc position ``p`` of the *rarest* query term (the anchor) is covered if
some window ``[s, s+w]`` with ``s <= p <= s+w`` and ``w = n + slop - 1``
holds at least ``m_t`` occurrences of every distinct query term ``t``
(``m_t`` = multiplicity of ``t`` in the query, ``n`` = query length).  The
doc's slop frequency is its number of covered anchor positions.  Slop
counts are at least the exact phrase counts and never fall as slop grows.
The span width bound is applied soundly (Lucene SpanNear-like); the
reference's automaton matches at any distance through a position leak.

The port of ``searcharray_tpu/search/spans.py:span_freqs_dense`` for the
queries its dense route takes: no position window, ``w <= 18``, no term
more than twice, on a dense-eligible corpus whose plane pool holds the
terms.  Those run K6 (``ops/cuda/score.py:span_window``) on the term
planes.  Every other slop query needs the sparse neighbourhood kernel,
which is not ported yet: it raises ``NotImplementedError`` and touches
neither pool.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.ops.encoding import LSB_BITS
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.search.phrase import SLOP_TODO
from searcharray_tpu_torch.search.scoring import _window_blocks, host_idf


def unique_terms(term_ids: Sequence[int]) -> Tuple[List[int], List[int]]:
    """A query's distinct terms in first-seen order, and how often each
    occurs in it."""
    uniq: List[int] = []
    mults: List[int] = []
    for t in term_ids:
        if t in uniq:
            mults[uniq.index(t)] += 1
        else:
            uniq.append(t)
            mults.append(1)
    return uniq, mults


def dense_window_ok(n_terms: int, slop: int, mults: Sequence[int]) -> bool:
    """Whether the dense window kernel takes a slop query's shape: the
    window within one slot shift, no term more than twice."""
    return n_terms + slop - 1 <= LSB_BITS and max(mults) <= 2


def check_dense_span(index: DeviceIndex, term_ids: Sequence[int], slop: int,
                     windowed: bool = False) -> None:
    """Raise ``NotImplementedError`` for a slop phrase (two or more
    resolved terms, every posting non-empty) that the dense window kernel
    cannot take; such queries wait for the sparse span kernel."""
    uniq, mults = unique_terms(term_ids)
    if (windowed or not dense_window_ok(len(term_ids), slop, mults)
            or not dense.dense_eligible(index)
            or not dense.phrase_fits_pool(index, uniq)):
        raise NotImplementedError(SLOP_TODO)


def span_freqs_dense(index: DeviceIndex, term_ids: List[int], slop: int,
                     min_posn: Optional[int] = None,
                     max_posn: Optional[int] = None, kind: str = "none",
                     k1: float = 1.2, b: float = 0.75,
                     idf: Optional[float] = None) -> torch.Tensor:
    """Dense per-doc slop-phrase frequencies (kind ``none``) or scores,
    f32[N] on the index's device."""
    if len(term_ids) < 2:
        raise ValueError("Must have at least two terms")
    _window_blocks(min_posn, max_posn)  # a malformed window raises first
    windowed = min_posn is not None or max_posn is not None
    uniq, mults = unique_terms(term_ids)
    spans = [index.term_span(t) for t in uniq]
    if min(s[1] for s in spans) == 0:
        return torch.zeros(index.corpus_size, dtype=torch.float32,
                           device=index.device)
    check_dense_span(index, term_ids, slop, windowed)
    anchor_i = int(np.argmin([s[1] for s in spans]))
    if idf is None:
        idf = host_idf(kind, [index.doc_freqs[t] for t in term_ids],
                       index.corpus_size, index.avg_doc_length)
    return dense.score_span_dense(index, uniq, anchor_i,
                                  len(term_ids) + slop - 1, kind, k1, b, idf,
                                  mults=tuple(mults))
