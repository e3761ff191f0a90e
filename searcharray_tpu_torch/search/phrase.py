"""Exact phrases: the chain plan and single-query phrase freqs / scores.

A phrase's freq in a doc is the minimum, over the steps of a chain of
bigram matches, of the step's per-doc count (the reference's
``compute_phrase_freqs``, `searcharray/phrase/middle_out.py:154-168`).
On a dense-eligible corpus every step runs on the term planes of the
plane pool (search/dense.py, kernel K5).  Windowed phrases, corpora or
phrases the plane pool cannot take, and phrases of more than
``CHAIN_MAX_TERMS`` terms need the sparse sort-merge chain, which is not
ported yet: they raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.search.scoring import _window_blocks, host_idf

SPARSE_TODO = ("windowed phrases, phrases on corpora the dense plane pool "
               "cannot take, and phrases with more terms than it or the "
               f"chain kernel K5 ({dense.CHAIN_MAX_TERMS} terms) takes, need "
               "the sparse phrase chain (ROADMAP Queue 1 item 8)")
SLOP_TODO = "slop phrases are not ported yet (ROADMAP Queue 1 item 9)"


def _plan(n: int, split: int):
    """Chain layout, parity with compute_phrase_freqs (middle_out.py:154-168):
    one left-to-right or right-to-left chain, or two halves split at the
    rarest term."""
    if split <= 1:
        return [("l2r", list(range(n)))]
    if split >= n - 2:
        return [("r2l", list(range(n)))]
    return [("l2r", list(range(split))), ("r2l", list(range(split, n)))]


def chain_key(dev: DeviceIndex, term_ids: List[int]):
    """(plan key, pattern) of a phrase: the plan split at the rarest term
    (fewest posting words), and each term's first index as its same-term
    tag."""
    lengths = [dev.term_span(t)[1] for t in term_ids]
    plan = _plan(len(term_ids), int(np.argmin(lengths)))
    return (tuple((d, tuple(ix)) for d, ix in plan),
            tuple(term_ids.index(t) for t in term_ids))


def phrase_freqs_dense(index: DeviceIndex, term_ids: List[int],
                       min_posn: Optional[int] = None,
                       max_posn: Optional[int] = None,
                       kind: str = "none", k1: float = 1.2, b: float = 0.75,
                       idf: Optional[float] = None) -> torch.Tensor:
    """Dense per-doc exact phrase frequencies (kind ``none``) or scores,
    f32[N] on the index's device."""
    if len(term_ids) < 2:
        raise ValueError("Must have at least two terms")
    _window_blocks(min_posn, max_posn)  # validate before anything else
    if min_posn is not None or max_posn is not None:
        raise NotImplementedError(SPARSE_TODO)
    lengths = [index.term_span(t)[1] for t in term_ids]
    if min(lengths) == 0:
        return torch.zeros(index.corpus_size, dtype=torch.float32,
                           device=index.device)
    if not (dense.dense_eligible(index)
            and dense.phrase_fits_pool(index, term_ids)):
        raise NotImplementedError(SPARSE_TODO)
    if idf is None:
        idf = host_idf(kind, [index.doc_freqs[t] for t in term_ids],
                       index.corpus_size, index.avg_doc_length)
    plan_key, pattern = chain_key(index, term_ids)
    return dense.score_phrase_dense(index, term_ids, plan_key, pattern,
                                    kind, k1, b, idf)
