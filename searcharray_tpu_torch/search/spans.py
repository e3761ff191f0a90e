"""Slop-N phrase matching as a windowed bitmap test.

A doc position ``p`` of the *rarest* query term (the anchor) is covered if
some window ``[s, s+w]`` with ``s <= p <= s+w`` and ``w = n + slop - 1``
holds at least ``m_t`` occurrences of every distinct query term ``t``
(``m_t`` = multiplicity of ``t`` in the query, ``n`` = query length).  The
doc's slop frequency is its number of covered anchor positions.  Slop
counts are at least the exact phrase counts and never fall as slop grows.
The span width bound is applied soundly (Lucene SpanNear-like); the
reference's automaton matches at any distance through a position leak.

The port of ``searcharray_tpu/search/spans.py:span_freqs_dense``'s two
routes.  A query with no position window, ``w <= 18`` and no term more
than twice, on a dense-eligible corpus whose plane pool holds the terms,
runs K6 (``ops/cuda/score.py:span_window``) on the term planes, in the
batch driver (``takes_dense_span`` routes it there).  Every other slop
query, and every windowed one (``span_freqs_dense``), runs K9
(``span_sparse``) on the doc-sorted posting slices: per anchor word the
neighbouring words of every term, the windows counted in registers, then
K2 sums the words' counts per doc.  The JAX package's per-shape jit cache
and posting buckets have no counterpart here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.ops.cuda import score as kernels_cuda
from searcharray_tpu_torch.ops.encoding import LSB_BITS
from searcharray_tpu_torch.ops.kernels import apply_similarity_device
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.search.scoring import _window_blocks, query_idf


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


def anchor_of(index: DeviceIndex, uniq: Sequence[int]) -> int:
    """The anchor of a slop phrase, as an index into its distinct terms:
    the first with the fewest posting words in the corpus
    (``stats_lengths``: a shard's are its corpus's, so each shard counts
    the anchor the whole index would)."""
    lengths = [int(index.stats_lengths[t]) for t in uniq]
    return lengths.index(min(lengths))


def dense_window_ok(n_terms: int, slop: int, mults: Sequence[int]) -> bool:
    """Whether the dense window kernel takes a slop query's shape: the
    window within one slot shift, no term more than twice."""
    return n_terms + slop - 1 <= LSB_BITS and max(mults) <= 2


def takes_dense_span(index: DeviceIndex, term_ids: Sequence[int],
                     slop: int) -> bool:
    """The batch driver's router of an unwindowed slop phrase (two or
    more resolved terms, every posting non-empty): True where the dense
    window kernel K6 takes it, False where it runs K9 on the posting
    slices (a window above 18 positions, a term more than twice, a corpus
    that is not dense-eligible, more distinct terms than the plane pool
    holds)."""
    uniq, mults = unique_terms(term_ids)
    return (dense_window_ok(len(term_ids), slop, mults)
            and dense.dense_eligible(index)
            and dense.phrase_fits_pool(index, uniq))


def sparse_span_freqs(hdrs: torch.Tensor, pays: torch.Tensor, offs, ns,
                      w: int, mults, *, anchor: int = 0, blk_bits: int,
                      key_stride: int, min_blk=None,
                      max_blk=None) -> torch.Tensor:
    """Slop freqs of a chunk of queries sharing one window, anchor column
    and multiplicities, on their posting slices: f32 [Q, key_stride].
    ``offs``/``ns`` are host int [Q, T] arrays of each query's distinct
    terms' slices.  One K9 launch for all queries, then one K2 launch over
    its flat ``q * key_stride + doc`` keys."""
    Q = len(offs)
    keys, counts = kernels_cuda.span_sparse(
        hdrs, pays, offs, ns, w, mults, anchor=anchor, blk_bits=blk_bits,
        key_stride=key_stride, min_blk=min_blk, max_blk=max_blk)
    return kernels_cuda.segment_sum(
        keys, counts, num_docs=Q * key_stride).reshape(Q, key_stride)


def span_freqs_dense(index: DeviceIndex, term_ids: List[int], slop: int,
                     min_posn: Optional[int] = None,
                     max_posn: Optional[int] = None, kind: str = "none",
                     k1: float = 1.2, b: float = 0.75,
                     idf: Optional[float] = None) -> torch.Tensor:
    """Dense per-doc slop-phrase frequencies (kind ``none``) or scores,
    f32[N] on the index's device, by K9 on the posting slices, inside the
    position window when one is given.  Takes no pool slot and no lock."""
    if len(term_ids) < 2:
        raise ValueError("Must have at least two terms")
    min_blk, max_blk = _window_blocks(min_posn, max_posn)
    windowed = min_posn is not None or max_posn is not None
    uniq, mults = unique_terms(term_ids)
    spans = [index.term_span(t) for t in uniq]
    if min(s[1] for s in spans) == 0:
        return torch.zeros(index.corpus_size, dtype=torch.float32,
                           device=index.device)
    if idf is None:
        idf = query_idf(index, kind, term_ids)
    freqs = sparse_span_freqs(
        index.hdrs, index.pays, [[s[0] for s in spans]],
        [[s[1] for s in spans]], len(term_ids) + slop - 1, mults,
        anchor=anchor_of(index, uniq), blk_bits=index.blk_bits,
        key_stride=index.corpus_size,
        min_blk=min_blk if windowed else None,
        max_blk=max_blk if windowed else None)[0]
    avgdl = np.float32(max(index.avg_doc_length, 1e-38))
    return apply_similarity_device(kind, freqs, index.doc_lens,
                                   np.float32(idf), avgdl, k1, b, out=freqs)
