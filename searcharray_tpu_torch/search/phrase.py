"""Exact phrases: the chain plan and single-query phrase freqs / scores.

A phrase's freq in a doc is the minimum, over the steps of a chain of
bigram matches, of the step's per-doc count (the reference's
``compute_phrase_freqs``, `searcharray/phrase/middle_out.py:154-168`).
On a dense-eligible corpus every step runs on the term planes of the
plane pool (search/dense.py, kernel K5).  Windowed phrases, corpora or
phrases the plane pool cannot take, and phrases of more than
``CHAIN_MAX_TERMS`` terms take the sparse chain on the doc-sorted posting
slices: each step is one K7 launch (``ops/cuda/score.py:merge_step``)
whose (doc key, count) pairs K2 sums per doc.  The JAX package runs that
step as a sort of both lists; its compile-reuse machinery (per-step and
composite jits, the merged one-sort chain, the Pallas tile bound) has no
counterpart here.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.ops.cuda import score as kernels_cuda
from searcharray_tpu_torch.ops.kernels import apply_similarity_device
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.search.scoring import _window_blocks, host_idf

TRIM_FACTOR = 20  # reference parity: middle_out.py:66


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


def trim_spans(index: DeviceIndex, spans):
    """Pre-slice frequent terms to the rarest term's doc-key range.

    The analog of the reference's ``trim_phrase_search``
    (`searcharray/phrase/middle_out.py:44-70`): any term more than
    TRIM_FACTOR times longer than the rarest is narrowed, by a binary
    search on its sorted host posting words, to the key window the rarest
    term occupies.  Docs outside that window cannot match the phrase (the
    rarest term's own chain step scores them 0 and the freq is the min
    over steps), so results are identical.  ``spans`` are (off, n, ...)
    tuples; returns (off, n) pairs."""
    lengths = [s[1] for s in spans]
    n_r = min(lengths)
    if n_r == 0 or max(lengths) <= TRIM_FACTOR * n_r:
        return [(s[0], s[1]) for s in spans]
    data = index.postings.data
    off_r = spans[int(np.argmin(lengths))][0]
    lo_word = (int(data[off_r]) >> 36) << 36
    hi_word = ((int(data[off_r + n_r - 1]) >> 36) + 1) << 36
    out = []
    for s in spans:
        off, n = s[0], s[1]
        if n > TRIM_FACTOR * n_r:
            sl = data[off: off + n]
            lo = int(np.searchsorted(sl, np.uint64(lo_word)))
            hi = int(np.searchsorted(sl, np.uint64(hi_word)))
            off, n = off + lo, hi - lo
        out.append((off, n))
    return out


def sparse_chain_freqs(hdrs: torch.Tensor, pays: torch.Tensor, offs, ns,
                       plan, pattern, *, blk_bits: int, key_stride: int,
                       min_blk=None, max_blk=None) -> torch.Tensor:
    """Exact phrase freqs of a chunk of queries sharing one chain
    structure, on their doc-sorted posting slices: f32 [Q, key_stride].

    ``offs``/``ns`` are host int [Q, T] arrays of each query's term slices
    in ``hdrs``/``pays``, ``plan`` the chain halves and ``pattern`` the
    same-term tags.  Every chain step is one K7 launch for all queries
    (the base is the step's raw term, the other the neighbouring raw term
    or the carry: the previous base's headers with the continuation that
    step wrote) and one K2 launch over its flat ``q * key_stride + doc``
    keys; the freqs are the min over the steps."""
    offs = np.asarray(offs, dtype=np.int64)
    ns = np.asarray(ns, dtype=np.int64)
    Q = offs.shape[0]
    freqs = None
    for direction, idxs in plan:
        l2r = direction == "l2r"
        order = (range(1, len(idxs)) if l2r
                 else range(len(idxs) - 2, -1, -1))
        carry = None   # (continuation payloads, per-query offsets in them)
        for i in order:
            base = idxs[i]
            other = idxs[i - 1] if l2r else idxs[i + 1]
            last = i == (len(idxs) - 1 if l2r else 0)
            other_pays, other_pay_off = (
                (pays, offs[:, other]) if carry is None else carry)
            keys, counts, cont = kernels_cuda.merge_step(
                hdrs, pays, other_pays, offs[:, base], ns[:, base],
                offs[:, other], ns[:, other], other_pay_off,
                cont_side="rhs" if l2r else "lhs",
                same_term=carry is None and pattern[base] == pattern[other],
                blk_bits=blk_bits, key_stride=key_stride, min_blk=min_blk,
                max_blk=max_blk, need_cont=not last)
            per_doc = kernels_cuda.segment_sum(keys, counts,
                                               num_docs=Q * key_stride)
            freqs = (per_doc if freqs is None
                     else torch.minimum(freqs, per_doc))
            carry = (cont, kernels_cuda.prefix_offsets(ns[:, base]))
    return freqs.reshape(Q, key_stride)


def phrase_freqs_dense(index: DeviceIndex, term_ids: List[int],
                       min_posn: Optional[int] = None,
                       max_posn: Optional[int] = None,
                       kind: str = "none", k1: float = 1.2, b: float = 0.75,
                       idf: Optional[float] = None) -> torch.Tensor:
    """Dense per-doc exact phrase frequencies (kind ``none``) or scores,
    f32[N] on the index's device."""
    if len(term_ids) < 2:
        raise ValueError("Must have at least two terms")
    min_blk, max_blk = _window_blocks(min_posn, max_posn)
    windowed = min_posn is not None or max_posn is not None
    spans = [index.term_span(t) for t in term_ids]
    if min(s[1] for s in spans) == 0:
        return torch.zeros(index.corpus_size, dtype=torch.float32,
                           device=index.device)
    if idf is None:
        idf = host_idf(kind, [index.doc_freqs[t] for t in term_ids],
                       index.corpus_size, index.avg_doc_length)
    # the plan splits at the rarest term by the untrimmed lengths
    plan_key, pattern = chain_key(index, term_ids)
    if (not windowed and dense.dense_eligible(index)
            and dense.phrase_fits_pool(index, term_ids)):
        return dense.score_phrase_dense(index, term_ids, plan_key, pattern,
                                        kind, k1, b, idf)
    # sparse chain from here: bound stopword slices by the rarest term
    spans = trim_spans(index, spans)
    freqs = sparse_chain_freqs(
        index.hdrs, index.pays, [[s[0] for s in spans]],
        [[s[1] for s in spans]], plan_key, pattern, blk_bits=index.blk_bits,
        key_stride=index.corpus_size,
        min_blk=min_blk if windowed else None,
        max_blk=max_blk if windowed else None)[0]
    avgdl = np.float32(max(index.avg_doc_length, 1e-38))
    return apply_similarity_device(kind, freqs, index.doc_lens,
                                   np.float32(idf), avgdl, k1, b)
