"""Exact phrases: the chain plan and the sparse chain on posting slices.

A phrase's freq in a doc is the minimum, over the steps of a chain of
bigram matches, of the step's per-doc count (the reference's
``compute_phrase_freqs``, `searcharray/phrase/middle_out.py:154-168`).
On a dense-eligible corpus the batch driver runs every step on the term
planes of the plane pool (search/dense.py, kernel K5).  Windowed phrases
(``phrase_freqs_dense``), corpora or phrases the plane pool cannot take,
and phrases of more than ``CHAIN_MAX_TERMS`` terms take the sparse chain
on the doc-sorted posting slices: each step index is one K7 launch
(``ops/cuda/score.py:merge_step``) over every chain of a call, whose (doc
key, count) pairs K2 sums per doc.  The JAX package runs that step as a
sort of both lists; its compile-reuse machinery (per-step and
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
from searcharray_tpu_torch.search.scoring import _window_blocks, query_idf

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
    (fewest posting words in the corpus, ``stats_lengths``: every shard
    splits a phrase where the whole index would), and each term's first
    index as its same-term tag."""
    lengths = [int(dev.stats_lengths[t]) for t in term_ids]
    plan = _plan(len(term_ids), lengths.index(min(lengths)))
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


def _chain_steps(direction: str, idxs):
    """The (base, other) term columns of a chain half's steps, in order:
    the base is the step's raw term, the other its neighbour towards the
    chain's start (the carry from the second step on)."""
    if direction == "l2r":
        return [(idxs[i], idxs[i - 1]) for i in range(1, len(idxs))]
    return [(idxs[i], idxs[i + 1]) for i in range(len(idxs) - 2, -1, -1)]


def sparse_chains_freqs(hdrs: torch.Tensor, pays: torch.Tensor, chains, *,
                        blk_bits: int, key_stride: int, min_blk=None,
                        max_blk=None) -> List[torch.Tensor]:
    """Exact phrase freqs of several chunks of queries, each chunk sharing
    one chain structure, on their doc-sorted posting slices: one f32
    [Q_c, key_stride] per chunk.

    ``chains`` holds (plan, pattern, offs, ns) per chunk: ``offs``/``ns``
    host int [Q_c, T_c] arrays of each query's term slices in
    ``hdrs``/``pays``, ``plan`` the chain halves and ``pattern`` the
    same-term tags.  Every (chunk, query, half) is a row.  Step j of every
    row that has one is ONE K7 launch (the base is the step's raw term,
    the other the neighbouring raw term or the carry: the previous base's
    headers with the continuation that step wrote; direction and same-term
    per row) and ONE K2 launch over its flat ``row * key_stride + doc``
    keys, so a call launches each kernel as often as its longest half has
    steps.  Rows are taken longest first, so the rows of step j are a
    prefix; a row's freqs are the min over its steps, a query's the min
    over its halves."""
    rows = []   # (steps, chunk, query); in chunk, query, half order
    for c, (plan, pattern, offs, ns) in enumerate(chains):
        offs = np.asarray(offs, dtype=np.int64)
        ns = np.asarray(ns, dtype=np.int64)
        for q in range(offs.shape[0]):
            for direction, idxs in plan:
                rows.append((_chain_steps(direction, idxs), c, q,
                             direction, offs[q], ns[q], pattern))
    order = sorted(range(len(rows)), key=lambda r: -len(rows[r][0]))
    rows = [rows[r] for r in order]
    freqs = None
    carry = None   # (continuation payloads, the previous step's base slices)
    for j in range(len(rows[0][0]) if rows else 0):
        live = [r for r in rows if len(r[0]) > j]
        R = len(live)
        base = [(r[4][r[0][j][0]], r[5][r[0][j][0]]) for r in live]
        base_off = np.asarray([b[0] for b in base], np.int64)
        base_n = np.asarray([b[1] for b in base], np.int64)
        if carry is None:
            other_pays = pays
            other_off = np.asarray([r[4][r[0][0][1]] for r in live])
            other_n = np.asarray([r[5][r[0][0][1]] for r in live])
            other_pay_off = other_off
        else:
            other_pays = carry[0]
            other_off, other_n = carry[1][:R], carry[2][:R]
            other_pay_off = kernels_cuda.prefix_offsets(carry[2])[:R]
        keys, counts, cont = kernels_cuda.merge_step(
            hdrs, pays, other_pays, base_off, base_n, other_off, other_n,
            other_pay_off,
            cont_side=["rhs" if r[3] == "l2r" else "lhs" for r in live],
            same_term=[j == 0 and r[6][r[0][0][0]] == r[6][r[0][0][1]]
                       for r in live],
            blk_bits=blk_bits, key_stride=key_stride, min_blk=min_blk,
            max_blk=max_blk, need_cont=[len(r[0]) > j + 1 for r in live])
        per_doc = kernels_cuda.segment_sum(
            keys, counts, num_docs=R * key_stride).reshape(R, key_stride)
        if freqs is None:
            freqs = per_doc
        else:
            freqs[:R] = torch.minimum(freqs[:R], per_doc)
        carry = (cont, base_off, base_n)
    # each query's rows, by where the sort put them: the min over halves
    where: dict = {}
    for i, r in enumerate(rows):
        where.setdefault((r[1], r[2]), []).append(i)
    out = []
    for c, (_, _, offs, _) in enumerate(chains):
        Q = np.shape(offs)[0]
        first = [where[(c, q)][0] for q in range(Q)]
        second = [where[(c, q)][-1] for q in range(Q)]
        if Q == 0:
            out.append(torch.zeros((0, key_stride), dtype=torch.float32,
                                   device=hdrs.device))
        elif first == second and first == list(range(first[0],
                                                     first[0] + Q)):
            out.append(freqs[first[0]: first[0] + Q])
        else:
            ix = kernels_cuda.host_to_device(
                np.asarray([first, second], np.int64), hdrs.device)
            out.append(torch.minimum(freqs[ix[0]], freqs[ix[1]]))
    return out


def sparse_chain_freqs(hdrs: torch.Tensor, pays: torch.Tensor, offs, ns,
                       plan, pattern, *, blk_bits: int, key_stride: int,
                       min_blk=None, max_blk=None) -> torch.Tensor:
    """Exact phrase freqs of a chunk of queries sharing one chain
    structure: f32 [Q, key_stride] (``sparse_chains_freqs`` of one chunk;
    both halves of a split chain share each step's launches)."""
    return sparse_chains_freqs(hdrs, pays, [(plan, pattern, offs, ns)],
                               blk_bits=blk_bits, key_stride=key_stride,
                               min_blk=min_blk, max_blk=max_blk)[0]


def phrase_freqs_dense(index: DeviceIndex, term_ids: List[int],
                       min_posn: Optional[int] = None,
                       max_posn: Optional[int] = None,
                       kind: str = "none", k1: float = 1.2, b: float = 0.75,
                       idf: Optional[float] = None) -> torch.Tensor:
    """Dense per-doc exact phrase frequencies (kind ``none``) or scores,
    f32[N] on the index's device, by the sparse chain on the posting
    slices, inside the position window when one is given.  Takes no pool
    slot and no lock."""
    if len(term_ids) < 2:
        raise ValueError("Must have at least two terms")
    min_blk, max_blk = _window_blocks(min_posn, max_posn)
    windowed = min_posn is not None or max_posn is not None
    spans = [index.term_span(t) for t in term_ids]
    if min(s[1] for s in spans) == 0:
        return torch.zeros(index.corpus_size, dtype=torch.float32,
                           device=index.device)
    if idf is None:
        idf = query_idf(index, kind, term_ids)
    # the plan splits at the rarest term by the untrimmed lengths; then
    # stopword slices are bounded by the rarest term
    plan_key, pattern = chain_key(index, term_ids)
    spans = trim_spans(index, spans)
    freqs = sparse_chain_freqs(
        index.hdrs, index.pays, [[s[0] for s in spans]],
        [[s[1] for s in spans]], plan_key, pattern, blk_bits=index.blk_bits,
        key_stride=index.corpus_size,
        min_blk=min_blk if windowed else None,
        max_blk=max_blk if windowed else None)[0]
    avgdl = np.float32(max(index.avg_doc_length, 1e-38))
    return apply_similarity_device(kind, freqs, index.doc_lens,
                                   np.float32(idf), avgdl, k1, b, out=freqs)
