"""Candidate-subset scoring: work proportional to a query's rarest term,
not to the corpus.

A phrase can match only documents that hold its rarest term, and a term
query only its own documents: the score everywhere else is zero.  So a
selective query on a large corpus derives its **candidate rows** from one
posting slice (its doc keys, run-compacted into a row table of ``Kc`` =
the slice's coarse bucket, known on the host: K8a,
``ops/cuda/score.py:cand_rows``), builds each term's **mini-plane**, its
payload slots at those rows only (K8b, ``cand_minis``: a copy from the
term's pooled plane for a stopword-sized term, the term's own posting
slice aligned to the rows for any other), and runs the ordinary chain
(K5) or slop window (K6) on the minis with ``num_docs = Kc``.  The finish
maps the ``[Qg, Kc]`` freqs back to doc ids: the similarity at the rows,
then K3 over the ``Kc`` axis, pad slots ranked below every candidate and
mapped to a zero-score doc (``finish_candidates``), or the scores
scattered into ``[Qg, N]``.

The port of ``searcharray_tpu/search/candidates.py``: its eligibility
rules and constants, and its per-query bodies as batched kernels.  Its
compile-bounding ladder (``_QP_LADDER``, ``class_qp``, ``qp_pad``) and the
doc -> candidate map alignment (``use_imap``, ``ALIGN_IMAP_FRAC``,
``IMAP_BYTES_CAP``) have no counterpart: PyTorch compiles nothing, and
K8b's lower bound in the row table gives the same minis as both of the
JAX package's alignments.

Known tie-region difference from the full-corpus groups (as in the JAX
package): a query that matches fewer than k docs fills its top-k tail
with one zero-score doc next to its candidates, where the full-corpus
groups fill it with the smallest-index zero-score docs.  The port's
thresholds are higher than the JAX package's (see below), so on a corpus
between the two the JAX package takes a rare query to the engine and the
port to the full-corpus groups: the scores agree and that tail differs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kernels_cuda

# Candidate scoring turns on only for large corpora and selective queries
# (a candidate buffer of at most corpus / CAND_MAX_FRAC rows); single terms
# from CAND_TERM_MIN_DOCS docs, phrases from CAND_MIN_DOCS.  The JAX
# package turns them on at 2^16 and 2^19 docs.  On an H100 the engine
# saves device time and adds host time (a candidate group launches about
# twice the kernels of the dense group it replaces), and the full-corpus
# work it saves grows with the corpus: timed in turns
# (scripts/cand_crossover.py, PERF.md section 6), rare terms on it lost at
# 1M docs and won from 2^21, rare phrases on it too lost at 2^21 and won
# from 2^22 (the serving mix and the mixed request with slop; at 8.8M docs
# 4.1x and 2.7x the qps).  Tests force the engine on small corpora by
# patching these.
CAND_MIN_DOCS = 1 << 22
CAND_TERM_MIN_DOCS = 1 << 21
CAND_MAX_FRAC = 8
MINI_MAX_WORDS = 1 << 18   # a term of more (bucketed) words is a pool source
# a query with a pool-source term stays a candidate only up to this Kc
CAND_POOL_MAX_KC = 1 << 16
# elements of one chunk's mini-planes (the JAX package's per-program cap)
CHUNK_MINI_ELEMS = 1 << 25


def kc_bucket(dev: DeviceIndex, tid: int) -> int:
    """The candidate row buffer of a rows-source term: its coarse posting
    bucket, at least its docfreq, so the compaction always fits."""
    return K.expand_bucket_of(max(1, dev.term_span(tid)[1]))


def rows_source(dev: DeviceIndex, tids: Sequence[int]) -> int:
    """The term whose docs become the candidate rows: the first term with
    the smallest candidate buffer (any query term's docs are sound)."""
    return min(tids, key=lambda t: kc_bucket(dev, t))


def term_source(dev: DeviceIndex, n_words: int):
    """A term's mini-plane source: "pool" for a stopword-sized term (its
    pooled plane is gathered), else its coarse posting bucket."""
    b = K.expand_bucket_of(max(1, n_words))
    return "pool" if b > MINI_MAX_WORDS else b


def query_sources(dev: DeviceIndex, lens: Sequence[int]) -> tuple:
    """Per-term sources of one candidate query, every mini-source term at
    the query's largest mini bucket (the group key's srcs)."""
    raw = [term_source(dev, n) for n in lens]
    mini_max = max((s for s in raw if s != "pool"), default=0)
    return tuple("pool" if s == "pool" else mini_max for s in raw)


# The switch reads the corpus's doc count (``stats_docs``) and the buffer
# bound the largest shard's (``corpus_size``: a PlanView's is its largest
# shard's; one index's is the corpus's), as the JAX sharded module does.
def eligible_term(dev: DeviceIndex, tid: int, top_k: Optional[int]) -> bool:
    if dev.stats_docs < CAND_TERM_MIN_DOCS:
        return False
    kc = kc_bucket(dev, tid)
    if top_k is not None and top_k > kc:
        return False
    return kc * CAND_MAX_FRAC <= dev.corpus_size


def eligible_terms(dev: DeviceIndex, n_words: np.ndarray,
                   top_k: Optional[int]) -> np.ndarray:
    """``eligible_term`` of many terms at once, from their routing posting
    words (``term_span(t)[1]``): bool [Q]."""
    if dev.stats_docs < CAND_TERM_MIN_DOCS:
        return np.zeros(len(n_words), bool)
    kc = K.expand_buckets_of(np.maximum(n_words, 1))
    ok = kc * CAND_MAX_FRAC <= dev.corpus_size
    return ok if top_k is None else ok & (top_k <= kc)


def eligible_phrase(dev: DeviceIndex, tids: Sequence[int],
                    top_k: Optional[int]) -> bool:
    from searcharray_tpu_torch.search import dense

    if dev.stats_docs < CAND_MIN_DOCS:
        return False
    rarest = rows_source(dev, tids)
    kc = kc_bucket(dev, rarest)
    if top_k is not None and top_k > kc:
        return False
    if kc * CAND_MAX_FRAC > dev.corpus_size:
        return False
    # pool-source terms need pooled planes (and the pool must hold them);
    # mini-source terms need nothing
    if not dense.dense_eligible(dev):
        return all(term_source(dev, dev.term_span(t)[1]) != "pool"
                   for t in set(tids))
    pool_terms = {t for t in tids
                  if term_source(dev, dev.term_span(t)[1]) == "pool"}
    if pool_terms and kc > CAND_POOL_MAX_KC:
        return False
    return len(pool_terms) <= dense.plane_capacity(dev) - 1


def chunk_rows(dev: DeviceIndex, Kc: int, T: int = 1) -> int:
    """Queries of a candidate chunk: its minis (or, for terms, the same
    count of candidate slots) stay within CHUNK_MINI_ELEMS."""
    return max(1, CHUNK_MINI_ELEMS // max(1, T * (Kc << dev.blk_bits)))


def finish_candidates(freqs: torch.Tensor, rows: torch.Tensor, doc_lens,
                      idfs, avgdl, kind: str, k1: float, b: float,
                      top_k: Optional[int], N: int) -> torch.Tensor:
    """[Qg, Kc] freqs at the candidate rows (int32 [Qg, Kc], sentinel N)
    -> the packed top-k int32 [Qg, 2k] (f32 score bits ‖ doc ids), or the
    f32 [Qg, N] scores with ``top_k`` None.  ``idfs`` is f32 [Qg] on the
    device.  The top-k is K3 over the Kc axis, pad slots at -1 below
    every candidate and mapped to ``fallback``, a doc next to the
    candidates that none of them is, so the tail holds zero-score docs.
    Nothing here is read by the host."""
    from searcharray_tpu_torch.search.dense import pack_topk

    Qg, Kc = freqs.shape
    valid = rows < N
    rows_clip = rows.clamp(0, N - 1).long()
    dl = doc_lens.index_select(0, rows_clip.reshape(-1)).reshape(Qg, Kc)
    scores = K.apply_similarity_device(kind, freqs, dl, idfs[:, None],
                                       avgdl, k1, b, out=freqs)
    scores = torch.where(valid, scores, 0.0)
    if top_k is None:
        offs = torch.arange(Qg, device=rows.device)[:, None] * N
        flat = torch.where(valid, rows_clip + offs, Qg * N).reshape(-1)
        out = torch.zeros(Qg * N + 1, dtype=torch.float32,
                          device=rows.device)
        return out.index_add_(0, flat, scores.reshape(-1))[:-1].reshape(Qg, N)
    cand_max = torch.where(valid, rows, -1).max(dim=1).values
    fallback = torch.where(cand_max < N - 1, cand_max + 1,
                           (rows[:, 0] - 1).clamp(min=0))
    rows_m = torch.where(valid, rows, fallback[:, None])
    packed = pack_topk(torch.where(valid, scores, -1.0), top_k)
    v = packed[:, :top_k].view(torch.float32).clamp(min=0.0)
    real = torch.gather(rows_m, 1, packed[:, top_k:].long())
    return torch.cat([v.view(torch.int32), real], dim=1)


def candidate_freqs(dev: DeviceIndex, gkey: tuple, offs, ns,
                    slots) -> tuple:
    """(freqs f32 [Qg, Kc], rows int32 [Qg, Kc]) of one chunk of a
    ``cphrase`` or ``cspan`` group: one K8a launch compacts each query's
    rows-source slice, one K8b launch builds every mini (pooled planes
    for pool-source terms, which the caller made resident, own slices for
    the rest), then one K5 (exact) or K6 (slop) launch on the minis.
    ``offs`` / ``ns`` are the host int [Qg, T] posting slices of the
    chunk's terms on ``dev``, ``slots`` the host int [Qg, T] plane slots
    of its pool-source terms (-1 for the others)."""
    if gkey[0] == "cphrase":
        _, T, plan_key, pattern, srcs, Kc, _rb, rows_i = gkey
    else:
        _, T, _ai, w, mults, srcs, Kc, _rb, rows_i = gkey
    rows, _ = kernels_cuda.cand_rows(
        dev.hdrs, dev.pays, offs[:, rows_i], ns[:, rows_i], Kc,
        num_docs=dev.corpus_size, blk_bits=dev.blk_bits, with_tf=False)
    minis = kernels_cuda.cand_minis(
        rows, slots, offs, ns, pool=dev.plane_pool, hdrs=dev.hdrs,
        pays=dev.pays, num_docs=dev.corpus_size, blk_bits=dev.blk_bits)
    Qg = offs.shape[0]
    mslots = np.arange(Qg * T).reshape(Qg, T)
    if gkey[0] == "cphrase":
        freqs = kernels_cuda.phrase_chain(minis, mslots, plan_key, pattern,
                                          num_docs=Kc, blk_bits=dev.blk_bits)
    else:
        freqs = kernels_cuda.span_window(minis, mslots, w, mults, anchor=0,
                                         num_docs=Kc, blk_bits=dev.blk_bits)
    return freqs, rows
