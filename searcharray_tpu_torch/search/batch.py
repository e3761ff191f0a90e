"""Batched multi-query scoring of terms, exact phrases and slop phrases:
the serving path.

Queries are deduplicated, classified and grouped:

* ``dterm`` (corpus dense-eligible): the group's tf rows are made
  resident in the tf pool (one K1 launch per missing term; a repeated
  phrase's freq row by K5), then the fused ranking pass reads the rows
  from the pool and ranks their similarity (no gather, no score block;
  K10 over gathered rows where the full scores are asked for);
* ``dphrase`` (exact phrases, corpus dense-eligible): the group's term
  planes are made resident in the plane pool (one K4 launch for all
  missing planes of a wave), then ONE K5 launch computes the phrase
  freqs of every query in the group, then similarity + top-k;
* ``term`` (corpus too large for dense planes): every query's posting
  slice is offset into a flat query-major key space (``q * Npad + doc``)
  and reduced by ONE sorted segment-sum, K2, for the whole group;
* ``phrase`` (exact phrases the dense engine does not take: the corpus
  is too large for dense planes, or the phrase has more terms than K5 or
  the plane pool takes): the sparse chain on the posting slices, the
  chains of every ``phrase`` group of the call stepped together: each
  step index ONE K7 launch for all of them (both halves of a split
  chain), reduced by ONE K2 launch over a flat key space of one row per
  (query, half); then the min over steps and halves;
* ``dspan`` (slop phrases the dense window takes: ``n + slop - 1 <= 18``,
  no term more than twice, planes that fit the pool): ONE K6 launch per
  (distinct terms, window, multiplicities) on the pooled planes;
* ``span`` (every other slop phrase, the JAX package's per-query
  fallbacks): ONE K9 launch per (distinct terms, window, multiplicities)
  on the posting slices, reduced by ONE K2 launch; the rows of all
  ``span`` groups are ranked together by one K3 call;
* ``cterm`` / ``cphrase`` / ``cspan`` (selective queries on a large
  corpus: the candidate-subset engine, search/candidates.py): per chunk
  ONE K8a launch compacts each query's rarest posting slice into its
  candidate rows (a term's tf with them), for a phrase ONE K8b launch
  builds every term's mini-plane at those rows and ONE K5 or K6 launch
  runs on the minis; the finish ranks over the candidate axis (K3).

A batch is planned once, on the host (``plan_batch`` over a ``PlanView``:
the dedup, the groups, their chunks, the pool waves and each wave's pool
slots), and the plan is run on each index that serves it (``run_plan``:
the wave's pool fills from the index's own posting slices, then the
group launches).  One index is the S = 1 case; the S shards of a
``parallel/sharded.py:ShardedIndex`` share one plan and one slot map.

With ``top_k`` every group's result is ranked by K3's selection (the
fused pass over the group's tf or freqs rows where k is at most
``RANK_MAX_K``: ``dense.rank_or_score``) and packed into int32
[Qg, 2k] (f32 score bits ‖ doc indices), so one device-to-host copy
returns a batch and nothing before it waits for the device.  With
``as_device`` the f32[Q, N] scores stay on the device for a caller that
composes further (solr.py); with ``rows`` only a subset of the docs is
scored (edismax's phrase phases).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kernels_cuda
from searcharray_tpu_torch.ops.cuda.score import CHAIN_MAX_TERMS, bump
from searcharray_tpu_torch.search import candidates as C
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.search.phrase import (
    _plan,
    chain_key,
    sparse_chains_freqs,
    trim_spans,
)
from searcharray_tpu_torch.search.scoring import (
    apply_similarity_device,
    idf_table,
    table_idf,
    table_idfs,
)
from searcharray_tpu_torch.search.spans import (
    anchor_of,
    dense_window_ok,
    sparse_span_freqs,
    takes_dense_span,
    unique_terms,
)
from searcharray_tpu_torch.utils import profiling

# Device work items issued since import: tf-pool fills and group launches.
DISPATCHES = dense.DISPATCHES
# Of those, the candidate-engine group launches (cterm, cphrase, cspan).
CAND_GROUPS = [0]

_DOC_BLOCK = 1024  # Npad is a multiple of it (keeps query rows aligned)

# flat keys are int32 and the segment-sum pad sentinel is 2**30, so the
# flat key space (Qchunk * Npad) stays below 2**29 per group launch
_MAX_FLAT = 1 << 29

# max sliced posting words per sparse group launch (term: its bucket per
# query; phrase: the words of all terms of the chunk's queries)
_SPARSE_CHUNK_WORDS = 1 << 26


def _npad(num_docs: int) -> int:
    return -(-max(1, num_docs) // _DOC_BLOCK) * _DOC_BLOCK


def _flat_keys(keys: torch.Tensor, Qg: int, Npad: int) -> torch.Tensor:
    """[Qg, M] sorted per-row doc keys -> flat int32[Qg * M] keys in the
    query-major space ``q * Npad + doc``.  PAD keys clamp to the row's
    last slot (their counts are zero by construction upstream), so the
    flat keys stay non-decreasing across rows."""
    offs = (torch.arange(Qg, dtype=torch.int32, device=keys.device)
            * Npad)[:, None]
    return (torch.clamp(keys, max=Npad - 1) + offs).reshape(-1).contiguous()


def _flat_segment_sum(keys: torch.Tensor, counts: torch.Tensor, Qg: int,
                      Npad: int) -> torch.Tensor:
    """[Qg, M] sorted per-row (keys, counts) -> dense float32[Qg, Npad]."""
    dense_ = kernels_cuda.segment_sum(_flat_keys(keys, Qg, Npad),
                                      counts.reshape(-1).contiguous(),
                                      num_docs=Qg * Npad)
    return dense_.reshape(Qg, Npad)


def _slice_keys(hdrs, pays, offs, ns, bucket: int, blk_bits: int):
    """Per-query posting slices -> (doc keys int32[Qp, bucket], popcounts
    f32[Qp, bucket]); the tail past each slice is PAD with count 0."""
    device = hdrs.device
    offs_t = kernels_cuda.host_to_device(np.asarray(offs, np.int64), device)
    ns_t = kernels_cuda.host_to_device(np.asarray(ns, np.int64), device)
    col = torch.arange(bucket, device=device)
    idx = offs_t[:, None] + col[None, :]
    valid = col[None, :] < ns_t[:, None]
    h = torch.where(valid, hdrs[idx], K.PAD_HDR32)
    p = torch.where(valid, pays[idx], 0)
    return h >> blk_bits, kernels_cuda.popcount_i32(p).to(torch.float32)


def _term_group_fn(dev: DeviceIndex, Qp: int, bucket: int, kind: str,
                   k1: float, b: float, top_k: Optional[int]):
    """The sparse term group: fn(hdrs, pays, doc_lens, avgdl, offs, ns,
    idfs) -> f32[Qp, N] scores, or the packed top-k with ``top_k``."""
    N = dev.corpus_size
    Npad = _npad(N)
    blk_bits = dev.blk_bits

    def f(hdrs, pays, doc_lens, avgdl, offs, ns, idfs):
        device = hdrs.device
        keys, pops = _slice_keys(hdrs, pays, offs, ns, bucket, blk_bits)
        tfs = _flat_segment_sum(keys, pops, Qp, Npad)[:, :N]
        idf_t = kernels_cuda.host_to_device(np.asarray(idfs, np.float32),
                                            device)
        return dense.rank_or_score(kind, k1, b, top_k, tfs, doc_lens, idf_t,
                                   avgdl)

    return f


def _phrase_scores(freqs: torch.Tensor, kind: str, k1: float, b: float,
                   top_k: Optional[int], doc_lens, avgdl, idfs):
    """A sparse phrase group's scores from its f32[Qg, N] freqs, or the
    packed top-k with ``top_k`` (``dense.rank_or_score``)."""
    idf_t = kernels_cuda.host_to_device(np.asarray(idfs, np.float32),
                                        freqs.device)
    return dense.rank_or_score(kind, k1, b, top_k, freqs, doc_lens, idf_t,
                               avgdl)


def _phrase_runs(specs, N: int) -> List[list]:
    """Runs of a plan's sparse phrase specs whose chains step together:
    their rows (query x chain half) fit one K2 key space and their words
    _SPARSE_CHUNK_WORDS (a spec's words: its largest shard's)."""
    Npad = _npad(N)
    runs, cur, rows, words = [], [], 0, 0
    for s in specs:
        r = len(s["chunk"]) * len(s["gkey"][2])
        wd = int(s["ns"].sum(axis=(1, 2)).max())
        if cur and ((rows + r) * Npad > _MAX_FLAT
                    or words + wd > _SPARSE_CHUNK_WORDS):
            runs.append(cur)
            cur, rows, words = [], 0, 0
        cur.append(s)
        rows += r
        words += wd
    if cur:
        runs.append(cur)
    return runs


def _phrase_run_freqs(dev: DeviceIndex, run, shard: int) -> List[torch.Tensor]:
    """The f32[Qg, N] freqs of one run of sparse phrase specs on ``dev``
    (shard ``shard``'s slices), their chains stepped together
    (``sparse_chains_freqs``: one K7 and one K2 launch per step index)."""
    N = dev.corpus_size
    return [f[:, :N] for f in sparse_chains_freqs(
        dev.hdrs, dev.pays,
        [(s["gkey"][2], s["gkey"][3], s["offs"][shard], s["ns"][shard])
         for s in run],
        blk_bits=dev.blk_bits, key_stride=_npad(N))]


def _span_group_fn(dev: DeviceIndex, w: int, mults: tuple, kind: str,
                   k1: float, b: float):
    """The sparse slop group: fn(hdrs, pays, doc_lens, avgdl, offs, ns,
    idfs) -> f32[Qg, N] scores.  ``offs``/``ns`` are host int [Qg, T]
    arrays of the exact posting slices of each query's distinct terms,
    the anchor in column 0."""
    N = dev.corpus_size
    Npad = _npad(N)
    blk_bits = dev.blk_bits

    def f(hdrs, pays, doc_lens, avgdl, offs, ns, idfs):
        freqs = sparse_span_freqs(hdrs, pays, offs, ns, w, mults, anchor=0,
                                  blk_bits=blk_bits, key_stride=Npad)[:, :N]
        idf_t = kernels_cuda.host_to_device(np.asarray(idfs, np.float32),
                                            hdrs.device)
        return apply_similarity_device(kind, freqs, doc_lens[None, :],
                                       idf_t[:, None], avgdl, k1, b)

    return f


def _phrase_chunks(grows, max_rows: int):
    """Cut a sparse phrase group into chunks of at most ``max_rows``
    queries and _SPARSE_CHUNK_WORDS posting words (a query's words: its
    largest shard's; a query larger than that is a chunk of its own)."""
    chunks, cur, words = [], [], 0
    for row in grows:
        w = int(row[2].sum(axis=1).max())
        if cur and (len(cur) >= max_rows
                    or words + w > _SPARSE_CHUNK_WORDS):
            chunks.append(cur)
            cur, words = [], 0
        cur.append(row)
        words += w
    if cur:
        chunks.append(cur)
    return chunks


def _phrase_tf_route(dev: DeviceIndex, sig, tids, fkey, budget) -> bool:
    """Whether this phrase scores from its cached tf-pool freq row (the
    phrase-tf cache, search/dense.py).  Counts the encounter and, at
    PHRASE_TF_MIN_HITS, registers the fill recipe and spends one unit of
    the per-call promotion budget; the wave's ensure_batch then fills the
    row with K5.  Evicted rows re-promote the same way on later hits."""
    maps = dev.maps
    if sig in maps.tf_slot:
        return True
    h = maps.phrase_hits.get(sig, 0) + 1
    maps.phrase_hits[sig] = h
    if h < dense.PHRASE_TF_MIN_HITS or budget[0] <= 0:
        return False
    maps.phrase_recipes[sig] = (list(tids), fkey)
    budget[0] -= 1
    return True


def _ptf_budget(dev: DeviceIndex) -> list:
    """Phrase-tf promotions allowed in one call: at most half the tf pool
    holds phrase rows, so hot terms and a phrase flood cannot thrash."""
    n_sigs = sum(1 for k_ in dev.maps.tf_slot if isinstance(k_, tuple))
    return [max(0, dense.tf_capacity(dev) // 2 - n_sigs)]


def _canon_slop(uniq: List[int], mults: List[int], u_spans: List[tuple],
                anchor_i: int):
    """Anchor-first canonical order of a slop query's distinct terms.

    The window test is symmetric in every term but the anchor (an AND of
    per-term window presence), so the anchor (the counted term,
    ``uniq[anchor_i]``) can always sit at index 0, and a ``dspan`` group
    never varies by where the anchor sat in the query."""
    ai = anchor_i
    order = [ai] + [i for i in range(len(uniq)) if i != ai]
    return ([uniq[i] for i in order], [mults[i] for i in order],
            [u_spans[i] for i in order])


def _slop_structure(dev: DeviceIndex, tids: List[int], slop: int):
    """(distinct terms anchor first, their spans, fill key) of a slop
    phrase the dense window kernel takes."""
    uniq, mults = unique_terms(tids)
    uniq, mults, u_spans = _canon_slop(uniq, mults,
                                       [dev.term_span(t) for t in uniq],
                                       anchor_of(dev, uniq))
    return uniq, u_spans, ("phs", len(uniq), 0, len(tids) + slop - 1,
                           tuple(mults))


def _is_slop_phrase(tids, slop: int) -> bool:
    """A resolved query of two or more terms with slop: a one-term query
    ignores its slop."""
    return (slop > 0 and tids is not None and len(tids) > 1
            and all(t >= 0 for t in tids))


class PlanView:
    """What planning a batch reads, for the S shards that run the plan
    (one DeviceIndex is the S = 1 case): the corpus's statistics, each
    shard's posting slices and the slot maps the shards share.

    * ``stats_docs``, ``doc_freqs``, ``avg_doc_length``: the corpus's
      (every idf; the candidate engine's switch);
    * ``stats_lengths``: the corpus's posting words per term (the phrase
      chain's split, a slop phrase's anchor, a query with an empty term);
    * ``term_span(t)[1]`` and ``local_lengths``: the largest shard's
      posting words of a term (buckets, ``Kc``, chunk sizes);
    * ``corpus_size``, ``pool_share``: the largest shard's doc count and
      the largest share of a device (the slot maps'), so the pools'
      capacities and the candidate buffer bound hold on every shard;
    * ``offsets`` / ``lengths``: int64 [S, V], each shard's slices (a
      plan's tables are their rows);
    * ``maps``: the shards' shared ``SlotMaps``; ``held()`` holds them on
      every shard's device (``SlotMaps.held``)."""

    def __init__(self, members: Sequence[DeviceIndex]):
        self.members = list(members)
        m0 = self.members[0]
        if any(m.maps is not m0.maps for m in self.members):
            raise ValueError("the shards of a plan share one slot map")
        self.maps = m0.maps
        self.blk_bits = m0.blk_bits
        self.doc_freqs = m0.doc_freqs
        self.avg_doc_length = m0.avg_doc_length
        self.stats_docs = m0.stats_docs
        self.stats_lengths = m0.stats_lengths
        self.corpus_size = self.maps.corpus_size
        self.pool_share = self.maps.pool_share
        if len(self.members) == 1:
            self.offsets = m0.postings.offsets[None]
            self.lengths = m0.postings.lengths[None]
            self.local_lengths = m0.postings.lengths
        else:
            self.offsets = np.stack([m.postings.offsets
                                     for m in self.members])
            self.lengths = np.stack([m.postings.lengths
                                     for m in self.members])
            self.local_lengths = self.lengths.max(axis=0)

    def held(self):
        return self.maps.held(dict.fromkeys(m.device for m in self.members))

    def term_span(self, term_id: int):
        """(0, the largest shard's words, their bucket): a term's routing
        span (its slices are the rows of ``offsets`` / ``lengths``)."""
        n = int(self.local_lengths[term_id])
        return 0, n, K.bucket_of(max(1, n))

    def tables(self, tids: Sequence[int]):
        """Host int64 [S, T] offsets and lengths of ``tids`` on every
        shard."""
        return self.offsets[:, tids], self.lengths[:, tids]

    def idf_terms(self, kind: str) -> np.ndarray:
        """float64 [V]: each term's part of a query's idf on the corpus's
        statistics (``scoring.idf_table`` of the first shard, whose
        ``doc_freqs`` and ``stats_docs`` are the corpus's)."""
        return idf_table(self.members[0], kind)


def _as_view(dev) -> PlanView:
    return dev if isinstance(dev, PlanView) else PlanView([dev])


_DENSE_KINDS = ("dterm", "dphrase", "dspan")
_SPARSE_KINDS = ("term", "phrase", "span")
_CAND_KINDS = ("cterm", "cphrase", "cspan")


def _classify(dev, queries_tids: Sequence[Optional[List[int]]],
              kind: str, slop=0, top_k: Optional[int] = None,
              allow_candidates: bool = False):
    """Split queries into structure groups.

    ``dev`` is a DeviceIndex or a ``PlanView`` of shards; every rule
    reads the corpus's statistics and the largest shard's slices, so the
    groups hold for every shard.  Returns a dict mapping a structural key
    to a list of (query_index, offs[S, T], ns[S, T], idf, tids): each
    shard's posting slices of the row's terms (None for the pooled
    ``dterm`` / ``dphrase`` / ``dspan`` groups, which read no slice);
    queries with a missing term, no term or an empty posting are in no
    group and score all-zero.  With the dense
    engine (corpus dense-eligible) term queries use pooled tf rows
    (``dterm``) and exact phrases the chain on pooled planes (``dphrase``,
    keyed by term count, plan and pattern), or, once repeated, their
    cached freq row (a ``dterm`` row keyed by the phrase signature).
    ``slop`` is an int for every query or one per query: a query of two
    or more terms with slop > 0 is a slop phrase, a ``dspan`` group keyed
    by (distinct terms, anchor column 0, window, multiplicities) whose
    rows hold the distinct terms anchor first, or its cached freq row.  A
    slop phrase the dense window kernel cannot take (``w > 18``, a term
    more than twice, a corpus or phrase the plane pool cannot hold) is a
    ``span`` group with the same key fields and rows, scored by K9 on the
    exact posting slices; it never takes a pool slot and is never
    promoted.  Term queries on corpora too large for dense planes are
    ``term``, keyed by posting bucket; phrases there, and phrases of more
    than CHAIN_MAX_TERMS terms (K5's cap) or more unique terms than the
    plane pool takes, are ``phrase`` (the sparse chain, keyed by term
    count, plan and pattern; their rows hold each shard's slices trimmed
    to its rarest term's doc range) and never take a tf-pool slot.

    With ``allow_candidates`` selective queries take the candidate-subset
    engine (search/candidates.py) first, in the JAX package's order: a
    rare term is ``cterm`` (keyed by its bucket, which is its Kc), a rare
    exact phrase ``cphrase`` and a rare slop phrase of the dense window's
    shape ``cspan``, both keyed by their dense key's fields, the term
    sources, Kc and the rows-source column; a phrase that is a candidate
    is never promoted into the phrase-tf cache.  ``top_k`` larger than a
    query's Kc keeps it off the engine, and so (unlike the JAX package,
    whose chain takes any length) does a phrase of more than
    CHAIN_MAX_TERMS terms, which K5 does not take.

    Every idf is read from the per-term table (``PlanView.idf_terms``),
    bit-equal to ``host_idf``'s.  The resolved single-term queries are
    classified together, in one array pass (``_term_rows``); the loop
    takes the rest, one query at a time.  Counts on the innermost open
    span (``utils/profiling.py``) the distinct queries classified
    (``plan_rows``) and those the loop took (``plan_loop_rows``)."""
    view = _as_view(dev)
    dense_ok = dense.dense_eligible(view)
    slops = ([int(slop)] * len(queries_tids) if np.isscalar(slop)
             else [int(s) for s in slop])
    ptf_budget = _ptf_budget(view) if dense_ok else [0]
    corpus_len, local_len = view.stats_lengths, view.local_lengths
    parts = view.idf_terms(kind)
    terms, n_terms = _term_rows(view, queries_tids, kind, parts, top_k,
                                allow_candidates, dense_ok)
    if profiling.active():
        profiling.count("plan_rows", len(queries_tids))
        profiling.count("plan_loop_rows", len(queries_tids) - n_terms)
    groups: dict = {}
    for qi, tids in enumerate(queries_tids):
        got = terms[qi]
        if got is not None:
            groups.setdefault(got[0], []).append(got[1])
            continue
        if tids is None or len(tids) == 0 or any(t < 0 for t in tids):
            continue
        if min(int(corpus_len[t]) for t in tids) == 0:
            continue
        idf = table_idf(kind, parts[tids], view.stats_docs)
        cols = tids   # the terms of the row's slice tables
        if _is_slop_phrase(tids, slops[qi]):
            sig = (tuple(tids), slops[qi])
            row_tids, _, fkey = _slop_structure(view, tids, slops[qi])
            cols = row_tids
            lengths = [int(local_len[t]) for t in row_tids]
            if (allow_candidates
                    and dense_window_ok(len(tids), slops[qi], fkey[4])
                    and C.eligible_phrase(view, row_tids, top_k)):
                # the anchor (fewest words, so the smallest bucket) is the
                # rows source: column 0
                rb = K.expand_bucket_of(lengths[0])
                gkey = (("cspan",) + fkey[1:]
                        + (C.query_sources(view, lengths), rb, rb, 0))
            elif not takes_dense_span(view, tids, slops[qi]):
                gkey = ("span",) + fkey[1:]
            elif _phrase_tf_route(view, sig, row_tids, fkey, ptf_budget):
                gkey, row_tids = ("dterm",), [sig]
            else:
                gkey = ("dspan",) + fkey[1:]
        else:
            sig = (tuple(tids), 0)
            if (allow_candidates and len(tids) <= CHAIN_MAX_TERMS
                    and C.eligible_phrase(view, tids, top_k)):
                # the chain splits at the rows source
                rows_i = tids.index(C.rows_source(view, tids))
                plan_key = tuple((d, tuple(ix))
                                 for d, ix in _plan(len(tids), rows_i))
                pattern = tuple(tids.index(t) for t in tids)
                lengths = [int(local_len[t]) for t in tids]
                rb = K.expand_bucket_of(lengths[rows_i])
                gkey, row_tids = ("cphrase", len(tids), plan_key, pattern,
                                  C.query_sources(view, lengths), rb, rb,
                                  rows_i), tids
            else:
                # the plan splits at the rarest term by the untrimmed
                # lengths
                plan_key, pattern = chain_key(view, tids)
                if not (dense_ok and dense.phrase_fits_pool(view, tids)):
                    gkey, row_tids = ("phrase", len(tids), plan_key,
                                      pattern), tids
                elif _phrase_tf_route(view, sig, tids,
                                      ("ph", len(tids), plan_key, pattern),
                                      ptf_budget):
                    gkey, row_tids = ("dterm",), [sig]
                else:
                    gkey, row_tids = ("dphrase", len(tids), plan_key,
                                      pattern), tids
        offs = ns = None
        if gkey[0] not in _DENSE_KINDS:
            offs, ns = view.tables(cols)
            if gkey[0] == "phrase":
                # each shard's rarest-term pre-slice of its own slices
                for d, m in enumerate(view.members):
                    trimmed = trim_spans(m, list(zip(offs[d], ns[d])))
                    offs[d] = [o for o, _ in trimmed]
                    ns[d] = [n for _, n in trimmed]
        groups.setdefault(gkey, []).append((qi, offs, ns, idf, row_tids))
    return groups


_DTERM = ("dterm",)


def _term_rows(view: PlanView, queries_tids, kind: str, parts: np.ndarray,
               top_k: Optional[int], allow_candidates: bool,
               dense_ok: bool):
    """The resolved single-term queries of a batch, classified in one
    array pass over the per-term tables: (for each query its (group key,
    row) as ``_classify`` files it, or None for a query this pass does not
    take; the number taken).  A term is ``cterm`` where
    ``C.eligible_term`` holds (and its posting is not empty), else
    ``dterm`` where the corpus is dense-eligible, else ``term`` keyed by
    its bucket; the slices of a ``cterm`` or ``term`` row are one gather
    of ``offsets`` / ``lengths``."""
    out: list = [None] * len(queries_tids)
    qis = [qi for qi, tids in enumerate(queries_tids)
           if tids is not None and len(tids) == 1 and tids[0] >= 0]
    tids = np.fromiter((queries_tids[qi][0] for qi in qis), np.int64,
                       len(qis))
    idfs = table_idfs(kind, parts[tids], view.stats_docs).tolist()
    n = view.local_lengths[tids]
    cand = ((n > 0) & C.eligible_terms(view, n, top_k) if allow_candidates
            else np.zeros(len(qis), bool))
    kcs = K.expand_buckets_of(n).tolist()
    bkts = K.buckets_of(np.maximum(n, 1)).tolist()
    offs, ns = view.tables(tids)
    for j, (qi, idf, c) in enumerate(zip(qis, idfs, cand.tolist())):
        if dense_ok and not c:
            out[qi] = (_DTERM, (qi, None, None, idf, queries_tids[qi]))
            continue
        gkey = ("cterm", kcs[j], kcs[j]) if c else ("term", bkts[j])
        out[qi] = (gkey, (qi, offs[:, j:j + 1], ns[:, j:j + 1], idf,
                          queries_tids[qi]))
    return out, len(qis)


def _cand_fields(gkey):
    """(terms, sources, Kc) of a ``cphrase`` or ``cspan`` group key."""
    if gkey[0] == "cphrase":
        return gkey[1], gkey[4], gkey[5]
    return gkey[1], gkey[5], gkey[6]


def dedup_queries(queries_tids: Sequence[Optional[List[int]]], slop):
    """The distinct (query, slop) pairs of a batch: serving batches repeat
    hot queries, and each distinct one is scored once and fanned back out.
    ``slop`` is an int for every query or one per query.  Returns (the
    distinct queries, their slops, each query's index among them)."""
    slops = ([int(slop)] * len(queries_tids) if np.isscalar(slop)
             else [int(s) for s in slop])
    if len(slops) != len(queries_tids):
        raise ValueError("per-query slop length must match queries")
    keymap: dict = {}
    uniq: List[Optional[List[int]]] = []
    uniq_slops: List[int] = []
    expand: List[int] = []
    for tids, sl in zip(queries_tids, slops):
        kq = None if tids is None else (tuple(tids), sl)
        uid = keymap.get(kq)
        if uid is None:
            uid = keymap[kq] = len(uniq)
            uniq.append(tids)
            uniq_slops.append(sl)
        expand.append(uid)
    return uniq, uniq_slops, expand


class BatchPlan:
    """A batch planned once for every shard of a ``PlanView``: the
    distinct queries (``Q``, the fan-out map ``expand``), the pool waves
    (each a ``dense.Fill`` of the rows to fill and its group specs, their
    pool slots assigned), the sparse specs and the runs their chains step
    in, and ``out_qis``, the query of each output row a shard's groups
    give, in launch order.  A spec holds its group key, its rows, its
    idfs and its tables: pool slots (``slots``, the same on every shard)
    or each shard's posting slices (``offs`` / ``ns``, int64 [S, rows]
    or [S, rows, T])."""

    def __init__(self, Q: int, expand: List[int]):
        self.Q = Q
        self.expand = expand
        self.dedup = len(expand) != Q
        self.waves: List[tuple] = []
        self.sparse: List[dict] = []
        self.phrase_runs: List[list] = []
        self.fills: list = []
        self.out_qis: List[int] = []
        self.qis = np.zeros(0, np.int64)     # out_qis, uploaded by assemble
        self.n_specs = 0
        self.n_cand = 0


def _chunk_specs(view: PlanView, groups: dict) -> List[dict]:
    """Chunk every group into rectangular specs, bounded on the largest
    shard."""
    N = view.corpus_size
    Npad = _npad(N)
    NS = dense.plane_size(view)
    cap_p = dense.plane_capacity(view)
    cap_t = dense.tf_capacity(view)
    maps = view.maps
    specs: List[dict] = []
    for gkey, grows in groups.items():
        if gkey[0] in ("dphrase", "dspan"):
            # the JAX package's bound on a phrase or slop group (a broadcast
            # plane gather of ~2 GB there), and the chunk's terms must fit
            # the plane pool beside one free slot
            T = gkey[1]
            max_chunk = max(1, min((1 << 29) // (T * max(1, NS)),
                                   (cap_p - 1) // T))
        elif gkey[0] == "dterm":
            # gathered tf stack is f32[Qg, N]: ~1 GB cap, and the chunk's
            # rows must fit the pool beside one free slot
            max_chunk = max(1, min((1 << 28) // max(1, N), cap_t - 1))
        elif gkey[0] == "cterm":
            max_chunk = C.chunk_rows(view, gkey[2])
        elif gkey[0] in ("cphrase", "cspan"):
            # the chunk's minis, and its pool-source terms beside one free
            # plane slot
            T, srcs, Kc = _cand_fields(gkey)
            n_pool = sum(1 for x in srcs if x == "pool")
            max_chunk = max(1, min(C.chunk_rows(view, Kc, T),
                                   (cap_p - 1) // n_pool if n_pool
                                   else 1 << 30))
        elif gkey[0] == "term":
            # bound by the flat segment-sum key space AND by sliced
            # posting-bucket words
            max_chunk = max(1, min(_MAX_FLAT // Npad,
                                   _SPARSE_CHUNK_WORDS // max(1, gkey[1])))
        elif gkey[0] == "span":
            # the flat key space, and the f32[Qg, Npad] sums at ~1 GB
            max_chunk = max(1, min(_MAX_FLAT, 1 << 28) // Npad)
        else:
            # a split chain's halves take a row each of the key space;
            # words: _phrase_chunks
            max_chunk = max(1, _MAX_FLAT // Npad // 2)
        if gkey[0] == "dterm":
            chunks = _dterm_chunks(maps, grows, max_chunk, cap_p)
        elif gkey[0] in ("phrase", "span"):
            chunks = _phrase_chunks(grows, max_chunk)
        else:
            chunks = [grows[c0: c0 + max_chunk]
                      for c0 in range(0, len(grows), max_chunk)]
        specs += [_spec(gkey, chunk) for chunk in chunks]
    return specs


def _spec(gkey, chunk) -> dict:
    """A group's chunk of rows as a spec: its idfs and its tables."""
    spec = {"gkey": gkey, "chunk": chunk,
            "idfs": np.asarray([r[3] for r in chunk], np.float32)}
    if gkey[0] == "dterm":
        spec["tf_tids"] = [r[4][0] for r in chunk]
        # the rows keyed by a phrase signature: the only ones that can
        # pull planes into a wave (``_recipe_planes``)
        spec["sigs"] = [k for k in spec["tf_tids"] if isinstance(k, tuple)]
    elif gkey[0] in ("dphrase", "dspan"):
        spec["plane_tids"] = [t for r in chunk for t in r[4]]
    elif gkey[0] in ("cphrase", "cspan"):
        # the pool-source terms' planes, pinned through the wave
        T, srcs, _ = _cand_fields(gkey)
        spec["plane_tids"] = [r[4][i] for r in chunk
                              for i in range(T) if srcs[i] == "pool"]
    if gkey[0] in ("phrase", "span", "cphrase", "cspan"):
        spec["offs"] = np.stack([r[1] for r in chunk], axis=1)
        spec["ns"] = np.stack([r[2] for r in chunk], axis=1)
    elif gkey[0] in ("term", "cterm"):
        spec["offs"] = np.stack([r[1][:, 0] for r in chunk], axis=1)
        spec["ns"] = np.stack([r[2][:, 0] for r in chunk], axis=1)
    return spec


def _recipe_planes(maps, key_) -> set:
    """The planes a tf-pool key pulls into its wave's fill: a phrase
    signature's terms while its row is not resident, else none."""
    if isinstance(key_, tuple) and key_ not in maps.tf_slot:
        return set(maps.phrase_recipes[key_][0])
    return set()


def _dterm_chunks(maps, rows, max_rows: int, cap_p: int) -> List[list]:
    """``dterm`` rows cut into chunks of at most ``max_rows``: a row keyed
    by a phrase signature whose tf row is not resident pulls its terms'
    planes into the wave's fill, so each chunk's planes must fit the plane
    pool beside one free slot.  Rows keyed by a term id pull no plane, so
    a group of them alone is cut by count."""
    if not any(isinstance(row[4][0], tuple) for row in rows):
        return [rows[c0: c0 + max_rows]
                for c0 in range(0, len(rows), max_rows)]
    chunks, cur, cur_planes = [], [], set()
    for row in rows:
        p_t = _recipe_planes(maps, row[4][0])
        if cur and (len(cur) >= max_rows
                    or len(cur_planes | p_t) > cap_p - 1):
            chunks.append(cur)
            cur, cur_planes = [], set()
        cur.append(row)
        cur_planes |= p_t
    if cur:
        chunks.append(cur)
    return chunks


def _fitting(maps, s: dict, cap_p: int) -> List[dict]:
    """``s``, or a ``dterm`` spec cut again where an earlier wave's
    reservation evicted phrase rows that were resident when the group was
    chunked."""
    if s["gkey"][0] != "dterm" or not s["sigs"]:
        return [s]
    chunks = _dterm_chunks(maps, s["chunk"], len(s["chunk"]), cap_p)
    return [s] if len(chunks) == 1 else [_spec(s["gkey"], c) for c in chunks]


def _waves(view: PlanView, specs: List[dict]):
    """Partition the pool-reading specs into waves whose unique terms fit
    the pools: a wave's plane and tf rows are pinned through its fill and
    its group launches.  A generator: the caller reserves each wave before
    the next is formed, and a spec's pool needs are read from the maps as
    that reservation left them (it may evict a cached phrase row a later
    spec reads, whose terms' planes that spec's wave then fills)."""
    maps = view.maps
    cap_p = dense.plane_capacity(view)
    cap_t = dense.tf_capacity(view)
    cur: List[dict] = []
    cur_p: set = set()
    cur_t: set = set()
    pending = [s for s in specs if s["gkey"][0] not in _SPARSE_KINDS]
    while pending:
        s = pending.pop(0)
        if not cur:
            parts = _fitting(maps, s, cap_p)
            s, pending = parts[0], parts[1:] + pending
        t_t = set(s.get("tf_tids", ()))
        p_t = set(s.get("plane_tids", ()))
        for key_ in s.get("sigs", ()):
            p_t |= _recipe_planes(maps, key_)
        if cur and (len(cur_p | p_t) > cap_p - 1
                    or len(cur_t | t_t) > cap_t - 1):
            yield cur
            cur, cur_p, cur_t = [], set(), set()
            pending.insert(0, s)   # read again after that reservation
            continue
        cur.append(s)
        cur_p |= p_t
        cur_t |= t_t
    if cur:
        yield cur


@profiling.spanned("batch.plan")
def plan_batch(view: PlanView, queries_tids: Sequence[Optional[List[int]]],
               kind: str = "bm25", top_k: Optional[int] = None, slop=0,
               allow_candidates: bool = True, n_out: int = 1) -> BatchPlan:
    """Plan a batch once for every shard of ``view``, on the host: the
    dedup, ``_classify``, the chunking into specs, the wave partition and
    each wave's pool slots, reserved on the shards' shared slot maps
    (``dense.reserve``; a wave that cannot fit raises with no slot of
    this plan left assigned).  ``n_out`` is the number of output columns
    (no group when 0).  The caller holds ``view`` (``view.held()``) from
    here through the last ``run_plan`` of the plan: another thread's plan
    would otherwise evict the rows reserved here before they are read."""
    uniq, uniq_slops, expand = dedup_queries(queries_tids, slop)
    plan = BatchPlan(len(uniq), expand)
    # queries in no group (and every query of a corpus without tokens, or
    # of an empty row set) keep the all-zero rows
    groups = (_classify(view, uniq, kind, slop=uniq_slops, top_k=top_k,
                        allow_candidates=allow_candidates)
              if view.avg_doc_length and n_out else {})
    specs = _chunk_specs(view, groups)
    n_pooled = 0
    try:
        for wave in _waves(view, specs):
            fill = dense.reserve(
                view.maps, [t for s in wave for t in s.get("plane_tids", ())],
                [t for s in wave for t in s.get("tf_tids", ())])
            plan.fills.append(fill)
            for s in wave:
                _slot_tables(view, s)
                plan.out_qis += [r[0] for r in s["chunk"]]
            plan.waves.append((fill, wave))
            n_pooled += len(wave)
    except BaseException:
        dense.release(view.maps, plan.fills)
        raise
    plan.sparse = [s for s in specs if s["gkey"][0] in _SPARSE_KINDS]
    plan.phrase_runs = _phrase_runs(
        [s for s in plan.sparse if s["gkey"][0] == "phrase"],
        view.corpus_size)
    plan.out_qis += [r[0] for s in plan.sparse if s["gkey"][0] != "span"
                     for r in s["chunk"]]
    plan.out_qis += [r[0] for s in plan.sparse if s["gkey"][0] == "span"
                     for r in s["chunk"]]
    plan.qis = np.asarray(plan.out_qis, np.int64)
    plan.n_specs = n_pooled + len(plan.sparse)
    plan.n_cand = sum(1 for s in specs if s["gkey"][0] in _CAND_KINDS)
    return plan


def _slot_tables(view: PlanView, s: dict) -> None:
    """A pool-reading spec's slots, read once its wave is reserved."""
    gkey = s["gkey"]
    if gkey[0] == "dterm":
        s["slots"] = dense.tf_slots_of(view.maps, s["tf_tids"])
    elif gkey[0] in ("dphrase", "dspan"):
        s["slots"] = dense.plane_slots_of(view.maps, s["plane_tids"]).reshape(
            len(s["chunk"]), gkey[1])
    elif gkey[0] in ("cphrase", "cspan"):
        T, srcs, _ = _cand_fields(gkey)
        Qg = len(s["chunk"])
        slots = np.full((Qg, T), -1, np.int64)
        pool_is = [i for i in range(T) if srcs[i] == "pool"]
        if pool_is:
            slots[:, pool_is] = dense.plane_slots_of(
                view.maps, s["plane_tids"]).reshape(Qg, len(pool_is))
        s["slots"] = slots


def _upload(device, uploads: Optional[dict], arr: np.ndarray):
    """A plan's host table on ``device``: one pinned copy per device when
    the shards on it share ``uploads``."""
    if uploads is None:
        return kernels_cuda.host_to_device(arr, device)
    key = (id(arr), device)
    t = uploads.get(key)
    if t is None:
        t = uploads[key] = kernels_cuda.host_to_device(arr, device)
    return t


@profiling.spanned("batch.enqueue")
def run_plan(dev: DeviceIndex, plan: BatchPlan, kind: str = "bm25",
             k1: float = 1.2, b: float = 0.75, top_k: Optional[int] = None,
             rows=None, shard: int = 0, uploads: Optional[dict] = None,
             launch: bool = True) -> List[torch.Tensor]:
    """Run a plan on one shard ``dev`` (row ``shard`` of the plan's
    tables): each wave's pool fills from its own slices, then the wave's
    group launches; then the sparse groups.  Returns the groups' outputs
    in the order of ``plan.out_qis``: f32 [Qg, n] scores, or with
    ``top_k`` packed int32 [Qg, 2k].  With ``rows`` (an int32 device
    tensor of the shard's doc ids) the scores are those docs'.  With
    ``launch`` False only the fills run (a shard with no output column
    keeps its pools in step with the others')."""
    avgdl = np.float32(max(dev.avg_doc_length, 1e-38))
    N = dev.corpus_size
    outs: List[torch.Tensor] = []
    for fill, wave in plan.waves:
        dense.fill_rows(dev, fill)
        if not launch:
            continue
        for s in wave:
            idfs = _upload(dev.device, uploads, s["idfs"])
            bump(DISPATCHES)
            gkey = s["gkey"]
            if gkey[0] == "dterm":
                slots = _upload(dev.device, uploads, s["slots"])
                outs.append(dense.term_group_body(kind, k1, b, top_k,
                                                  dev.tf_pool, slots,
                                                  dev.doc_lens, idfs, avgdl,
                                                  rows=rows))
            elif gkey[0] == "cterm":
                bump(CAND_GROUPS)
                crows, tf = kernels_cuda.cand_rows(
                    dev.hdrs, dev.pays, s["offs"][shard], s["ns"][shard],
                    gkey[2], num_docs=N, blk_bits=dev.blk_bits)
                outs.append(C.finish_candidates(tf, crows, dev.doc_lens,
                                                idfs, avgdl, kind, k1, b,
                                                top_k, N))
                if top_k is not None:
                    dense.count_ranked(len(s["chunk"]), fused=False)
            elif gkey[0] in ("cphrase", "cspan"):
                bump(CAND_GROUPS)
                freqs, crows = C.candidate_freqs(
                    dev, gkey, s["offs"][shard], s["ns"][shard], s["slots"])
                outs.append(C.finish_candidates(freqs, crows, dev.doc_lens,
                                                idfs, avgdl, kind, k1, b,
                                                top_k, N))
                if top_k is not None:
                    dense.count_ranked(len(s["chunk"]), fused=False)
            elif gkey[0] == "dspan":
                _, _, anchor_i, w, mults = gkey
                outs.append(dense.span_group_body(
                    dev, anchor_i, w, mults, kind, k1, b, top_k, s["slots"],
                    idfs, avgdl, rows=rows))
            else:
                _, _, plan_key, pattern = gkey
                outs.append(dense.phrase_group_body(
                    dev, plan_key, pattern, kind, k1, b, top_k, s["slots"],
                    idfs, avgdl, rows=rows))
    if not launch:
        return outs

    def at_rows(out):
        """A sparse group's full-corpus scores at the requested rows."""
        return out if rows is None else out.index_select(1, rows)

    # every sparse phrase group's chain first, stepped together
    phrase_freqs = {}
    for run in plan.phrase_runs:
        phrase_freqs.update(zip(map(id, run),
                                _phrase_run_freqs(dev, run, shard)))
    span_outs: List[torch.Tensor] = []   # ranked together, after the rest
    for s in plan.sparse:
        gkey = s["gkey"]
        offs, ns = s["offs"][shard], s["ns"][shard]
        bump(DISPATCHES)
        if gkey[0] == "phrase":
            outs.append(at_rows(_phrase_scores(
                phrase_freqs.pop(id(s)), kind, k1, b, top_k, dev.doc_lens,
                avgdl, s["idfs"])))
        elif gkey[0] == "span":
            fn = _span_group_fn(dev, gkey[3], gkey[4], kind, k1, b)
            span_outs.append(at_rows(fn(dev.hdrs, dev.pays, dev.doc_lens,
                                        avgdl, offs, ns, s["idfs"])))
        else:
            fn = _term_group_fn(dev, len(s["chunk"]), gkey[1], kind, k1, b,
                                top_k)
            outs.append(at_rows(fn(dev.hdrs, dev.pays, dev.doc_lens, avgdl,
                                   offs, ns, s["idfs"])))
    if span_outs:
        # one K3 call ranks the rows of every span group (cut only where
        # the stack would pass ~1 GB)
        stack = torch.cat(span_outs)
        del span_outs
        if top_k is None:
            outs.append(stack)
        else:
            dense.count_ranked(stack.shape[0], fused=False)
            step = max(1, (1 << 28) // max(1, N))
            outs += [dense.pack_topk(stack[r0: r0 + step], top_k)
                     for r0 in range(0, stack.shape[0], step)]
        del stack
    return outs


@profiling.spanned("batch.assemble")
def assemble(dev: DeviceIndex, plan: BatchPlan, outs: List[torch.Tensor],
             n_out: int, top_k: Optional[int] = None, defer: bool = False,
             as_device: bool = False, uploads: Optional[dict] = None):
    """One shard's outputs of ``run_plan`` placed by query and fanned back
    out to the batch's queries: f32[Q, n_out] on the device with
    ``as_device``; else numpy, or with ``top_k`` (scores f32[Q, k],
    indices int64[Q, k]), or with ``defer`` a zero-arg ``collect()``
    whose packed result is being copied into pinned host memory."""
    Q, out_qis = plan.Q, plan.out_qis
    if as_device:
        if len(outs) == 1 and out_qis == list(range(Q)):
            out = outs[0]   # one group, in query order: nothing to place
        elif not outs:
            out = torch.zeros((Q, n_out), dtype=torch.float32,
                              device=dev.device)
        else:
            # each group's rows copied once, straight to its queries' rows;
            # only the rows of queries in no group are zeroed
            out = torch.empty((Q, n_out), dtype=torch.float32,
                              device=dev.device)
            qis = _upload(dev.device, uploads, plan.qis)
            r0 = 0
            for o in outs:
                out.index_copy_(0, qis[r0: r0 + o.shape[0]], o)
                r0 += o.shape[0]
            if len(out_qis) < Q:
                unplaced = np.setdiff1d(np.arange(Q), plan.qis)
                out.index_fill_(0, kernels_cuda.host_to_device(
                    unplaced, dev.device), 0.0)
        if plan.dedup:  # fan duplicate queries back out
            out = out[kernels_cuda.host_to_device(
                np.asarray(plan.expand, np.int64), dev.device)]
        return out

    if top_k is not None:
        staged, event = None, None
        if outs:
            staged = torch.cat(outs)
            if staged.device.type == "cuda":
                # start the device-to-host copy now; collect() waits on it
                packed_dev = staged
                staged = torch.empty(packed_dev.shape, dtype=packed_dev.dtype,
                                     pin_memory=True)
                staged.copy_(packed_dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(packed_dev.device))
        del outs

        def collect():
            scores = np.zeros((Q, top_k), np.float32)
            idx = np.tile(np.arange(top_k, dtype=np.int64), (Q, 1))
            if staged is not None:
                if event is not None:
                    with profiling.span("batch.wait"):
                        event.synchronize()
                packed = staged.numpy()
                scores[out_qis] = packed[:, :top_k].view(np.float32)
                idx[out_qis] = packed[:, top_k:]
            if plan.dedup:  # fan duplicate queries back out
                return scores[plan.expand], idx[plan.expand]
            return scores, idx

        return collect if defer else collect()

    out_np = np.zeros((Q, n_out), np.float32)
    if outs:
        stack = torch.cat(outs)
        with profiling.span("batch.wait"):
            out_np[out_qis] = stack.cpu().numpy()
    if plan.dedup:  # fan duplicate queries back out
        out_np = out_np[plan.expand]
    return out_np


def score_batch_fused(dev: DeviceIndex,
                      queries_tids: Sequence[Optional[List[int]]],
                      kind: str = "bm25", k1: float = 1.2, b: float = 0.75,
                      top_k: Optional[int] = None, defer: bool = False,
                      slop=0, as_device: bool = False,
                      rows: Optional[np.ndarray] = None):
    """Score a batch of resolved term-id queries, one launch per group:
    ``plan_batch`` on the index, ``run_plan`` on it, ``assemble``.  Safe
    from many threads: the index is held (``DeviceIndex.held``) from the
    plan to the last launch of the run, and released before anything
    waits for the device.

    ``queries_tids[i]`` is the list of term ids for query i (`-1` entries
    mark vocabulary misses, making the query score zero), or None; a list
    of two or more ids is a phrase.  ``slop`` is an int for the whole
    batch or one per query: 0 is an exact phrase, more a slop phrase
    (mixed batches share one wave: one pool fill, then the groups).
    Selective queries on a large corpus take the candidate-subset engine
    (``cterm``, ``cphrase``, ``cspan``: K8a, K8b, then K5 or K6 on the
    minis and the finish over the candidate axis).

    Returns float32[Q, num_docs] (numpy), or with ``top_k``: (scores
    float32[Q, k], indices int64[Q, k]).  With ``defer`` (requires
    ``top_k``) returns a zero-arg ``collect()`` instead: all device work
    is enqueued and the packed result is being copied into pinned host
    memory; collect() waits for that copy's event and unpacks.  With
    ``as_device`` (exclusive with ``top_k``) the f32[Q, num_docs] scores
    stay a tensor on the index's device and nothing is copied.  With
    ``rows`` (doc ids; exclusive with ``top_k``) the scores are those
    docs' only, [Q, len(rows)], and the candidate engine is off, as in the
    JAX package: term groups gather their tf rows at the rows, phrase and
    slop groups run K5 or K6 on their planes' minis there (K8b), the
    sparse groups gather their columns.
    """
    if defer and top_k is None:
        raise ValueError("defer requires top_k")
    if as_device and top_k is not None:
        raise ValueError("as_device and top_k are exclusive")
    if rows is not None and top_k is not None:
        raise ValueError("rows and top_k are exclusive")
    N = dev.corpus_size
    rows_t = None
    if rows is not None:
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim != 1 or (rows.size and (rows.min() < 0
                                             or rows.max() >= N)):
            raise ValueError(f"rows must be doc ids in [0, {N})")
        rows_t = kernels_cuda.host_to_device(rows.astype(np.int32),
                                             dev.device)
    n_out = N if rows is None else len(rows)
    # held from the plan's reservations to the last launch that reads
    # them; assemble reads only the groups' own outputs, and its copy to
    # the host is waited for outside
    with dev.held():
        plan = plan_batch(PlanView([dev]), queries_tids, kind, top_k=top_k,
                          slop=slop, allow_candidates=rows is None,
                          n_out=n_out)
        try:
            outs = run_plan(dev, plan, kind, k1, b, top_k=top_k, rows=rows_t)
        except BaseException:
            dense.release(dev.maps, plan.fills)
            raise
    return assemble(dev, plan, outs, n_out, top_k=top_k, defer=defer,
                    as_device=as_device)
