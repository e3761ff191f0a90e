"""Batched multi-query scoring of terms, exact phrases and slop phrases:
the serving path.

Queries are deduplicated, classified and grouped:

* ``dterm`` (corpus dense-eligible): the group's tf rows are made
  resident in the tf pool (one K1 launch per missing term; a repeated
  phrase's freq row by K5), then one row gather + elementwise similarity
  + exact top-k scores the group;
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

With ``top_k`` every group's result is ranked by K3 and packed into int32
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
from searcharray_tpu_torch.ops.cuda.score import CHAIN_MAX_TERMS
from searcharray_tpu_torch.search import candidates as C
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.search.phrase import (
    _plan,
    chain_key,
    sparse_chain_freqs,
    sparse_chains_freqs,
    trim_spans,
)
from searcharray_tpu_torch.search.scoring import (
    apply_similarity_device,
    host_idf,
)
from searcharray_tpu_torch.search.spans import (
    anchor_of,
    dense_window_ok,
    sparse_span_freqs,
    takes_dense_span,
    unique_terms,
)

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
        out = apply_similarity_device(kind, tfs, doc_lens[None, :],
                                      idf_t[:, None], avgdl, k1, b)
        if top_k is None:
            return out
        return dense.pack_topk(out, top_k)

    return f


def _phrase_scores(freqs: torch.Tensor, kind: str, k1: float, b: float,
                   top_k: Optional[int], doc_lens, avgdl, idfs):
    """A sparse phrase group's scores from its f32[Qg, N] freqs, or the
    packed top-k with ``top_k``."""
    idf_t = kernels_cuda.host_to_device(np.asarray(idfs, np.float32),
                                        freqs.device)
    out = apply_similarity_device(kind, freqs, doc_lens[None, :],
                                  idf_t[:, None], avgdl, k1, b)
    if top_k is None:
        return out
    return dense.pack_topk(out, top_k)


def _phrase_group_fn(dev: DeviceIndex, plan_key: tuple, pattern: tuple,
                     kind: str, k1: float, b: float, top_k: Optional[int]):
    """The sparse phrase group alone: fn(hdrs, pays, doc_lens, avgdl,
    offs, ns, idfs) -> f32[Qg, N] scores, or the packed top-k with
    ``top_k``.  ``offs``/``ns`` are host int [Qg, T] arrays of exact
    posting slices (no bucket padding: K7 takes each query's own
    lengths)."""
    N = dev.corpus_size
    Npad = _npad(N)
    blk_bits = dev.blk_bits

    def f(hdrs, pays, doc_lens, avgdl, offs, ns, idfs):
        freqs = sparse_chain_freqs(hdrs, pays, offs, ns, plan_key, pattern,
                                   blk_bits=blk_bits, key_stride=Npad)[:, :N]
        return _phrase_scores(freqs, kind, k1, b, top_k, doc_lens, avgdl,
                              idfs)

    return f


def _phrase_specs_freqs(dev: DeviceIndex, specs) -> List[torch.Tensor]:
    """The f32[Qg, N] freqs of every sparse phrase spec of a call, their
    chains stepped together (``sparse_chains_freqs``: one K7 and one K2
    launch per step index), in runs of specs whose rows (query x chain
    half) fit one K2 key space and whose words _SPARSE_CHUNK_WORDS."""
    N = dev.corpus_size
    Npad = _npad(N)
    runs, cur, rows, words = [], [], 0, 0
    for s in specs:
        r = len(s["chunk"]) * len(s["gkey"][2])
        wd = int(s["ns"].sum())
        if cur and ((rows + r) * Npad > _MAX_FLAT
                    or words + wd > _SPARSE_CHUNK_WORDS):
            runs.append(cur)
            cur, rows, words = [], 0, 0
        cur.append(s)
        rows += r
        words += wd
    if cur:
        runs.append(cur)
    out = []
    for run in runs:
        out += [f[:, :N] for f in sparse_chains_freqs(
            dev.hdrs, dev.pays,
            [(s["gkey"][2], s["gkey"][3], s["offs"], s["ns"]) for s in run],
            blk_bits=dev.blk_bits, key_stride=Npad)]
    return out


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
    queries and _SPARSE_CHUNK_WORDS posting words (a query larger than
    that is a chunk of its own)."""
    chunks, cur, words = [], [], 0
    for row in grows:
        w = int(row[2].sum())
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
    if sig in dev.tf_slot:
        return True
    h = dev.phrase_hits.get(sig, 0) + 1
    dev.phrase_hits[sig] = h
    if h < dense.PHRASE_TF_MIN_HITS or budget[0] <= 0:
        return False
    dev.phrase_recipes[sig] = (list(tids), fkey)
    budget[0] -= 1
    return True


def _ptf_budget(dev: DeviceIndex) -> list:
    """Phrase-tf promotions allowed in one call: at most half the tf pool
    holds phrase rows, so hot terms and a phrase flood cannot thrash."""
    n_sigs = sum(1 for k_ in dev.tf_slot if isinstance(k_, tuple))
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


def score_phrase_cached_single(dev: DeviceIndex, tids: List[int], slop: int,
                               kind: str, k1: float, b: float, idf):
    """Single-query fast path of an exact or slop phrase through the
    phrase-tf cache, or None.

    Mirrors _classify's dphrase and dspan structures.  A hit or a
    promotion scores as one tf-row gather + similarity, the dterm group
    at one row."""
    if not dense.dense_eligible(dev) or len(tids) < 2:
        return None
    if min(dev.term_span(t)[1] for t in tids) == 0:
        return None
    if slop > 0:
        if not takes_dense_span(dev, tids, slop):
            return None
        rec, _, fkey = _slop_structure(dev, tids, slop)
    else:
        if not dense.phrase_fits_pool(dev, tids):
            return None
        plan_key, pattern = chain_key(dev, tids)
        rec, fkey = tids, ("ph", len(tids), plan_key, pattern)
    sig = (tuple(tids), slop)
    if not _phrase_tf_route(dev, sig, rec, fkey, _ptf_budget(dev)):
        return None
    dense.ensure_batch(dev, tf_tids=[sig])
    slots = kernels_cuda.host_to_device(dense.tf_slots_of(dev, [sig]),
                                        dev.device)
    idfs = kernels_cuda.host_to_device(np.asarray([idf], np.float32),
                                       dev.device)
    avgdl = np.float32(max(dev.avg_doc_length, 1e-38))
    return dense.term_group_body(kind, k1, b, None, dev.tf_pool, slots,
                                 dev.doc_lens, idfs, avgdl)[0]


def _is_slop_phrase(tids, slop: int) -> bool:
    """A resolved query of two or more terms with slop: a one-term query
    ignores its slop."""
    return (slop > 0 and tids is not None and len(tids) > 1
            and all(t >= 0 for t in tids))


def _classify(dev: DeviceIndex, queries_tids: Sequence[Optional[List[int]]],
              kind: str, slop=0, top_k: Optional[int] = None,
              allow_candidates: bool = False):
    """Split queries into structure groups.

    Returns a dict mapping a structural key to a list of (query_index,
    offs[T], ns[T], idf, tids); queries with a missing term, no term or
    an empty posting are in no group and score all-zero.  With the dense
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
    count, plan and pattern; their rows hold the slices trimmed to the
    rarest term's doc range) and never take a tf-pool slot.

    With ``allow_candidates`` selective queries take the candidate-subset
    engine (search/candidates.py) first, in the JAX package's order: a
    rare term is ``cterm`` (keyed by its bucket, which is its Kc), a rare
    exact phrase ``cphrase`` and a rare slop phrase of the dense window's
    shape ``cspan``, both keyed by their dense key's fields, the term
    sources, Kc and the rows-source column; a phrase that is a candidate
    is never promoted into the phrase-tf cache.  ``top_k`` larger than a
    query's Kc keeps it off the engine, and so (unlike the JAX package,
    whose chain takes any length) does a phrase of more than
    CHAIN_MAX_TERMS terms, which K5 does not take."""
    dense_ok = dense.dense_eligible(dev)
    slops = ([int(slop)] * len(queries_tids) if np.isscalar(slop)
             else [int(s) for s in slop])
    ptf_budget = _ptf_budget(dev) if dense_ok else [0]
    groups: dict = {}
    for qi, tids in enumerate(queries_tids):
        if tids is None or len(tids) == 0 or any(t < 0 for t in tids):
            continue
        dfs = [int(dev.doc_freqs[t]) for t in tids]
        idf = host_idf(kind, dfs, dev.stats_docs, dev.avg_doc_length)
        spans = [dev.term_span(t) for t in tids]
        lengths = [s[1] for s in spans]
        if _is_slop_phrase(tids, slops[qi]):
            if min(lengths) == 0:
                continue
            sig = (tuple(tids), slops[qi])
            row_tids, spans, fkey = _slop_structure(dev, tids, slops[qi])
            lengths = [s[1] for s in spans]
            if (allow_candidates
                    and dense_window_ok(len(tids), slops[qi], fkey[4])
                    and C.eligible_phrase(dev, row_tids, top_k)):
                # the anchor (fewest words, so the smallest bucket) is the
                # rows source: column 0
                rb = K.expand_bucket_of(lengths[0])
                gkey = (("cspan",) + fkey[1:]
                        + (C.query_sources(dev, lengths), rb, rb, 0))
            elif not takes_dense_span(dev, tids, slops[qi]):
                gkey = ("span",) + fkey[1:]
            elif _phrase_tf_route(dev, sig, row_tids, fkey, ptf_budget):
                gkey, row_tids = ("dterm",), [sig]
            else:
                gkey = ("dspan",) + fkey[1:]
        elif len(tids) == 1:
            if (allow_candidates and lengths[0] > 0
                    and C.eligible_term(dev, tids[0], top_k)):
                bkt = K.expand_bucket_of(lengths[0])
                gkey = ("cterm", bkt, bkt)
            elif dense_ok:
                gkey = ("dterm",)
            else:
                gkey = ("term", K.bucket_of(max(1, lengths[0])))
            row_tids = tids
        else:
            if min(lengths) == 0:
                continue
            sig = (tuple(tids), 0)
            if (allow_candidates and len(tids) <= CHAIN_MAX_TERMS
                    and C.eligible_phrase(dev, tids, top_k)):
                # the chain splits at the rows source
                rows_i = tids.index(C.rows_source(dev, tids))
                plan_key = tuple((d, tuple(ix))
                                 for d, ix in _plan(len(tids), rows_i))
                pattern = tuple(tids.index(t) for t in tids)
                rb = K.expand_bucket_of(lengths[rows_i])
                gkey, row_tids = ("cphrase", len(tids), plan_key, pattern,
                                  C.query_sources(dev, lengths), rb, rb,
                                  rows_i), tids
            else:
                # the plan splits at the rarest term by the untrimmed
                # lengths
                plan_key, pattern = chain_key(dev, tids)
                if not (dense_ok and dense.phrase_fits_pool(dev, tids)):
                    spans = trim_spans(dev, spans)  # rarest-term pre-slice
                    lengths = [s[1] for s in spans]
                    gkey, row_tids = ("phrase", len(tids), plan_key,
                                      pattern), tids
                elif _phrase_tf_route(dev, sig, tids,
                                      ("ph", len(tids), plan_key, pattern),
                                      ptf_budget):
                    gkey, row_tids = ("dterm",), [sig]
                else:
                    gkey, row_tids = ("dphrase", len(tids), plan_key,
                                      pattern), tids
        groups.setdefault(gkey, []).append(
            (qi, np.asarray([s[0] for s in spans], np.int64),
             np.asarray(lengths, np.int64), idf, row_tids))
    return groups


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


def score_batch_fused(dev: DeviceIndex,
                      queries_tids: Sequence[Optional[List[int]]],
                      kind: str = "bm25", k1: float = 1.2, b: float = 0.75,
                      top_k: Optional[int] = None, defer: bool = False,
                      slop=0, as_device: bool = False,
                      rows: Optional[np.ndarray] = None):
    """Score a batch of resolved term-id queries, one launch per group.

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
    uniq, uniq_slops, expand = dedup_queries(queries_tids, slop)
    dedup = len(uniq) != len(queries_tids)

    Q = len(uniq)
    N = dev.corpus_size
    avgdl = np.float32(max(dev.avg_doc_length, 1e-38))
    rows_t = None
    if rows is not None:
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim != 1 or (rows.size and (rows.min() < 0
                                             or rows.max() >= N)):
            raise ValueError(f"rows must be doc ids in [0, {N})")
        rows_t = kernels_cuda.host_to_device(rows.astype(np.int32),
                                             dev.device)
    n_out = N if rows is None else len(rows)
    # queries in no group (and every query of a corpus without tokens, or
    # of an empty row set) keep the all-zero rows
    groups = (_classify(dev, uniq, kind, slop=uniq_slops, top_k=top_k,
                        allow_candidates=rows is None)
              if dev.avg_doc_length and n_out else {})

    Npad = _npad(N)
    NS = dense.plane_size(dev)
    cap_p = dense.plane_capacity(dev)
    cap_t = dense.tf_capacity(dev)

    # chunk every group into rectangular specs
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
            max_chunk = C.chunk_rows(dev, gkey[2])
        elif gkey[0] in ("cphrase", "cspan"):
            # the chunk's minis, and its pool-source terms beside one free
            # plane slot
            T, srcs, Kc = _cand_fields(gkey)
            n_pool = sum(1 for x in srcs if x == "pool")
            max_chunk = max(1, min(C.chunk_rows(dev, Kc, T),
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
            # a row keyed by a phrase signature whose tf row is not yet
            # filled pulls its terms' planes into the wave's fill: cut
            # chunks so each one's distinct recipe planes fit beside one
            # free slot (a wave cannot split a spec)
            chunks, cur_rows, cur_planes = [], [], set()
            for row in grows:
                key_ = row[4][0]
                p_t = (set(dev.phrase_recipes[key_][0])
                       if isinstance(key_, tuple)
                       and key_ not in dev.tf_slot else set())
                if cur_rows and (len(cur_rows) >= max_chunk
                                 or len(cur_planes | p_t) > cap_p - 1):
                    chunks.append(cur_rows)
                    cur_rows, cur_planes = [], set()
                cur_rows.append(row)
                cur_planes |= p_t
            if cur_rows:
                chunks.append(cur_rows)
        elif gkey[0] in ("phrase", "span"):
            chunks = _phrase_chunks(grows, max_chunk)
        else:
            chunks = [grows[c0: c0 + max_chunk]
                      for c0 in range(0, len(grows), max_chunk)]
        for chunk in chunks:
            spec = {"gkey": gkey, "chunk": chunk,
                    "idfs": np.asarray([r[3] for r in chunk], np.float32)}
            if gkey[0] == "dterm":
                spec["tf_tids"] = [r[4][0] for r in chunk]
            elif gkey[0] in ("dphrase", "dspan"):
                spec["plane_tids"] = [t for r in chunk for t in r[4]]
            elif gkey[0] in ("cphrase", "cspan"):
                # the pool-source terms' planes, pinned through the wave
                T, srcs, _ = _cand_fields(gkey)
                spec["plane_tids"] = [r[4][i] for r in chunk
                                      for i in range(T) if srcs[i] == "pool"]
            elif gkey[0] in ("phrase", "span"):
                spec["offs"] = np.stack([r[1] for r in chunk])
                spec["ns"] = np.stack([r[2] for r in chunk])
            else:  # term, cterm
                spec["offs"] = np.asarray([r[1][0] for r in chunk], np.int64)
                spec["ns"] = np.asarray([r[2][0] for r in chunk], np.int64)
            specs.append(spec)

    # partition the pool-reading specs into waves whose unique terms fit
    # the pools: a wave's plane and tf rows are pinned through its fill and
    # its group launches
    waves: List[List[dict]] = []
    cur: List[dict] = []
    cur_p: set = set()
    cur_t: set = set()
    for s in specs:
        if s["gkey"][0] in ("term", "phrase", "span"):
            continue
        p_t = set(s.get("plane_tids", ()))
        t_t = set(s.get("tf_tids", ()))
        # a phrase signature whose row is not yet filled pulls its terms'
        # planes into the wave's fill: count them against the plane pool
        for key_ in t_t:
            if isinstance(key_, tuple) and key_ not in dev.tf_slot:
                p_t |= set(dev.phrase_recipes[key_][0])
        if cur and (len(cur_p | p_t) > cap_p - 1
                    or len(cur_t | t_t) > cap_t - 1):
            waves.append(cur)
            cur, cur_p, cur_t = [], set(), set()
        cur.append(s)
        cur_p |= p_t
        cur_t |= t_t
    if cur:
        waves.append(cur)

    out_qis: List[int] = []       # query index of each output row
    outs: List[torch.Tensor] = []
    for wave in waves:
        plane_tids = [t for s in wave for t in s.get("plane_tids", ())]
        tf_tids = [t for s in wave for t in s.get("tf_tids", ())]
        dense.ensure_batch(dev, plane_tids=plane_tids, tf_tids=tf_tids)
        for s in wave:
            idfs = kernels_cuda.host_to_device(s["idfs"], dev.device)
            DISPATCHES[0] += 1
            gkey = s["gkey"]
            if gkey[0] == "dterm":
                slots = kernels_cuda.host_to_device(
                    dense.tf_slots_of(dev, s["tf_tids"]), dev.device)
                outs.append(dense.term_group_body(kind, k1, b, top_k,
                                                  dev.tf_pool, slots,
                                                  dev.doc_lens, idfs, avgdl,
                                                  rows=rows_t))
            elif gkey[0] == "cterm":
                CAND_GROUPS[0] += 1
                crows, tf = kernels_cuda.cand_rows(
                    dev.hdrs, dev.pays, s["offs"], s["ns"], gkey[2],
                    num_docs=N, blk_bits=dev.blk_bits)
                outs.append(C.finish_candidates(tf, crows, dev.doc_lens,
                                                idfs, avgdl, kind, k1, b,
                                                top_k, N))
            elif gkey[0] in ("cphrase", "cspan"):
                CAND_GROUPS[0] += 1
                freqs, crows = C.candidate_freqs(dev, gkey, s["chunk"])
                outs.append(C.finish_candidates(freqs, crows, dev.doc_lens,
                                                idfs, avgdl, kind, k1, b,
                                                top_k, N))
            else:
                slots = dense.plane_slots_of(dev, s["plane_tids"]).reshape(
                    len(s["chunk"]), gkey[1])
                if gkey[0] == "dspan":
                    _, _, anchor_i, w, mults = gkey
                    outs.append(dense.span_group_body(
                        dev, anchor_i, w, mults, kind, k1, b, top_k, slots,
                        idfs, avgdl, rows=rows_t))
                else:
                    _, _, plan_key, pattern = gkey
                    outs.append(dense.phrase_group_body(
                        dev, plan_key, pattern, kind, k1, b, top_k, slots,
                        idfs, avgdl, rows=rows_t))
            out_qis += [r[0] for r in s["chunk"]]

    def at_rows(out):
        """A sparse group's full-corpus scores at the requested rows."""
        return out if rows_t is None else out.index_select(1, rows_t)

    # every sparse phrase group's chain first, stepped together
    phrase_specs = [s for s in specs if s["gkey"][0] == "phrase"]
    phrase_freqs = dict(zip(map(id, phrase_specs),
                            _phrase_specs_freqs(dev, phrase_specs)))
    span_outs: List[torch.Tensor] = []   # ranked together, after the rest
    span_qis: List[int] = []
    for s in specs:
        gkey = s["gkey"]
        if gkey[0] not in ("term", "phrase", "span"):
            continue
        DISPATCHES[0] += 1
        if gkey[0] == "phrase":
            outs.append(at_rows(_phrase_scores(
                phrase_freqs.pop(id(s)), kind, k1, b, top_k, dev.doc_lens,
                avgdl, s["idfs"])))
            out_qis += [r[0] for r in s["chunk"]]
            continue
        if gkey[0] == "span":
            fn = _span_group_fn(dev, gkey[3], gkey[4], kind, k1, b)
            span_outs.append(at_rows(fn(dev.hdrs, dev.pays, dev.doc_lens,
                                        avgdl, s["offs"], s["ns"],
                                        s["idfs"])))
            span_qis += [r[0] for r in s["chunk"]]
            continue
        fn = _term_group_fn(dev, len(s["chunk"]), gkey[1], kind, k1, b,
                            top_k)
        outs.append(at_rows(fn(dev.hdrs, dev.pays, dev.doc_lens, avgdl,
                               s["offs"], s["ns"], s["idfs"])))
        out_qis += [r[0] for r in s["chunk"]]
    if span_outs:
        # one K3 call ranks the rows of every span group (cut only where
        # the stack would pass ~1 GB)
        stack = torch.cat(span_outs)
        del span_outs
        if top_k is None:
            outs.append(stack)
        else:
            step = max(1, (1 << 28) // max(1, N))
            outs += [dense.pack_topk(stack[r0: r0 + step], top_k)
                     for r0 in range(0, stack.shape[0], step)]
        del stack
        out_qis += span_qis

    if as_device:
        if len(outs) == 1 and out_qis == list(range(Q)):
            out = outs[0]   # one group, in query order: nothing to place
        else:
            out = torch.zeros((Q, n_out), dtype=torch.float32,
                              device=dev.device)
            if outs:
                out[kernels_cuda.host_to_device(
                    np.asarray(out_qis, np.int64), dev.device)] = torch.cat(
                        outs)
        if dedup:  # fan duplicate queries back out
            out = out[kernels_cuda.host_to_device(
                np.asarray(expand, np.int64), dev.device)]
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
                    event.synchronize()
                packed = staged.numpy()
                scores[out_qis] = packed[:, :top_k].view(np.float32)
                idx[out_qis] = packed[:, top_k:]
            if dedup:  # fan duplicate queries back out
                return scores[expand], idx[expand]
            return scores, idx

        return collect if defer else collect()

    out_np = np.zeros((Q, n_out), np.float32)
    if outs:
        out_np[out_qis] = torch.cat(outs).cpu().numpy()
    if dedup:  # fan duplicate queries back out
        out_np = out_np[expand]
    return out_np
