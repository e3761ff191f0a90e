"""Serving warm-up: issue the batch driver's group shapes once, before the
first live query.

The port of ``searcharray_tpu/utils/warm.py``.  PyTorch compiles nothing
ahead of time, but a fresh process still pays on its first queries: the
kernel library is built or loaded, CUDA loads each kernel's module at its
first launch, the caching allocator grows to the pools' and the groups'
working sizes, and the pinned staging buffers of the host copies are
allocated.  ``warm_serving`` synthesizes a workload that reaches every
group shape the batch driver forms for this corpus -- term-bucket x
candidate-bucket classes, phrase lengths, source mixes, slop windows, the
top-k packing -- and runs it once, so the first live query finds all of
that done.  On a sharded array (``mesh=``) it warms through the sharded
path, one plan per batch.

Shape classes are enumerated from host metadata (posting lengths and
docfreqs), not sampled: one representative term per expand-bucket class
that exists in the vocabulary.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from searcharray_tpu_torch.ops.kernels import expand_bucket_of


def _shape_reps(dev) -> dict:
    """One representative term id per posting-bucket class (candidate
    buffers share the same bucket, candidates.kc_bucket)."""
    lengths = np.asarray(dev.postings.lengths)
    reps: dict = {}
    for tid in range(len(lengths)):
        n = int(lengths[tid])
        if n == 0:
            continue
        key = expand_bucket_of(n)
        if key not in reps:
            reps[key] = tid
    return reps


def warm_serving(arr, phrase_lens: Sequence[int] = (2, 3, 4, 5),
                 top_k: int = 10, slops: Sequence[int] = (0, 2),
                 batch_sizes: Sequence[int] = (1, 8, 120)) -> int:
    """Warm the serving path of ``arr`` (a SearchArray).

    Returns the number of warm queries issued.  Safe to call on a live
    index; results are discarded (the pools keep what the queries made
    resident, as live queries would).  Covers:

    * one term query per (posting-bucket, candidate-bucket) class;
    * phrases of each length mixing the hottest terms (pool sources at
      scale) with each class representative (mini sources), in both
      positions;
    * the same shapes at each requested ``slop`` (the window kernels);
    * each requested batch size and the ranked top-k.
    """
    dev = arr.dev
    vocab = dev.vocab
    dfs = np.asarray(dev.doc_freqs)
    if not len(dfs) or dev.avg_doc_length == 0:
        return 0
    reps = _shape_reps(dev)
    hot_tids = list(np.argsort(dfs)[::-1][:4])
    hot = [vocab.get_term(int(t)) for t in hot_tids if dfs[int(t)] > 0]
    if not hot:
        return 0

    queries: list = []
    rep_terms = [vocab.get_term(int(t)) for t in reps.values()]
    queries += rep_terms
    queries += hot[:2]
    for L in phrase_lens:
        base = (hot * L)[:L]
        queries.append(base)  # all-hot phrase (pool planes / dphrase)
        for r in rep_terms:
            queries.append([r] + base[: L - 1])   # rep leads (rows source)
            queries.append(base[: L - 1] + [r])   # rep trails
    seen: set = set()
    uniq: list = []
    for q in queries:
        kq = q if isinstance(q, str) else tuple(q)
        if kq not in seen:
            seen.add(kq)
            uniq.append(q)

    n = 0
    for slop in slops:
        for bs in batch_sizes:
            for c0 in range(0, len(uniq), bs):
                chunk = uniq[c0: c0 + bs]
                if slop > 0:
                    chunk = [q for q in chunk if not isinstance(q, str)]
                    if not chunk:
                        continue
                arr.score_batch(chunk, top_k=top_k, slop=slop)
                n += len(chunk)
    # mixed-slop batches put exact and slop groups in one wave (per-query
    # slop, search/batch.py): warm that composition too
    pos_slops = [s for s in slops if s > 0]
    if pos_slops:
        phrases = [q for q in uniq if not isinstance(q, str)]
        for bs in batch_sizes:
            mixed = (uniq + phrases)[: max(bs, len(uniq) + len(phrases))]
            mixed_slops = [0] * len(uniq) + [pos_slops[0]] * len(phrases)
            for c0 in range(0, len(mixed), bs):
                chunk = mixed[c0: c0 + bs]
                chunk_slops = mixed_slops[c0: c0 + bs]
                arr.score_batch(chunk, top_k=top_k, slop=chunk_slops)
                n += len(chunk)
    # each ranked call above copied its result to the host, so all of its
    # device work has run
    return n
