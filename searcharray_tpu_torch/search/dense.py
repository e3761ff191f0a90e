"""Dense tf pool: term tf vectors resident on the device.

A term's per-doc tf vector f32[N] is immutable for an index, so hot terms
keep theirs in ONE device tensor, the **tf pool** ``f32[Ct, N]`` (term ->
slot map on the host, LRU eviction).  A term query then scores as a row
read + elementwise similarity (+ top-k), and a whole serving batch's
missing rows are filled by one K1 launch each (kind ``none``), written
straight into their pool rows.

This is the term subset of the JAX package's dense engine; the plane
pool, the phrase chain and the phrase-tf cache come with the phrase
slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kernels_cuda

TF_POOL_BYTES = 768 << 20    # device budget for the tf pool
DENSE_TERM_BYTES_LIMIT = 1 << 29  # per-plane ceiling; beyond -> ineligible
TF_POOL_MAX_SLOTS = 4096

# Device work items issued since import: tf-pool fills here, group
# launches in search/batch.py (which shares this list).
DISPATCHES = [0]


def plane_size(dev: DeviceIndex) -> int:
    return dev.corpus_size << dev.blk_bits


def dense_eligible(dev: DeviceIndex) -> bool:
    return 0 < plane_size(dev) * 4 <= DENSE_TERM_BYTES_LIMIT


def tf_capacity(dev: DeviceIndex) -> int:
    per = max(1, dev.corpus_size * 4)
    return int(min(TF_POOL_MAX_SLOTS, max(16, TF_POOL_BYTES // per)))


def _init_tf_pool(dev: DeviceIndex) -> None:
    if dev.tf_pool is None:
        Ct = tf_capacity(dev)
        dev.tf_pool = torch.zeros((Ct, dev.corpus_size), dtype=torch.float32,
                                  device=dev.device)
        dev.tf_free = list(range(Ct - 1, -1, -1))


def _alloc_slots(slot_map, free: list, pin: set, tids: Sequence[int]):
    """Assign pool slots to the missing ``tids`` (LRU eviction, never
    evicting ``pin``); returns the list of (tid, slot) newly assigned.

    Raises before touching the map when the request cannot fit, so a
    failed call never leaves slots assigned to rows that were not
    filled."""
    missing = [t for t in dict.fromkeys(tids) if t not in slot_map]
    evictable = sum(1 for old in slot_map if old not in pin)
    if len(missing) > len(free) + evictable:
        raise RuntimeError(
            "dense pool exhausted by pinned terms; shrink the batch")
    new = []
    for t in dict.fromkeys(tids):
        if t in slot_map:
            slot_map.move_to_end(t)
            continue
        if free:
            s = free.pop()
        else:
            s = next(old for old in slot_map if old not in pin)
            s = slot_map.pop(s)
        slot_map[t] = s
        new.append((t, s))
    return new


def ensure_tfs(dev: DeviceIndex, tids: Sequence[int]) -> None:
    """Make every term's tf vector pool-resident, evicting none of
    ``tids``: one K1 launch (kind ``none``) per missing term, written
    into its pool row.  Launches are stream-ordered, so a row is filled
    before any later read of it and read before any later launch refills
    its slot."""
    if any(isinstance(t, tuple) for t in tids):
        # the JAX package's guard against a sub-fill outside the fill
        # program's structure: a request the port cannot serve raises
        raise NotImplementedError(
            "phrase-tf rows come with the phrase slice (ROADMAP Queue 1 "
            "item 7)")
    if not tids:
        return
    _init_tf_pool(dev)
    new = _alloc_slots(dev.tf_slot, dev.tf_free, set(tids), tids)
    for tid, slot in new:
        DISPATCHES[0] += 1
        _term_tf_k1(dev, tid, out=dev.tf_pool[slot])


def _term_tf_k1(dev: DeviceIndex, term_id: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One term's f32[N] tf vector from one K1 launch (kind ``none``)."""
    off, n, _ = dev.term_span(term_id)
    h, p = K.take_term_planes(dev.hdrs, dev.pays, off, n, bucket=n,
                              blk_bits=dev.blk_bits)
    return kernels_cuda.score_term(h, p, dev.doc_lens, 0.0, 1.0,
                                   num_docs=dev.corpus_size,
                                   blk_bits=dev.blk_bits, kind="none",
                                   out=out)


def tf_slots_of(dev: DeviceIndex, tids: Sequence[int]) -> np.ndarray:
    return np.asarray([dev.tf_slot[t] for t in tids], np.int64)


def pack_topk(dense: torch.Tensor, k: int) -> torch.Tensor:
    """[..., N] -> int32 [..., 2k]: f32 score bits ‖ int32 doc indices, one
    packed tensor so a whole batch crosses to the host in one copy."""
    scores, idx = K.topk_exact(dense, k)
    return torch.cat([scores.view(torch.int32), idx.to(torch.int32)],
                     dim=-1)


def term_tf(dev: DeviceIndex, term_id: int) -> torch.Tensor:
    """Dense f32[N] term-frequency vector (a tf-pool row view).

    The analog of the reference's ``termfreq_cache``
    (`searcharray/phrase/middle_out.py:322-328`)."""
    if dense_eligible(dev):
        ensure_tfs(dev, [term_id])
        return dev.tf_pool[dev.tf_slot[term_id]]
    cache = dev.tf_cache  # dict fallback for pool-ineligible corpora
    arr = cache.get(term_id)
    if arr is None:
        arr = _term_tf_k1(dev, term_id)
        per = dev.corpus_size * 4
        budget = max(per, TF_POOL_BYTES)
        while cache and (len(cache) + 1) * per > budget:
            cache.popitem(last=False)
        cache[term_id] = arr
    else:
        cache.move_to_end(term_id)
    return arr


def term_group_body(kind: str, k1: float, b: float, top_k: Optional[int],
                    tfpool, slots, doc_lens, idfs, avgdl):
    """One term group: gather tf rows + similarity (+ packed top-k)."""
    tfstack = tfpool.index_select(0, slots)
    out = K.apply_similarity_device(kind, tfstack, doc_lens[None, :],
                                    idfs[:, None], avgdl, k1, b)
    if top_k is None:
        return out
    return pack_topk(out, top_k)
