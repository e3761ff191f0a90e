"""Dense engine: term tf vectors and term payload planes resident on the
device, and exact-phrase and slop-phrase scoring over the planes.

A term's per-doc tf vector f32[N] is immutable for an index, so hot terms
keep theirs in ONE device tensor, the **tf pool** ``f32[Ct, N]``; a term
query then scores as a row read + elementwise similarity (+ top-k).  A
term's payload plane (its 18-bit position bitmaps at the flat address
``hdr32 = doc << blk_bits | block``) lives in the **plane pool**
``int32[C, N << blk_bits]``, where every phrase-chain operation is
positionally aligned:

* inner bigram matches:   ``L & (R >> 1)``                (same slot)
* cross-block adjacency:  ``(L[s-1] >> 17) & (R[s] & 1)`` (slot shift)
* continuations:          in-place payload updates        (same slot)
* phrase freqs:           per-doc slot sums, min over the chain's steps

The chain itself is K5 (``ops/cuda/score.py:phrase_chain``); its plain
version is ``ops/kernels.py:phrase_counts_dense_planes``, re-exported here.
A slop phrase (window ``w = n + slop - 1`` of at most 18 positions, no
term more than twice) is K6 (``span_window``) on the same planes: window
starts that hold every term often enough, dilated back over the anchor
term's positions.  Every ranked result is K3's selection: a group's top
k of at most ``RANK_MAX_K`` over whole rows by the fused pass
(``rank_or_score``: the scores computed as the selection reads the tf or
freqs rows, never stored), any other by K10 then K3 (``pack_topk``).
Both pools keep key -> slot maps on the host (LRU eviction; ``SlotMaps``,
shared by the shards of one query part of a ``ShardedIndex``, so a key
has one row on all of them).  A batch's missing rows are reserved on the
maps (``reserve``, host only) and filled on each index from its own
slices (``fill_rows``): one K4 launch (all plane rows), one multi-row K1
launch (all term tf rows) and one K5 or K6 launch per phrase-row recipe,
all written straight into their pool rows.  A repeated phrase's freq row is
cached in the tf pool like a term's (the phrase-tf cache): it then scores
as one row gather.  Launches are stream-ordered, so a row is filled
before any later read of it and read before any later launch refills its
slot.

Queries may come from many threads.  A thread holds the maps
(``SlotMaps.held``, ``DeviceIndex.held``) from its reservation to the
last launch that reads its rows, so no other thread's plan evicts a row
in between; the maps' event carries the stream order from one holder to
the next when threads launch on streams of their own.  No result of a
call is a view of a pool row: the next holder may refill it.

The port of the JAX package's dense engine (``searcharray_tpu/search/
dense.py``) for exact and slop phrases on full planes, and over a doc-id
subset (``rows``): the planes' minis at those docs, built by K8b.  Its
compile-bounding fill programs (``_FILL_CHUNK``, the canonical fill key)
and the TPU-only MXU slot sum have no counterpart here: PyTorch runs
eagerly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex, SlotMaps
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kernels_cuda
from searcharray_tpu_torch.ops.cuda.score import CHAIN_MAX_TERMS, bump
from searcharray_tpu_torch.ops.kernels import (  # noqa: F401 (plain K5)
    phrase_counts_dense_planes,
)
from searcharray_tpu_torch.utils import profiling

PLANE_POOL_BYTES = 3 << 30   # device budget for the plane pool
TF_POOL_BYTES = 768 << 20    # device budget for the tf pool
DENSE_TERM_BYTES_LIMIT = 1 << 29  # per-plane ceiling; beyond -> ineligible
PLANE_POOL_MAX_SLOTS = 1024
TF_POOL_MAX_SLOTS = 4096

# A phrase's tf-pool row is filled once it has been seen this many times
# (the batch classifier counts encounters per (tids, slop) signature).
PHRASE_TF_MIN_HITS = 2

# Device work items issued since import: pool fills here, group launches
# in search/batch.py (which shares this list).
DISPATCHES = [0]


def plane_size(dev: DeviceIndex) -> int:
    return dev.corpus_size << dev.blk_bits


def dense_eligible(dev: DeviceIndex) -> bool:
    return 0 < plane_size(dev) * 4 <= DENSE_TERM_BYTES_LIMIT


# A pool's capacity reads the ``corpus_size``, ``blk_bits`` and
# ``pool_share`` of what it sizes: a DeviceIndex, the SlotMaps of the
# indexes that share one pool row per key, or a plan's view of them (all
# three carry the largest member's).  Shards that share a device
# (``pool_share``) divide each budget between them, so the card holds
# what one index would.
def plane_capacity(dev: DeviceIndex) -> int:
    per = max(1, plane_size(dev) * 4)
    budget = PLANE_POOL_BYTES // dev.pool_share
    return int(min(PLANE_POOL_MAX_SLOTS, max(8, budget // per)))


def tf_capacity(dev: DeviceIndex) -> int:
    per = max(1, dev.corpus_size * 4)
    budget = TF_POOL_BYTES // dev.pool_share
    return int(min(TF_POOL_MAX_SLOTS, max(16, budget // per)))


def phrase_fits_pool(dev: DeviceIndex, tids: Sequence[int]) -> bool:
    """Whether the dense engine takes a phrase: at most CHAIN_MAX_TERMS
    terms (K5's cap), whose unique terms fit the plane pool with a slot to
    spare."""
    return (len(tids) <= CHAIN_MAX_TERMS
            and len(set(tids)) <= plane_capacity(dev) - 1)


# Pools start lazily per kind: a term-only workload does not pay the
# multi-GB plane pool, nor a phrase-only one the tf pool.  A pool starts
# on its slot maps when a reservation first needs it (its capacity and a
# free list of every slot), and each index sharing the maps allocates its
# tensor at that capacity at its first fill, so the shards of one slot map
# keep equal pools.
def _start(maps: SlotMaps, kind: str) -> None:
    """Start ``kind``'s pool ("plane" or "tf") on ``maps`` unless it has
    started."""
    if getattr(maps, kind + "_cap") == 0:
        cap = plane_capacity(maps) if kind == "plane" else tf_capacity(maps)
        setattr(maps, kind + "_cap", cap)
        setattr(maps, kind + "_free", list(range(cap - 1, -1, -1)))


def _pool_tensor(dev: DeviceIndex, kind: str) -> torch.Tensor:
    """``dev``'s ``kind`` pool, allocated (zeros) at its maps' capacity on
    first use, under the maps' lock (one tensor however many threads
    ask)."""
    with dev.maps.lock:
        pool = getattr(dev, kind + "_pool")
        if pool is None:
            cap = getattr(dev.maps, kind + "_cap")
            if kind == "plane":
                pool = torch.zeros((cap, plane_size(dev)), dtype=torch.int32,
                                   device=dev.device)
            else:
                pool = torch.zeros((cap, dev.corpus_size),
                                   dtype=torch.float32, device=dev.device)
            setattr(dev, kind + "_pool", pool)
        return pool


def _check_fits(slot_map, free: list, pin: set, tids: Sequence) -> None:
    missing = [t for t in dict.fromkeys(tids) if t not in slot_map]
    evictable = sum(1 for old in slot_map if old not in pin)
    if len(missing) > len(free) + evictable:
        raise RuntimeError(
            "dense pool exhausted by pinned terms; shrink the batch")


def _alloc_slots(slot_map, free: list, pin: set, tids: Sequence):
    """Assign pool slots to the missing ``tids`` (LRU eviction, never
    evicting ``pin``); returns the list of (tid, slot) newly assigned.

    Raises before touching the map when the request cannot fit."""
    _check_fits(slot_map, free, pin, tids)
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


class Fill:
    """The rows one reservation assigned, for every index that shares the
    slot maps to fill from its own posting slices: ``planes`` and
    ``terms`` are (term, slot) pairs, ``recipes`` maps a phrase row's fill
    key to its (plane slots int32[T], tf slot) rows; ``planes`` and
    ``new_t`` are every key newly mapped (``release`` undoes them)."""

    __slots__ = ("planes", "terms", "recipes", "new_t")

    def __init__(self, planes, terms, recipes, new_t):
        self.planes, self.terms, self.recipes = planes, terms, recipes
        self.new_t = new_t


def reserve(maps: SlotMaps, plane_tids: Sequence[int] = (),
            tf_tids: Sequence = ()) -> Fill:
    """Assign pool slots, on ``maps``, to every requested term plane and
    tf row that is not resident, evicting none of the requested rows;
    host only.

    ``tf_tids`` entries may be phrase signatures ((tids, slop) tuples)
    promoted into the phrase-tf cache (``phrase_recipes`` holds each
    one's terms and chain structure): a missing one pulls its terms'
    planes into the same reservation, to be filled by K5 (an exact
    phrase) or K6 (a slop phrase) from them.  Both pools are checked
    before either assigns a slot, so a request that cannot fit raises
    with the maps untouched.

    Counts on the innermost open span (``utils/profiling.py``): the
    distinct plane and tf-pool rows requested (``plane_rows``,
    ``tf_rows``; a missing phrase row's planes and the phrase row itself
    among them) and those not resident (``plane_fills``, ``tf_fills``)."""
    miss_sigs = [t for t in dict.fromkeys(tf_tids)
                 if isinstance(t, tuple) and t not in maps.tf_slot]
    plane_tids = list(plane_tids) + [t for s in miss_sigs
                                     for t in maps.phrase_recipes[s][0]]
    pin_p, pin_t = set(plane_tids), set(tf_tids)
    if plane_tids:
        _start(maps, "plane")
        _check_fits(maps.plane_slot, maps.plane_free, pin_p, plane_tids)
    if tf_tids:
        _start(maps, "tf")
        _check_fits(maps.tf_slot, maps.tf_free, pin_t, tf_tids)
    new_p = _alloc_slots(maps.plane_slot, maps.plane_free, pin_p, plane_tids)
    new_t = _alloc_slots(maps.tf_slot, maps.tf_free, pin_t, tf_tids)
    if profiling.active():
        profiling.count("plane_rows", len(pin_p))
        profiling.count("plane_fills", len(new_p))
        profiling.count("tf_rows", len(pin_t))
        profiling.count("tf_fills", len(new_t))
    terms, recipes = [], {}
    for key, slot in new_t:
        if isinstance(key, tuple):
            tids, fkey = maps.phrase_recipes[key]
            recipes.setdefault(fkey, []).append(
                (plane_slots_of(maps, tids), slot))
        else:
            terms.append((key, slot))
    return Fill(new_p, terms, recipes, new_t)


def release(maps, fills: Sequence[Fill]) -> None:
    """Unmap every key the reservations ``fills`` assigned and free its
    slot (the rows they evicted stay evicted), so no key is left on a row
    that was not filled for it."""
    for fill in fills:
        for slot_map, free, new in ((maps.plane_slot, maps.plane_free,
                                     fill.planes),
                                    (maps.tf_slot, maps.tf_free,
                                     fill.new_t)):
            for key, _ in new:
                if key in slot_map:
                    free.append(slot_map.pop(key))


def ensure_batch(dev: DeviceIndex, plane_tids: Sequence[int] = (),
                 tf_tids: Sequence = ()) -> None:
    """Make every requested term's plane and tf vector (or promoted
    phrase's row) pool-resident on one index: ``reserve`` then
    ``fill_rows``, the index held through both (the caller holds it on
    through the reads of the rows).  A fill that raises unmaps every slot
    this call assigned."""
    with dev.held():
        fill = reserve(dev.maps, plane_tids, tf_tids)
        try:
            fill_rows(dev, fill)
        except BaseException:
            release(dev.maps, [fill])
            raise


def fill_rows(dev: DeviceIndex, fill: Fill) -> None:
    """Fill one index's rows of a reservation from its own posting slices:
    the plane rows (one K4 launch), the term tf rows (one multi-row K1
    launch) and the phrase tf rows (one K5 launch per chain structure of
    the exact phrases, ``"ph"`` recipes, and one K6 launch per (terms,
    anchor, window, multiplicities) of the slop phrases, ``"phs"``
    recipes).  A term absent from the index fills a zero row."""
    if fill.planes:
        pool = _pool_tensor(dev, "plane")
        spans = [dev.term_span(t)[:2] for t, _ in fill.planes]
        bump(DISPATCHES)
        kernels_cuda.plane_fill(dev.hdrs, dev.pays, [o for o, _ in spans],
                                [n for _, n in spans],
                                [s for _, s in fill.planes], pool)
    if fill.terms or fill.recipes:
        tf_pool = _pool_tensor(dev, "tf")
    if fill.terms:
        spans = [dev.term_span(t)[:2] for t, _ in fill.terms]
        bump(DISPATCHES)
        kernels_cuda.score_term_rows(
            dev.hdrs, dev.pays, [o for o, _ in spans], [n for _, n in spans],
            tf_pool, [slot for _, slot in fill.terms],
            num_docs=dev.corpus_size, blk_bits=dev.blk_bits)
    # the planes above are filled first: stream order puts these reads
    # after the K4 launch that wrote them (or an earlier holder's)
    for fkey, rows in fill.recipes.items():
        plane_pool = _pool_tensor(dev, "plane")
        bump(DISPATCHES)
        slots = [slots for slots, _ in rows]
        into = dict(num_docs=dev.corpus_size, blk_bits=dev.blk_bits,
                    out=tf_pool, out_rows=[slot for _, slot in rows])
        if fkey[0] == "ph":
            _, _, plan_key, pattern = fkey
            kernels_cuda.phrase_chain(plane_pool, slots, plan_key,
                                      pattern, **into)
        else:
            _, _, anchor_i, w, mults = fkey
            kernels_cuda.span_window(plane_pool, slots, w, mults,
                                     anchor=anchor_i, **into)


def ensure_planes(dev: DeviceIndex, tids: Sequence[int]) -> None:
    """Make every term's dense plane resident in the plane pool."""
    ensure_batch(dev, plane_tids=tids)


def ensure_tfs(dev: DeviceIndex, tids: Sequence) -> None:
    """Make every term's (or promoted phrase's) tf vector resident in the
    tf pool."""
    ensure_batch(dev, tf_tids=tids)


def plane_slots_of(maps: SlotMaps, tids: Sequence[int]) -> np.ndarray:
    return np.asarray([maps.plane_slot[t] for t in tids], np.int32)


def tf_slots_of(maps: SlotMaps, tids: Sequence) -> np.ndarray:
    return np.asarray([maps.tf_slot[t] for t in tids], np.int64)


# ---------------------------------------------------------------------------
# scoring entry points
# ---------------------------------------------------------------------------
def pack_topk(dense: torch.Tensor, k: int) -> torch.Tensor:
    """[..., N] -> int32 [..., 2k]: f32 score bits ‖ int32 doc indices, one
    packed tensor so a whole batch crosses to the host in one copy.  The
    ranking is K3 (``ops/cuda/score.py:topk``): nothing here is read by
    the host."""
    if k == 0:
        return torch.empty(dense.shape[:-1] + (0,), dtype=torch.int32,
                           device=dense.device)
    scores, idx = kernels_cuda.topk(dense.contiguous(), k)
    return torch.cat([scores.view(torch.int32), idx], dim=-1)


def fuses(top_k: Optional[int]) -> bool:
    """Whether the fused pass (``kernels_cuda.rank_rows``) takes a group's
    top k: 1 to ``RANK_MAX_K`` (K3's one-pass cap)."""
    return top_k is not None and 1 <= top_k <= kernels_cuda.RANK_MAX_K


def count_ranked(n_rows: int, fused: bool) -> None:
    """Count a ranked group's rows on the innermost open span (``run_plan``'s
    ``batch.enqueue``): ``ranked_rows``, and ``ranked_unfused_rows`` for
    those that took K10 then K3."""
    if profiling.active():
        profiling.count("ranked_rows", n_rows)
        if not fused:
            profiling.count("ranked_unfused_rows", n_rows)


def rank_or_score(kind: str, k1: float, b: float, top_k: Optional[int],
                  freqs: torch.Tensor, doc_lens, idfs, avgdl, *, slots=None,
                  fused: bool = True, inplace: bool = False):
    """A group's similarity and, with ``top_k``, its packed top-k
    (``pack_topk``'s layout).  The group's rows are rows ``slots`` (an
    int64 device tensor) of ``freqs`` (the tf pool), or ``freqs`` itself
    (f32 [Qg, n], rows may be strided; overwritten by the scores where
    ``inplace``); ``doc_lens`` is f32 [n], ``idfs`` f32 [Qg].  Where
    ``fuses(top_k)`` and the rows are whole (``fused``: a ``rows`` subset
    is not) the fused pass ranks them and no score block is stored;
    otherwise K10 writes the [Qg, n] scores, which K3 ranks when ``top_k``
    is set."""
    Qg = freqs.shape[0] if slots is None else slots.shape[0]
    if fused and fuses(top_k):
        count_ranked(Qg, fused=True)
        vals, idx = kernels_cuda.rank_rows(kind, freqs, slots, doc_lens,
                                           idfs, avgdl, k1, b, top_k)
        return torch.cat([vals.view(torch.int32), idx], dim=-1)
    if slots is not None:
        freqs, inplace = freqs.index_select(0, slots), True
    out = K.apply_similarity_device(kind, freqs, doc_lens[None, :],
                                    idfs[:, None], avgdl, k1, b,
                                    out=freqs if inplace else None)
    if top_k is None:
        return out
    count_ranked(Qg, fused=False)
    return pack_topk(out, top_k)


def term_group_body(kind: str, k1: float, b: float, top_k: Optional[int],
                    tfpool, slots, doc_lens, idfs, avgdl, rows=None):
    """One term group: the similarity of its tf pool rows ``slots`` (+
    packed top-k; ``rank_or_score``: a ranked group's rows are read from
    the pool by the fused pass, not gathered).  With ``rows`` (a device
    index tensor of doc ids) the tf rows and the doc lengths are gathered
    at those docs and the scores are [Qg, len(rows)]."""
    if rows is None:
        return rank_or_score(kind, k1, b, top_k, tfpool, doc_lens, idfs,
                             avgdl, slots=slots)
    tfstack = tfpool.index_select(0, slots).index_select(1, rows)
    return rank_or_score(kind, k1, b, top_k, tfstack,
                         doc_lens.index_select(0, rows), idfs, avgdl,
                         fused=False, inplace=True)


def _rows_minis(dev: DeviceIndex, slots, rows):
    """(pool, slots, num_docs, doc lengths) that K5 or K6 reads: the plane
    pool, or with ``rows`` (an int32 device tensor of doc ids) the minis
    of every query's pooled planes at those docs (one K8b launch) and the
    doc lengths there."""
    if rows is None:
        return dev.plane_pool, slots, dev.corpus_size, dev.doc_lens
    slots = np.asarray(slots)
    Qg, T = slots.shape
    minis = kernels_cuda.cand_minis(
        rows, slots, np.zeros_like(slots), np.zeros_like(slots),
        pool=dev.plane_pool, hdrs=dev.hdrs, pays=dev.pays,
        num_docs=dev.corpus_size, blk_bits=dev.blk_bits)
    return (minis, np.arange(Qg * T).reshape(Qg, T), rows.shape[0],
            dev.doc_lens.index_select(0, rows))


def phrase_group_body(dev: DeviceIndex, plan_key: tuple, pattern: tuple,
                      kind: str, k1: float, b: float, top_k: Optional[int],
                      slots, idfs, avgdl, rows=None):
    """One exact-phrase group on full planes: one K5 launch reads every
    query's planes from the pool, then similarity (+ packed top-k, the
    fused pass over the freqs: ``rank_or_score``).
    ``slots`` is the host int [Qg, T] array of plane rows.  With ``rows``
    (an int32 device tensor of doc ids) K5 runs on the planes' minis at
    those docs (K8b) and the scores are [Qg, len(rows)]."""
    pool, slots, n_docs, doc_lens = _rows_minis(dev, slots, rows)
    freqs = kernels_cuda.phrase_chain(pool, slots, plan_key, pattern,
                                      num_docs=n_docs, blk_bits=dev.blk_bits)
    return rank_or_score(kind, k1, b, top_k, freqs, doc_lens, idfs, avgdl,
                         fused=rows is None, inplace=True)


def span_group_body(dev: DeviceIndex, anchor_i: int, w: int, mults: tuple,
                    kind: str, k1: float, b: float, top_k: Optional[int],
                    slots, idfs, avgdl, rows=None):
    """One slop group on full planes: one K6 launch reads every query's
    planes from the pool, then similarity (+ packed top-k, as in
    ``phrase_group_body``).  ``slots`` is
    the host int [Qg, T] array of the plane rows of each query's distinct
    terms.  With ``rows`` K6 runs on the minis at those docs, as in
    ``phrase_group_body``."""
    pool, slots, n_docs, doc_lens = _rows_minis(dev, slots, rows)
    freqs = kernels_cuda.span_window(pool, slots, w, mults, anchor=anchor_i,
                                     num_docs=n_docs, blk_bits=dev.blk_bits)
    return rank_or_score(kind, k1, b, top_k, freqs, doc_lens, idfs, avgdl,
                         fused=rows is None, inplace=True)
