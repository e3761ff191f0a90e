"""The least time the card could take for each kernel's work: its bound.

A kernel's work is counted from its inputs, as ``chip_smoke.py`` prints
it: each input byte it needs read once, each output byte written once
(a plane row that several queries of one K5 or K6 launch read counts
once; the halo K5 reads twice and the words a block's search probes do not
count; K3's rows count once, though its radix select reads them again
and its tile path passes over a shared-memory copy; of a K7 step's other
list the words a search would probe where those are fewer than the list;
of a K9 term's list the words of the neighbourhoods where those are fewer
than the list), and the 32-bit integer operations
its formulas need.  The bound is the larger of bytes over the card's memory rate and
operations over its 32-bit integer rate.  Nothing here launches or times anything.

Rates: one NVIDIA H100 SXM at its full 700 W limit.  Memory: 3.35 TB/s of
HBM3 (NVIDIA's data sheet).  Integer: the data sheet's 67 TFLOP/s is the
float32 rate (128 lanes per SM per clock, an FMA counted as two); the
integer pipe issues 64 32-bit adds, shifts or logic operations per SM per
clock and 16 popcounts (CUDA C++ Programming Guide, arithmetic instruction
throughput, compute capability 9.0), over 132 SMs at the 1.98 GHz boost
clock: 16.7 T/s.  Operations are counted in those issue slots, so a
popcount counts 4.  The few float operations per doc of K1's fused
similarity are counted at the integer rate too; they never decide a
bound.  K10, the similarity alone, and K11, edismax's composition, count
their float operations at the data sheet's float32 rate (67 TFLOP/s, a
fused multiply-add two).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SMS, BOOST_HZ = 132, 1.98e9
INT32_OPS_PER_S = 64 * SMS * BOOST_HZ
POPC = 4                 # issue slots of one popcount (16 per SM per clock)

# integer issue slots per element, from the formulas each kernel computes
K1_OPS_PER_WORD = POPC + 3   # popcount, key shift, subtract, add
K1_OPS_PER_DOC = {"none": 1, "bm25": 9, "bm25_impact": 8, "bm25_legacy": 10}
K2_OPS_PER_KEY = 2       # subtract, add
K4_OPS_PER_WORD = 2      # subtract, store
K5_OPS_PER_SLOT_STEP = POPC + 11  # popcount; ands, shifts, adds, or
K5_OPS_PER_DOC_STEP = 1    # the min over steps
K3_OPS_PER_ELEMENT = 4   # the key: sign test, flip, digit shift, compare
K6_OPS_PER_SHIFT = 4     # a position shift: two shifts, or, mask
K6_WINDOW = 18           # positions a slot holds: a shift by it is a move
K7_OPS_PER_PROBE = 3     # compare, add, shift of one search or merge step
K7_OPS_PER_WORD = POPC + 12  # popcount; window test, ands, shifts, or, key
K9_OPS_PER_STEP = 7      # a term's window step: two bit reads (shift, and
                         # each), add, subtract, compare with the multiplicity
K9_OPS_PER_START = 5     # per start: the anchor bit (shift, and), the last
                         # passing start (compare, select), add
K9_OPS_PER_JOIN = 4      # a term's three words as one string: two shifts,
                         # two ors
K9_OPS_PER_WORD = 6      # window test, block, key shift and add, convert
K9_WINDOW = 18           # positions a posting word holds
K8A_OPS_PER_WORD = 3     # key shift, compare with the previous key, the
                         # scan's add
K8A_OPS_PER_TF_WORD = POPC + 1   # popcount, add into the run's sum
K8B_OPS_PER_SLOT = 3     # pooled: row clip, address shift-or, copy; own
                         # slice: the zero store
K8B_OPS_PER_WORD = 4     # key shift, hit compare, address shift-or, store
# K10's float32 operations per element (a fused multiply-add counts 2):
# dl / avgdl, two fused multiply-adds, tf / denom, then the kind's own
K10_FLOPS = {"bm25": 7, "bm25_legacy": 8, "bm25_impact": 6,
             "classic": 4}   # classic: two roots, a product, a quotient
# K11's float32 operations per stack element: the boost's product, the
# max, the field sum (a fused multiply-add, 2); per term and doc the fold
# (a subtraction and a fused multiply-add), the term sum and the mm test
K11_FLOPS_PER_ELEMENT = 4
K11_FLOPS_PER_TERM_DOC = 5


def bound(nbytes: int, ops: int, flops: int = 0) -> dict:
    """``{"bytes", "ops", "bound_ms", "bound_by"}`` of a piece of work:
    ``ops`` integer issue slots and ``flops`` float32 operations take
    their times one after the other."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / INT32_OPS_PER_S + flops / F32_FLOPS_PER_S) * 1e3
    return {"bytes": int(nbytes), "ops": int(ops), "flops": int(flops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k1_work(n_words: int, num_docs: int, kind: str = "none") -> dict:
    """One K1 row: hdr32 + pay32 of each posting word in the row's doc
    range read, the f32 row written, the doc lengths read for the BM25
    kinds."""
    per_doc = 4 + (4 if kind != "none" else 0)
    return bound(8 * n_words + per_doc * num_docs,
                 K1_OPS_PER_WORD * n_words + K1_OPS_PER_DOC[kind] * num_docs)


def k1_rows_work(ns: Iterable[int], num_docs: int) -> dict:
    """Many K1 tf rows (kind none), in one launch or one each: the sum of
    their rows' work."""
    ns = [int(n) for n in ns]
    return bound(8 * sum(ns) + 4 * num_docs * len(ns),
                 K1_OPS_PER_WORD * sum(ns) + num_docs * len(ns))


def k2_work(n_keys: int, num_out: int) -> dict:
    """One K2 launch: the id and value of each key below ``num_out`` read
    (the pad tail is dropped unread), each output slot written."""
    return bound(8 * n_keys + 4 * num_out, K2_OPS_PER_KEY * n_keys)


def k2_flat_work(flat_keys, num_out: int) -> dict:
    """One K2 launch on the flat keys it is given (a numpy array or a
    tensor): the keys below ``num_out`` are its in-range keys, the clamped
    pad run of ``_flat_keys`` among them; a 2^30 tail is not."""
    return k2_work(int((flat_keys < num_out).sum()), num_out)


def k3_work(n_rows: int, n: int, k: int) -> dict:
    """One K3 call: f32[n_rows, n] read once, k values and k indices
    written per row."""
    return bound(4 * n_rows * n + 8 * n_rows * k,
                 K3_OPS_PER_ELEMENT * n_rows * n)


def k4_work(ns: Sequence[int], plane_size: int) -> dict:
    """One K4 launch: the posting words of each row read, each row of
    ``plane_size`` int32 slots written whole."""
    words = int(sum(int(n) for n in ns))
    return bound(8 * words + 4 * plane_size * len(ns),
                 K4_OPS_PER_WORD * words)


def k5_work(slots, plan, num_docs: int, slots_per_doc: int) -> dict:
    """One K5 launch over a group: each DISTINCT plane row of ``slots``
    ([queries, terms] plane-pool rows) read once, the query's row of
    per-doc freqs written, and the slot array read; the halo is not
    work."""
    return k5_batch_work([(slots, plan)], num_docs, slots_per_doc)


def k5_batch_work(groups, num_docs: int, slots_per_doc: int) -> dict:
    """K5 over several groups ``[(slots, plan), ...]``, one launch each, as
    one batch: each plane row DISTINCT across the batch read once.  A
    plane that two launches share counts once, though each launch reads
    it; ``k5_plane_reads`` counts those reads."""
    plane = num_docs * slots_per_doc
    distinct = np.unique(np.concatenate(
        [np.asarray(s).ravel() for s, _ in groups]))
    nbytes, ops = 4 * plane * len(distinct), 0
    for slots, plan in groups:
        slots = np.asarray(slots)
        steps = sum(len(idxs) - 1 for _, idxs in plan)
        nbytes += 4 * num_docs * slots.shape[0] + 4 * slots.size
        ops += slots.shape[0] * steps * (K5_OPS_PER_SLOT_STEP * plane
                                         + K5_OPS_PER_DOC_STEP * num_docs)
    return bound(nbytes, ops)


def k5_plane_reads(groups) -> int:
    """The plane rows K5 fetches over ``[(slots, plan), ...]``: each
    launch's distinct rows, summed over the launches."""
    return int(sum(len(np.unique(np.asarray(s))) for s, _ in groups))


def _k6_dilate_ops(length: int) -> int:
    """The log-step dilation over ``length`` offsets: per step a position
    shift and an or."""
    ops, cur = 0, 1
    while cur < length:
        k = min(cur, length - cur)
        ops += (0 if k == K6_WINDOW else K6_OPS_PER_SHIFT) + 1
        cur += k
    return ops


def k6_ops_per_slot(w: int, mults: Sequence[int]) -> int:
    """Integer operations per plane slot of one K6 query, counted from
    the plain version (``ops/kernels.py:span_counts_dense_planes_plain``):
    per term of multiplicity 1 the dilation down over w + 1 starts; per
    term of multiplicity 2, for every distance d = 1..w, a shift, an and,
    the dilation over w + 1 - d and an or; the and over the terms; the
    dilation up over w + 1; the and with the anchor, the popcount and the
    add into the doc's sum."""
    ops = len(mults) - 1 + _k6_dilate_ops(w + 1) + 1 + POPC + 1
    for m in mults:
        if m == 1:
            ops += _k6_dilate_ops(w + 1)
        else:
            for d in range(1, w + 1):
                ops += ((0 if d == K6_WINDOW else K6_OPS_PER_SHIFT) + 1
                        + _k6_dilate_ops(w + 1 - d) + (1 if d > 1 else 0))
    return ops


def k6_work(slots, w: int, mults: Sequence[int], num_docs: int,
            slots_per_doc: int) -> dict:
    """One K6 launch over a group: each DISTINCT plane row of ``slots``
    ([queries, distinct terms] plane-pool rows) read once, each query's
    row of per-doc counts written, and the slot array read."""
    return k6_batch_work([(slots, w, mults)], num_docs, slots_per_doc)


def k6_batch_work(groups, num_docs: int, slots_per_doc: int) -> dict:
    """K6 over several groups ``[(slots, w, mults), ...]``, one launch
    each, as one batch: each plane row DISTINCT across the batch read
    once, as ``k5_batch_work`` counts them."""
    plane = num_docs * slots_per_doc
    distinct = np.unique(np.concatenate(
        [np.asarray(s).ravel() for s, _, _ in groups]))
    nbytes, ops = 4 * plane * len(distinct), 0
    for slots, w, mults in groups:
        slots = np.asarray(slots)
        nbytes += 4 * num_docs * slots.shape[0] + 4 * slots.size
        ops += slots.shape[0] * (k6_ops_per_slot(w, mults) * plane
                                 + num_docs)
    return bound(nbytes, ops)


def k7_work(base_ns: Iterable[int], other_ns: Iterable[int],
            need_cont: bool = True, same_term: bool = False) -> dict:
    """One K7 launch over a chunk of queries: hdr32 + pay32 of each base
    word read once, and per base word the key, the count and (with
    ``need_cont``) the continuation written.  A base word's partners are
    found by the cheaper of a search of the other list (log2 probes a
    word) or one merge walk of both lists: that many operations, and of
    the other list the 8 bytes of each word so touched, never more than
    the list.  The same-term step has one list and needs neither."""
    base_ns = [int(n) for n in base_ns]
    other_ns = [0] * len(base_ns) if same_term else [int(n) for n in other_ns]
    B = sum(base_ns)
    searched = [nb * int(na).bit_length()
                for nb, na in zip(base_ns, other_ns)]
    touched = sum(min(s, na) for s, na in zip(searched, other_ns))
    probes = sum(min(s, na + nb)
                 for s, na, nb in zip(searched, other_ns, base_ns))
    return bound(8 * B + 8 * touched + (12 if need_cont else 8) * B,
                 K7_OPS_PER_WORD * B + K7_OPS_PER_PROBE * probes)


def k9_ops_per_live_word(w: int, mults: Sequence[int]) -> int:
    """Integer operations of the windows of one K9 anchor word that has a
    position set, the searches apart.  Where the window fits one block
    either side (w <= 18) and no term is named more than twice, a term's
    neighbourhood is three words, one string of 54 bits: joining them is
    two shifts and two ors a term, and the windows are the dilations
    ``k6_ops_per_slot`` counts, each on a string two registers long.  Any
    other shape has no such form: every one of the w + 18 starts is a step
    of each term's running count."""
    if w <= K9_WINDOW and max(mults) <= 2:
        return 2 * k6_ops_per_slot(w, mults) + K9_OPS_PER_JOIN * len(mults)
    return (w + K9_WINDOW) * (K9_OPS_PER_STEP * len(mults)
                              + K9_OPS_PER_START)


def k9_work(term_ns, anchor: int, w: int, live=None, mults=None) -> dict:
    """One K9 launch over a chunk of queries.  ``term_ns`` is [queries,
    distinct terms]: the words of each term's list inside the anchor's
    header range (the anchor's own column, ``anchor``, holds its words);
    ``mults`` each column's multiplicity in the query (all 1 by default).
    Bytes: hdr32 + pay32 of each anchor word read once, the key and the
    count written; of every other term the words of the anchor words'
    neighbourhoods (2C + 1 headers each, C = ceil(w / 18)), never more
    than its list; the anchor's own list serves as its term list too.
    Operations: per anchor word and term one search of log2 probes, and
    per anchor word the windows as ``k9_ops_per_live_word`` counts them.
    ``live`` is the number of anchor words with a position set once the
    block window has been applied (all of them by default): a word without
    one covers nothing and needs neither the searches nor the windows."""
    term_ns = np.asarray(term_ns, dtype=np.int64).reshape(
        -1, np.shape(term_ns)[-1])
    T = term_ns.shape[1]
    mults = [1] * T if mults is None else [int(m) for m in mults]
    if len(mults) != T:
        raise ValueError("one multiplicity for each distinct term")
    C = -(-int(w) // K9_WINDOW)
    A = term_ns[:, anchor]
    words = int(A.sum())
    others = np.delete(term_ns, anchor, axis=1)
    touched = np.minimum(others, (A * (2 * C + 1))[:, None]).sum()
    probes = (A[:, None] * np.ceil(np.log2(np.maximum(term_ns, 1) + 1))).sum()
    n_live = words if live is None else int(live)
    if words:
        probes = probes * n_live / words
    return bound(16 * words + 8 * int(touched),
                 K9_OPS_PER_WORD * words + K7_OPS_PER_PROBE * int(probes)
                 + n_live * k9_ops_per_live_word(int(w), mults))


def k8a_work(ns: Iterable[int], kc: int, with_tf: bool = True) -> dict:
    """One K8a launch over a chunk of queries, one posting slice each
    (``ns`` words): the 4-byte header of each word read (and its payload
    with ``with_tf``), and each query's int32 row table of ``kc`` (and f32
    tf row) written.  A word's candidate index stays in registers."""
    ns = [int(n) for n in ns]
    words, rows = sum(ns), len(ns) * int(kc)
    per_word = 4 + (4 if with_tf else 0)
    ops = (K8A_OPS_PER_WORD + (K8A_OPS_PER_TF_WORD if with_tf else 0)) * words
    return bound(per_word * words + (8 if with_tf else 4) * rows, ops + rows)


def k8b_work(kc: int, blk_bits: int, n_pooled: int, mini_ns: Iterable[int],
             n_tables: int) -> dict:
    """One K8b launch: ``n_pooled`` minis copied from plane-pool rows (each
    of their ``kc << blk_bits`` slots read once and written once), one
    mini per entry of ``mini_ns`` built from that many posting words (8
    bytes each read once, a search of log2(kc) probes each, every slot of
    the mini written), and ``n_tables`` int32 row tables of ``kc`` read."""
    mini_ns = [int(n) for n in mini_ns]
    width = int(kc) << int(blk_bits)
    words = sum(mini_ns)
    probes = words * max(1, int(kc).bit_length())
    nbytes = (8 * width * n_pooled + 8 * words + 4 * width * len(mini_ns)
              + 4 * int(kc) * n_tables)
    ops = (K8B_OPS_PER_SLOT * width * (n_pooled + len(mini_ns))
           + K8B_OPS_PER_WORD * words + K7_OPS_PER_PROBE * probes)
    return bound(nbytes, ops)


def k10_work(rows: int, n: int, kind: str = "bm25",
             per_element_lens: bool = False) -> dict:
    """One K10 launch over an f32 [rows, n] block: each tf read once and
    each score written once (4 bytes each), the doc lengths read once a
    launch ([n], broadcast over the rows) or once an element ([rows, n],
    the candidate path's), and an idf a row."""
    elems = int(rows) * int(n)
    nbytes = 8 * elems + 4 * (elems if per_element_lens else int(n)) \
        + 4 * int(rows)
    return bound(nbytes, 0, K10_FLOPS[kind] * elems)


def rank_work(rows: int, n: int, k: int, kind: str = "bm25") -> dict:
    """One launch of the fused ranking pass (K3 with K10 inside) over
    ``rows`` f32 rows of ``n`` docs: each tf read once (4 bytes), the
    doc lengths once a launch (the rows of a tile read them from L2), an
    idf a row, k values and k indices written a row; K3's key work and
    K10's float32 operations on every element."""
    elems = int(rows) * int(n)
    return bound(4 * elems + 4 * int(n) + 4 * int(rows) + 8 * int(rows) * k,
                 K3_OPS_PER_ELEMENT * elems, K10_FLOPS[kind] * elems)


def k11_work(terms: Sequence[int], n: int) -> dict:
    """One K11 launch over F score stacks of ``terms[f]`` rows of ``n``
    docs: each stack element read once (4 bytes), each doc's score written
    once (4 bytes)."""
    elems = sum(int(t) for t in terms) * int(n)
    flops = K11_FLOPS_PER_ELEMENT * elems \
        + K11_FLOPS_PER_TERM_DOC * max(int(t) for t in terms) * int(n)
    return bound(4 * elems + 4 * int(n), 0, flops)


def total(works: Iterable[dict]) -> dict:
    """The bound of several launches run one after another: their bytes
    and operations add up."""
    works = list(works)
    return bound(sum(w["bytes"] for w in works),
                 sum(w["ops"] for w in works),
                 sum(w.get("flops", 0) for w in works))
