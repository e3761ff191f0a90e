"""Posting-plane layout helpers: host derivation (numpy) and device slicing,
similarity math, exact top-k, the exact-phrase bigram chain and the slop
window coverage on dense planes (torch).

Posting slices are cut from the padded planes; tails past a term's words
are rewritten to a sentinel header (max value, empty payload) so
sortedness is preserved and padding is inert in every popcount and
segment-sum.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from searcharray_tpu_torch.ops.encoding import LSB_BITS, LSB_MASK, MSB_SHIFT

MIN_BUCKET = 8

# Sentinel header for padding in the 32-bit plane layout: larger than any
# real compressed header (doc << blk_bits | blk), sorts last, payload 0.
PAD_HDR32 = (1 << 31) - 16


def bucket_of(n: int) -> int:
    """Padded size for a posting slice of length n.

    Quarter-power-of-two steps (1, 1.25, 1.5, 1.75 times 2^k): at most 25%
    padding instead of 2x.
    """
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    p = MIN_BUCKET
    while p < n:
        p <<= 1
    half = p >> 1
    for frac in (5, 6, 7):
        cand = (half * frac) >> 2
        if n <= cand:
            return cand
    return p


def expand_bucket_of(n: int) -> int:
    """Coarse power-of-4 padding bound.  DeviceIndex pads its planes to
    this bound (and to ``bucket_of``) so a bucket-sized slice taken at any
    term's offset stays inside the planes."""
    b = 4096
    while b < n:
        b <<= 2
    return b


def _ceil_log2(n: np.ndarray) -> np.ndarray:
    """The bit length of ``n - 1`` for int64 ``n >= 1`` below 2**53."""
    return np.frexp((n - 1).astype(np.float64))[1].astype(np.int64)


def buckets_of(n: np.ndarray) -> np.ndarray:
    """``bucket_of`` of every entry of int64 ``n``."""
    n = np.asarray(n, np.int64)
    p = np.left_shift(1, np.maximum(_ceil_log2(np.maximum(n, 1)),
                                    MIN_BUCKET.bit_length() - 1))
    half = p >> 1
    out = p
    for frac in (7, 6, 5):     # the smallest step that holds n wins
        cand = (half * frac) >> 2
        out = np.where(n <= cand, cand, out)
    return np.where(n <= MIN_BUCKET, MIN_BUCKET, out)


def expand_buckets_of(n: np.ndarray) -> np.ndarray:
    """``expand_bucket_of`` of every entry of int64 ``n``."""
    e = _ceil_log2(np.maximum(np.asarray(n, np.int64), 1))
    return np.left_shift(1, 12 + 2 * ((np.maximum(e, 12) - 11) // 2))


def compress_planes(words: np.ndarray, blk_bits: int):
    """uint64 posting words -> (hdr32 int32, pay32 uint32) planes.

    hdr32 = doc_key << blk_bits | block.  Device kernels are pure 32-bit
    and headers stay sortable as one i32 key.
    Requires doc_key < 2**(31 - blk_bits) - 16.
    """
    from searcharray_tpu_torch.index import native as native_mod

    res = native_mod.compress_planes(words, blk_bits)
    if res is not None:
        hdr32, pay, max_hdr = res
        if max_hdr >= PAD_HDR32 - 16:
            raise ValueError(
                "corpus too large for 32-bit posting headers at this "
                "document length"
            )
        return hdr32, pay
    keys = (words >> np.uint64(64 - 28)).astype(np.int64)
    blks = ((words >> np.uint64(MSB_SHIFT)) & np.uint64((1 << 18) - 1)).astype(
        np.int64
    )
    hdr = (keys << blk_bits) | blks
    if len(hdr) and int(hdr.max()) >= PAD_HDR32 - 16:
        raise ValueError(
            "corpus too large for 32-bit posting headers at this document "
            "length"
        )
    pay = (words & np.uint64(int(LSB_MASK))).astype(np.uint32)
    return hdr.astype(np.int32), pay


def blk_bits_for(max_doc_len: int) -> int:
    """Static block-field width: enough for every block plus one spare slot
    so hdr+1 adjacency probes never roll into the next document."""
    max_blk = max(0, (max(1, int(max_doc_len)) - 1) // LSB_BITS)
    bits = 1
    while (1 << bits) < max_blk + 2:
        bits += 1
    return bits


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add does.

    Each argument is a float32 tensor or a number that float32 holds
    exactly.  The product of two float32 values is exact in float64, so
    only the sum rounds: ``s`` is the float64 sum and ``e`` its error by
    TwoSum.  Where ``e`` is not 0 and the last bit of ``s`` is even, ``s``
    moves one ulp toward ``e`` (rounding to odd), and the cast to float32
    then rounds to nearest.  Rounding to odd in a format of at least p + 2
    bits, then to nearest in p bits, is correctly rounded (Boldo and
    Melquiond, "Emulation of FMA and correctly rounded sums: proved
    algorithms using rounding to odd", IEEE Trans. Computers, 2008)."""
    def f64(x):
        return x.to(torch.float64) if torch.is_tensor(x) else float(x)

    p = f64(a) * f64(b)
    c = f64(c)
    s = p + c
    if not torch.is_tensor(s):
        s = torch.tensor(s, dtype=torch.float64)
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    move = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    away = torch.where(e > 0, torch.inf, -torch.inf).to(s)
    return torch.where(move, torch.nextafter(s, away), s).to(torch.float32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root of float32 ``x`` >= 0, correctly rounded.
    torch's CPU sqrt is not on every input (its float32 root of 267 is one
    step low), so the root is taken in float64, rounded to float32 and
    moved one step where the square of a midpoint next to it, exact in
    float64 (a 25-bit value squared), says it is on the wrong side."""
    r = torch.sqrt(x.to(torch.float64)).to(torch.float32)
    x64 = x.to(torch.float64)
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    hi = (r.to(torch.float64) + up.to(torch.float64)) / 2
    lo = (r.to(torch.float64) + down.to(torch.float64)) / 2
    r = torch.where(hi * hi < x64, up, r)
    return torch.where((lo * lo > x64) & (r > 0), down, r)


def similarity_plain(kind, tfs, doc_lens, idf, avgdl, k1, b):
    """The similarity in plain PyTorch, rounded as the JAX package's
    compiled programs round it where ``avgdl`` is traced: the BM25 family's
    length norm and its sum with tf are two fused multiply-adds,
    ``denom = fma(k1, fma(b, dl / avgdl, 1 - b), tf)`` (``fma_f32``), every
    other operation rounds once, in the JAX formulas' association.
    ``classic`` is ``idf * sqrt(tf) / sqrt(dl)``, the form of the JAX
    package's multi-query ``score_batch``, each root correctly rounded
    (``sqrt_f32``).  ``idf`` is a scalar or a tensor that broadcasts
    against ``tfs``; so is ``doc_lens``."""
    if kind == "none":
        return tfs
    if isinstance(idf, np.generic):
        idf = float(idf)  # numpy scalars must not drive tensor arithmetic
    if kind == "classic":
        # idf passed in is the classic idf; the norm is not used
        return idf * sqrt_f32(tfs) / sqrt_f32(doc_lens)
    if kind not in ("bm25", "bm25_legacy", "bm25_impact"):
        raise ValueError(f"unknown similarity kind {kind}")
    k1f, bf = np.float32(k1), np.float32(b)
    # a tensor divisor: CUDA torch divides by a host scalar as a multiply
    # by its reciprocal, which is not the IEEE quotient the kernels and
    # numpy give
    avgdl_t = doc_lens.new_full((), float(np.float32(avgdl)))
    inner = fma_f32(float(bf), doc_lens / avgdl_t,
                    float(np.float32(1.0) - bf))
    denom = fma_f32(float(k1f), inner, tfs)
    if kind == "bm25":
        return (tfs / denom) * idf
    if kind == "bm25_legacy":
        return idf * ((tfs * float(k1f + np.float32(1.0))) / denom)
    return tfs / denom


def apply_similarity_device(kind, tfs, doc_lens, idf, avgdl, k1, b,
                            out=None):
    """The similarity of f32 ``tfs`` ([N] or [Q, N]) on their device: K10
    (``ops/cuda/score.py:similarity``) for CUDA tensors, its plain version
    ``similarity_plain`` for CPU tensors; any other device raises.
    ``doc_lens`` is f32 [N] (or a [1, N] view) or [Q, N]; ``idf`` a scalar
    or one per row ([Q] or [Q, 1]).  ``out`` (a contiguous f32 tensor of
    ``tfs``' shape, ``tfs`` itself where the caller owns it) takes the
    result; kind ``"none"`` returns ``tfs``."""
    if kind == "none":
        return tfs
    # ops/cuda/score.py imports this module, so its wrapper is looked up
    # when the first similarity runs
    from searcharray_tpu_torch.ops.cuda import score as kernels_cuda

    return kernels_cuda.similarity(kind, tfs, doc_lens, idf, avgdl, k1, b,
                                   out=out)


def compose_plain(stacks, boosts, tie, msm, *, term_centric: bool,
                  chain: bool = True, out=None) -> torch.Tensor:
    """edismax's dismax / tie / mm composition in plain PyTorch, rounded as
    the JAX package's programs round it (``searcharray_tpu/solr.py``,
    read from XLA's CPU code): the fold ``mx + (sm - mx) * tie`` is one
    fused multiply-add, ``fma(sm - mx, tie, mx)`` (``fma_f32``), and every
    other operation rounds once, in the JAX formulas' order.

    ``stacks`` are F f32 [T_f, N] score blocks (row views may be strided),
    ``boosts`` one number per field.  Term-centric (every T_f equal to T):
    per term the boosted field scores ``fs_f = s_f * b_f``, their max and
    their sum, the sum a chain of fused multiply-adds in field order
    (``fma(s_1, b_1, s_0 * b_0)``, ...) where ``chain`` (``edismax``'s
    program) or rounded per add (``edismax_batch``'s, under ``lax.map``);
    then the fold, and the sum over the terms in order where at least
    ``msm`` terms score.  Field-centric: per field the sum of its terms in
    order where at least ``msm[f]`` of them score, times its boost; the
    sum and max over the fields, then the fold.  Rows are added one at a
    time, so the order holds on any device.  Returns f32 [N] (into
    ``out`` when given)."""
    n = stacks[0].shape[1]
    tie = float(np.float32(tie))
    bs = [float(np.float32(b)) for b in boosts]
    zero = torch.zeros(n, dtype=torch.float32, device=stacks[0].device)
    none = torch.zeros(n, dtype=torch.int32, device=zero.device)
    if term_centric:
        tot, cnt = zero, none
        for t in range(stacks[0].shape[0]):
            mx = sm = stacks[0][t] * bs[0]
            for s, b in zip(stacks[1:], bs[1:]):
                fs = s[t] * b
                mx = torch.maximum(mx, fs)
                sm = fma_f32(s[t], b, sm) if chain else sm + fs
            ts = fma_f32(sm - mx, tie, mx)
            cnt = cnt + (ts > 0)
            tot = tot + ts
        got = torch.where(cnt >= msm, tot, 0.0)
    else:
        sm = mx = None
        for s, b, m in zip(stacks, bs, msm):
            tot, cnt = zero, none
            for t in range(s.shape[0]):
                tot = tot + s[t]
                cnt = cnt + (s[t] > 0)
            val = torch.where(cnt >= m, tot, 0.0) * b
            sm = zero + val if sm is None else sm + val
            mx = val if mx is None else torch.maximum(mx, val)
        got = fma_f32(sm - mx, tie, mx)
    return got if out is None else out.copy_(got)


def compose_device(stacks, boosts, tie, msm, *, term_centric: bool,
                   chain: bool = True, out=None) -> torch.Tensor:
    """edismax's composition (``compose_plain``'s arguments) on its
    stacks' device: K11 (``ops/cuda/score.py:compose``) for CUDA tensors,
    ``compose_plain`` for CPU tensors; any other device raises."""
    from searcharray_tpu_torch.ops.cuda import score as kernels_cuda

    return kernels_cuda.compose(stacks, boosts, tie, msm,
                                term_centric=term_centric, chain=chain,
                                out=out)


def topk_exact(x: torch.Tensor, k: int):
    """Exact top-k over the last axis, ties to the SMALLEST index.

    ``torch.topk`` gives no tie order (on [1,3,3,2,3] with k=2 it may
    return indices [2, 4]; the contract is [1, 2]).  So: take the k-th
    value from ``torch.topk``; keep every element above it; fill the rest
    with the earliest elements equal to it (a running count over the
    equality mask); ``nonzero`` lists the k survivors of each row in
    ascending index order, and a stable descending sort by score then
    orders them by (-score, index)."""
    if k == 0:
        return (x.new_empty(x.shape[:-1] + (0,)),
                torch.empty(x.shape[:-1] + (0,), dtype=torch.int64,
                            device=x.device))
    kth = torch.topk(x, k, dim=-1, sorted=True).values[..., -1:]
    above = x > kth
    tie = x == kth
    need = k - above.sum(dim=-1, keepdim=True)
    keep = above | (tie & (torch.cumsum(tie, dim=-1) <= need))
    idx = torch.nonzero(keep)[:, -1].reshape(x.shape[:-1] + (k,))
    vals = torch.gather(x, -1, idx)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, torch.gather(idx, -1, order)


def topk_keys(x: torch.Tensor) -> torch.Tensor:
    """The total order K3 (csrc/topk.cu) selects by, as int64 keys: the
    float's bits mapped to an order-preserving unsigned 32-bit value key
    (-0.0 as +0.0, so the two compare equal as floats do) in the high
    half, ``~index`` in the low half, the top bit flipped so that signed
    order is the unsigned order.  No two keys of a row are equal, and the
    k largest are the top-k with ties to the smallest index.  Rows hold no
    NaN."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, torch.zeros_like(b), b)
    vkey = torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    return ((vkey - 0x80000000) << 32) | (0xFFFFFFFF - idx)


def topk_by_keys(x: torch.Tensor, k: int):
    """``topk_exact`` by a descending sort of ``topk_keys``: the order the
    K3 kernel computes, in plain PyTorch."""
    keys = torch.sort(topk_keys(x), dim=-1, descending=True).values[..., :k]
    idx = 0xFFFFFFFF - (keys & 0xFFFFFFFF)
    return torch.gather(x, -1, idx), idx


def rank_rows_plain(kind, src, slots, doc_lens, idfs, avgdl, k1, b, k: int):
    """The fused ranking pass (``csrc/topk.cu``, ``sa_rank_rows``) in
    plain PyTorch: ranked row r is source row ``slots[r]`` of f32 ``src``
    [R, N] (row r where ``slots`` is None), its scores ``similarity_plain``
    with the f32 [N] ``doc_lens`` and its idf ``idfs[r]``, ranked by
    ``topk_exact``.  Returns (values f32 [Q, k], indices int64 [Q, k])."""
    rows = src if slots is None else src.index_select(0, slots)
    scores = similarity_plain(kind, rows, doc_lens.reshape(1, -1),
                              idfs.reshape(-1, 1), avgdl, k1, b)
    return topk_exact(scores, k)


def take_term_planes(hdrs: torch.Tensor, pays: torch.Tensor, off: int,
                     n: int, min_blk=None, max_blk=None, *, bucket: int,
                     blk_bits: int):
    """Slice bucket-sized (hdr32, pay32) planes with PAD-sanitized tail and
    optional position-block windowing (the reference's payload_slice,
    `roaringish_ops.pyx:46`, `roaringish.py:245-282`).  Returns new
    tensors; the planes are not modified."""
    h = hdrs[off: off + bucket]
    p = pays[off: off + bucket]
    if n < bucket:
        valid = torch.arange(bucket, device=hdrs.device) < n
        h = torch.where(valid, h, PAD_HDR32)
        p = torch.where(valid, p, 0)
    p = window_payloads(h, p, min_blk, max_blk, blk_bits)
    return h.contiguous(), p.contiguous()


def popcount_i32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of non-negative int32 values (torch has no popcount
    op; ``>>`` on int32 is arithmetic, exact for the 18-bit payloads)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


# ---------------------------------------------------------------------------
# the exact-phrase chain on dense planes: the plain version of K5 (int32
# planes; every value < 2^18, so shifts are exact)
# ---------------------------------------------------------------------------
_TOP = LSB_BITS - 1          # bit index of "last position in block"
_LSB32 = (1 << LSB_BITS) - 1


def _shift_up(a):
    """a[s] -> a[s-1] over the flat slot axis (previous slot; zero fill)."""
    return F.pad(a[..., :-1], (1, 0))


def _shift_down(a):
    """a[s] -> a[s+1] over the flat slot axis (next slot; zero fill)."""
    return F.pad(a[..., 1:], (0, 1))


def _popcount_f32(x):
    return popcount_i32(x).to(torch.float32)


def _same_counts_dense(p):
    """Same-term adjusted counts per slot: adjacent pairs of a run, less
    ceil(consecutive pairs / 2) (phrase._same_term_counts)."""
    overlap = p & ((p << 1) & _LSB32)
    adj = popcount_i32(overlap)
    consec = popcount_i32(overlap & (overlap << 1) & _LSB32)
    return (adj - (consec + 1) // 2).to(torch.float32), overlap


def _dense_chain(planes: List, pattern: List[int], direction: str):
    """Bigram chain over dense planes ([..., NS] each); returns the
    per-slot count arrays (one per step).  ``pattern`` are same-term
    equivalence tags."""
    steps = []
    carry = None
    if direction == "l2r":
        for i in range(1, len(planes)):
            R = planes[i]
            if carry is None and pattern[i] == pattern[i - 1]:
                counts, overlap = _same_counts_dense(R)
                adj = (_shift_up(R) >> _TOP) & R & 1
                counts = counts + adj.to(torch.float32)
                cont = overlap | adj
            else:
                L = planes[i - 1] if carry is None else carry
                inner = L & (R >> 1)
                adj = (_shift_up(L) >> _TOP) & R & 1
                counts = _popcount_f32(inner) + adj.to(torch.float32)
                cont = ((inner << 1) & _LSB32) | adj
            steps.append(counts)
            carry = cont
    else:
        for i in range(len(planes) - 2, -1, -1):
            L = planes[i]
            if carry is None and pattern[i] == pattern[i + 1]:
                counts, _ = _same_counts_dense(L)
                adj = (L >> _TOP) & _shift_down(L) & 1
                counts = counts + adj.to(torch.float32)
                cont = (L & (L >> 1)) | (adj << _TOP)
            else:
                R = planes[i + 1] if carry is None else carry
                overlap = L & (R >> 1)
                adj = (L >> _TOP) & _shift_down(R) & 1
                counts = _popcount_f32(overlap) + adj.to(torch.float32)
                cont = overlap | (adj << _TOP)
            steps.append(counts)
            carry = cont
    return steps


def phrase_counts_dense_planes(planes, pattern, plan, num_docs: int,
                               slots: int):
    """Min-over-steps per-doc phrase freqs from dense planes ([..., NS]
    int32 each): the plain version of K5."""
    freqs = None
    for direction, idxs in plan:
        sub = [planes[i] for i in idxs]
        tags = [pattern[i] for i in idxs]
        for counts in _dense_chain(sub, tags, direction):
            per_doc = counts.reshape(counts.shape[:-1]
                                     + (num_docs, slots)).sum(-1)
            freqs = per_doc if freqs is None else torch.minimum(freqs,
                                                                per_doc)
    return freqs


# ---------------------------------------------------------------------------
# slop window coverage on dense planes: the plain version of K6.  A plane
# is a bit string over the flat slot axis, 18 positions per slot; values
# are masked before a left shift so that int32 never overflows
# ---------------------------------------------------------------------------
def _shift_posns_down(x, k: int):
    """y(p) = x(p + k), 1 <= k <= LSB_BITS (pulls from the next slot)."""
    nxt = _shift_down(x)
    if k == LSB_BITS:
        return nxt
    return (x >> k) | ((nxt & ((1 << k) - 1)) << (LSB_BITS - k))


def _shift_posns_up(x, k: int):
    """y(p) = x(p - k), 1 <= k <= LSB_BITS (pulls from the previous slot
    of the flat axis)."""
    prv = _shift_up(x)
    if k == LSB_BITS:
        return prv
    return ((x & ((1 << (LSB_BITS - k)) - 1)) << k) | (prv >> (LSB_BITS - k))


def _dilate(x, length: int, shifter):
    """OR of ``x`` shifted by every offset in [0, length), in log steps."""
    y = x
    cur = 1
    while cur < length:
        k = min(cur, length - cur)
        y = y | shifter(y, k)
        cur += k
    return y


def _win_pair_starts(x, w: int):
    """Window starts s where [s, s+w] holds at least two set bits of
    ``x``: positions p and p+d are both set iff ``x & (x >> d)`` has bit
    p, and such a pair lies in [s, s+w] iff s is in [p-(w-d), p], a
    down-dilation of length w-d+1; OR over d = 1..w."""
    ok = None
    for d in range(1, w + 1):
        pair = x & _shift_posns_down(x, d)
        cover = _dilate(pair, w + 1 - d, _shift_posns_down)
        ok = cover if ok is None else ok | cover
    return ok


def span_counts_dense_planes_plain(planes, anchor_i: int, w: int,
                                   num_docs: int, slots: int, mults=None):
    """Per-doc slop span counts on dense planes ([..., NS] int32 each):
    the plain version of K6.

    An anchor position p (of term ``anchor_i``) is covered iff some window
    [s, s+w] with s <= p <= s+w holds at least ``mults[t]`` bits of every
    term t.  ok(s) = AND over terms of the window's presence (a dilation
    down over [0, w]; the pair trick for multiplicity 2); covered(p) = OR
    of ok over [p-w, p] (a dilation up); the count is the per-doc popcount
    of the covered anchor bits.  Valid for w <= LSB_BITS (a shift never
    crosses two slots) and multiplicities <= 2."""
    if not 1 <= w <= LSB_BITS:
        raise ValueError(f"the dense span window takes 1 <= w <= {LSB_BITS}")
    ok = None
    for i, pl in enumerate(planes):
        m = 1 if mults is None else mults[i]
        if m == 1:
            present = _dilate(pl, w + 1, _shift_posns_down)
        elif m == 2:
            present = _win_pair_starts(pl, w)
        else:
            raise ValueError("the dense span window takes multiplicities "
                             "<= 2")
        ok = present if ok is None else ok & present
    covered = _dilate(ok, w + 1, _shift_posns_up)
    counts = _popcount_f32(planes[anchor_i] & covered)
    return counts.reshape(counts.shape[:-1] + (num_docs, slots)).sum(-1)


# ---------------------------------------------------------------------------
# the exact-phrase chain on doc-sorted posting slices: the plain version of
# K7 (int32 headers and 18-bit payloads)
# ---------------------------------------------------------------------------
def window_payloads(h, p, min_blk, max_blk, blk_bits: int):
    """Payloads with the words outside the block window zeroed (the words
    stay, as in take_term_planes); unchanged without a window."""
    if min_blk is None:
        return p
    blk = h & ((1 << blk_bits) - 1)
    return torch.where((blk >= min_blk) & (blk <= max_blk), p, 0)


def _same_term_words(h, p, cont_side: str):
    """The same-term bigram step on one list (lhs and rhs the same words):
    per word the adjusted count and the continuation payload.  The
    cross-block partner is the neighbouring word of the list itself."""
    counts, overlap = _same_counts_dense(p)
    if cont_side == "rhs":
        ph = F.pad(h[:-1], (1, 0), value=-2)
        adj = ((ph == h - 1) & ((_shift_up(p) >> _TOP) & p & 1).bool())
        cont = overlap | adj.to(p.dtype)
    else:
        nh = F.pad(h[1:], (0, 1), value=-2)
        adj = ((nh == h + 1) & ((p >> _TOP) & _shift_down(p) & 1).bool())
        cont = (p & (p >> 1)) | (adj.to(p.dtype) << _TOP)
    return counts + adj.to(torch.float32), cont


def _merge_words(bh, bp, oh, op, cont_side: str):
    """One bigram step of base words (bh, bp) against other words (oh,
    op), both sorted by unique header: per base word the match count and
    the continuation payload.  A lower bound of each base header in
    ``oh`` finds the same-header partner; the adjacent-block partner
    (header - 1 for ``rhs``, header + 1 for ``lhs``) is its neighbour."""
    A = oh.shape[0]
    if A == 0:
        inner = adjp = torch.zeros_like(bp)
    else:
        j = torch.searchsorted(oh, bh)
        jc = j.clamp(max=A - 1)
        hit = (j < A) & (oh[jc] == bh)
        inner = torch.where(hit, op[jc], 0)
        if cont_side == "rhs":
            k = (j - 1).clamp(min=0)
            ok = (j > 0) & (oh[k] == bh - 1)
        else:
            k = (j + hit).clamp(max=A - 1)
            ok = (j + hit < A) & (oh[k] == bh + 1)
        adjp = torch.where(ok, op[k], 0)
    if cont_side == "rhs":
        overlap = inner & (bp >> 1)
        adj = (adjp >> _TOP) & bp & 1
        cont = ((overlap << 1) & _LSB32) | adj
    else:
        overlap = bp & (inner >> 1)
        adj = (bp >> _TOP) & adjp & 1
        cont = overlap | (adj << _TOP)
    return _popcount_f32(overlap) + adj.to(torch.float32), cont


def per_query(value, Q: int, name: str) -> list:
    """A K7 argument that is one value for the launch or one per query, as
    a list of Q values."""
    if isinstance(value, (str, bool, np.bool_)):
        return [value] * Q
    out = list(value)
    if len(out) != Q:
        raise ValueError(f"{name} needs one entry per query")
    return out


def merge_step_plain(hdrs, base_pays, other_pays, base_off, base_n,
                     other_off, other_n, other_pay_off, *, cont_side,
                     same_term=False, blk_bits: int,
                     key_stride: int = 0, min_blk=None, max_blk=None):
    """Plain PyTorch K7: one bigram step of the sparse phrase chain for a
    chunk of queries (the arguments of ``ops/cuda/score.py:merge_step``;
    ``cont_side`` and ``same_term`` one value or one per query).  Returns
    (keys int32[M], counts f32[M], cont int32[M]) over the base words of
    all queries, query q's at the prefix offset of ``base_n``."""
    sides = per_query(cont_side, len(base_n), "cont_side")
    sames = per_query(same_term, len(base_n), "same_term")
    keys, counts, conts = [], [], []
    for q in range(len(base_n)):
        bo, bn = int(base_off[q]), int(base_n[q])
        if bn == 0:
            continue
        bh = hdrs[bo: bo + bn]
        bp = window_payloads(bh, base_pays[bo: bo + bn], min_blk, max_blk,
                             blk_bits)
        if sames[q]:
            c, cont = _same_term_words(bh, bp, sides[q])
        else:
            oo, on, po = int(other_off[q]), int(other_n[q]), int(
                other_pay_off[q])
            oh = hdrs[oo: oo + on]
            op = window_payloads(oh, other_pays[po: po + on], min_blk,
                                 max_blk, blk_bits)
            c, cont = _merge_words(bh, bp, oh, op, sides[q])
        keys.append((bh >> blk_bits) + q * key_stride)
        counts.append(c)
        conts.append(cont)
    if not keys:
        empty = hdrs.new_empty(0)
        return empty, empty.to(torch.float32), empty.clone()
    return (torch.cat(keys).to(torch.int32), torch.cat(counts),
            torch.cat(conts).to(torch.int32))


# ---------------------------------------------------------------------------
# candidate rows and mini-planes: the plain versions of K8a and K8b
# ---------------------------------------------------------------------------
def compact_rows_plain(keys, valid, Kc: int, num_docs: int, pops=None):
    """Run-compaction of one query's sorted doc keys (int32[n], ``valid``
    bool[n]): the plain version of K8a.  Returns (rows int32[Kc], the
    distinct valid keys in order and ``num_docs`` after them; cidx
    int32[n], each word's candidate index, the runs begun up to it less
    one; tf f32[Kc], the sum of ``pops`` over each run, or None without
    ``pops``).  Runs past ``Kc`` are dropped."""
    first = valid.clone()
    if keys.shape[0] > 1:
        first[1:] &= keys[1:] != keys[:-1]
    cidx = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    rows = torch.full((Kc + 1,), num_docs, dtype=torch.int32,
                      device=keys.device)
    rows.scatter_(0, torch.where(first & (cidx < Kc), cidx, Kc).long(),
                  keys.to(torch.int32))
    tf = None
    if pops is not None:
        dest = torch.where(valid & (cidx < Kc), cidx, Kc).long()
        tf = torch.zeros(Kc + 1, dtype=torch.float32, device=keys.device)
        tf = tf.index_add_(0, dest, pops.to(torch.float32))[:Kc]
    return rows[:Kc], cidx, tf


def minis_for_rows_plain(rows, slots, offs, ns, *, pool, hdrs, pays,
                         num_docs: int, blk_bits: int):
    """Per-term mini-planes over candidate row tables: the plain version of
    K8b.  ``rows`` is int32 [Q, Kc] (or [Kc], one table for every query);
    ``slots``/``offs``/``ns`` are host int [Q, T].  A term with a slot >= 0
    copies the ``2^blk_bits`` slots of each row from its plane-pool row
    (rows clipped to [0, num_docs)); any other term is zero but for the
    payloads of its posting slice ``[off, off + n)`` whose doc key is a
    row, stored at ``candidate << blk_bits | block`` (the rows of such a
    query ascending).  Returns int32 [Q * T, Kc << blk_bits]."""
    slots = np.asarray(slots, np.int64)
    Q, T = slots.shape
    S = 1 << blk_bits
    Kc = rows.shape[-1]
    table = rows.reshape(-1, Kc)
    out = torch.zeros((Q * T, Kc * S), dtype=torch.int32,
                      device=rows.device)
    spread = torch.arange(S, dtype=torch.int64, device=rows.device)
    for q in range(Q):
        rq = table[q if table.shape[0] > 1 else 0]
        for t in range(T):
            if Kc == 0:
                continue
            if slots[q, t] >= 0:
                flat = (rq.clamp(0, num_docs - 1).long()[:, None] * S
                        + spread[None, :]).reshape(-1)
                out[q * T + t] = pool[int(slots[q, t])][flat]
                continue
            o, n = int(offs[q][t]), int(ns[q][t])
            h = hdrs[o: o + n]
            keys = (h >> blk_bits).contiguous()
            ci = torch.searchsorted(rq.contiguous(), keys).clamp(max=Kc - 1)
            hit = rq[ci] == keys
            sidx = torch.where(hit, ci.long() * S + (h & (S - 1)), Kc * S)
            row = torch.zeros(Kc * S + 1, dtype=torch.int32,
                              device=rows.device)
            out[q * T + t] = row.scatter_(0, sidx, pays[o: o + n])[:Kc * S]
    return out


# ---------------------------------------------------------------------------
# slop coverage on doc-sorted posting slices: the plain version of K9.  Per
# anchor word, every distinct term's payloads at the headers h - C .. h + C
# are laid out as one bit raster of (2C + 1) * 18 positions; prefix sums
# over it count each term in every window, prefix sums over the windows
# that pass say which anchor positions one of them covers
# ---------------------------------------------------------------------------
SPAN_PLAIN_CHUNK = 1 << 16   # anchor words per pass: bounds the raster


def span_neighbourhood_plain(hdrs, pays, offs, ns, anchor: int, mults,
                             w: int, *, blk_bits: int, min_blk=None,
                             max_blk=None):
    """Plain PyTorch K9 for one query: per word of the anchor term (column
    ``anchor`` of the exact posting slices ``offs``/``ns``, one per
    distinct term) the doc key ``hdr >> blk_bits`` and the number of its
    set positions that lie in some window ``[s, s + w]`` holding at least
    ``mults[t]`` positions of every term t.  A term's word at header
    ``h + d`` counts only while ``block + d`` stays inside ``[0,
    2^blk_bits)``; ``min_blk``/``max_blk`` zero the payloads of words
    outside the block window first.  Returns (keys int32[A], counts
    f32[A])."""
    C = -(-w // LSB_BITS)
    blk_field = (1 << blk_bits) - 1
    device = hdrs.device
    sides = []
    for off, n in zip(offs, ns):
        h = hdrs[int(off): int(off) + int(n)]
        sides.append((h, window_payloads(h, pays[int(off): int(off) + int(n)],
                                         min_blk, max_blk, blk_bits)))
    a_hdr_all, a_pay_all = sides[anchor]
    deltas = torch.arange(-C, C + 1, dtype=torch.int32, device=device)
    bitpos = torch.arange(LSB_BITS, dtype=torch.int32, device=device)
    starts = LSB_BITS * C - w + torch.arange(w + LSB_BITS, device=device)
    m = torch.as_tensor(list(mults), dtype=torch.int32, device=device)
    counts = []
    for c0 in range(0, a_hdr_all.shape[0], SPAN_PLAIN_CHUNK):
        a_hdr = a_hdr_all[c0: c0 + SPAN_PLAIN_CHUNK]
        a_pay = a_pay_all[c0: c0 + SPAN_PLAIN_CHUNK]
        A = a_hdr.shape[0]
        blk = (a_hdr & blk_field)[:, None] + deltas[None, :]
        blk_ok = (blk >= 0) & (blk <= blk_field)
        targets = a_hdr[:, None] + deltas[None, :]
        lanes = []
        for t_hdr, t_pay in sides:
            if t_hdr.shape[0] == 0:
                lanes.append(torch.zeros_like(targets))
                continue
            i_c = torch.searchsorted(t_hdr, targets.reshape(-1)).reshape(
                targets.shape).clamp(max=t_hdr.shape[0] - 1)
            hit = (t_hdr[i_c] == targets) & blk_ok
            lanes.append(torch.where(hit, t_pay[i_c], 0))
        lanes = torch.stack(lanes, dim=1)                   # [A, T, 2C+1]
        bits = ((lanes[..., None] >> bitpos) & 1).reshape(A, len(sides), -1)
        prefix = F.pad(torch.cumsum(bits, dim=-1, dtype=torch.int32), (1, 0))
        cnt = prefix[..., starts + w + 1] - prefix[..., starts]
        ok = (cnt >= m[None, :, None]).all(dim=1)           # [A, w + 18]
        okc = F.pad(torch.cumsum(ok, dim=-1, dtype=torch.int32), (1, 0))
        any_win = okc[:, w + 1: w + 1 + LSB_BITS] > okc[:, :LSB_BITS]
        a_bits = ((a_pay[:, None] >> bitpos) & 1) == 1
        counts.append((a_bits & any_win).sum(dim=1).to(torch.float32))
    counts = (torch.cat(counts) if counts
              else torch.zeros(0, dtype=torch.float32, device=device))
    return (a_hdr_all >> blk_bits).to(torch.int32), counts
