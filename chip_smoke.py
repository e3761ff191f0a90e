"""Smoke test of the PyTorch/CUDA port (searcharray_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path once at the 1M-doc tier of bench.py (zipfian
corpus, ~30k vocabulary, 20-89 tokens per doc, seed 42), through the
entry points a user calls, and checks it:

1. environment: a CUDA device, torch/CUDA versions, the card's name and
   power limit;
2. build: the hand-written kernels K1 (csrc/score_term.cu), K2
   (csrc/segment_sum.cu), K3 (csrc/topk.cu), K4 (csrc/plane_fill.cu), K5
   (csrc/phrase_chain.cu), K6 (csrc/span_window.cu), K7
   (csrc/merge_step.cu), K8a (csrc/cand_rows.cu), K8b
   (csrc/cand_minis.cu), K9 (csrc/span_sparse.cu), K10
   (csrc/similarity.cu) and K11 (csrc/compose.cu) compile with nvcc for
   sm_90a;
3. main path, with every kernel launch counter set to 0 first:
   ``SearchArray.index(corpus, device="cuda")`` -> ``score`` ->
   ``topk`` -> ``score_batch(top_k=10)`` blocking and pipelined on
   terms; then exact phrases on the dense plane engine:
   ``score(phrase)``, ``termfreqs(phrase)`` and ``score_batch`` of terms
   and phrases mixed, three times (the phrase chain K5 on planes filled
   by K4, then the phrase-tf cache's promotion, whose rows K5 fills, then
   the cached rows), with phrases that repeat a term and one whose chain
   splits in two halves.  Each result is held to a numpy oracle computed
   from the host postings (phrase freqs exactly, scores to rtol 1e-6;
   BM25 in the JAX package's two-FMA form, ``oracle_bm25``).  Every
   similarity of the path is K10's, each launch held to
   ``similarity_plain`` bit for bit as it runs (``K10Recorder``).
   Every ranked group with whole rows and k up to 64 is the fused ranking
   pass (K3's selection with K10's function inside, ``rank_rows``), each
   launch held to ``rank_rows_plain`` bit for bit as it runs
   (``K8Recorder``); every other ranked result is K3's.  Then slop phrases on the dense planes
   (K6): three ``score_batch`` calls of bench.py's mixed request (120
   term and phrase queries and 24 slop-2 phrases, per-query ``slop``):
   the window groups, the promotion into tf-pool rows that K6 fills, the
   cached rows; ``score`` and ``termfreqs`` of each slop shape and of a
   repeated-term stopword phrase at the widest window (w = 17), held to
   an oracle that counts each term's positions per window by prefix
   sums.
   Then the same term ``score_batch`` on a 40k-doc index with one
   ~220k-token document, which is too large for dense planes and takes
   the sparse term group (K2).  Then the sparse phrase chain (K7, each
   step reduced by K2): on the 1M index every phrase with a position
   window (``score`` in positions 0-17, ``termfreqs`` in 18-53) and a
   40-term phrase (above K5's cap) through ``score`` and ``score_batch``;
   on the long-document index the serving mix of terms and phrases,
   blocking and ``block=False``.  Then slop phrases on the posting slices
   (K9, reduced by K2): at 1M docs ``score`` and ``termfreqs`` of every
   slop shape inside a position window, a phrase at slop 20 (a window of
   21 positions), a term three times, and one ``score_batch`` whose slop
   list sends some phrases to K6 and some to K9; on the long-document
   index the serving mix with bench.py's slop phrases, where every slop
   phrase takes K9.  Then Solr edismax: a title index (the first 8 tokens
   of each document) beside the body index in one dataframe, bench.py's
   configuration (``qf=["title^2", "body"], mm="2<75%", tie=0.1,
   pf=["title", "body"], pf2=["body"], top_k=10``) and the same with
   ``ps=2, ps2=1``, per query and as one ``edismax_batch``, held to a
   numpy composition of the oracle's scores (in the JAX package's
   rounding: the tie fold a fused multiply-add); and the same frame on
   the long-document corpus with ``ps=2``, whose phases run K7 and K9.
   The title index's postings are memory-mapped (``data_dir=``, a
   temporary directory).  Every edismax composition is K11's, each launch
   held to ``compose_plain`` bit for bit as it runs (``K11Recorder``).
   The candidate-subset engine (rare terms ``cterm``: K8a; rare phrases
   ``cphrase``/``cspan``: K8a, K8b, then K5 or K6 on the minis) and
   edismax's pruning (its exact phases scored only at the main query's
   matches where those are few: K8b's minis of the pooled planes there)
   are off at 1M docs by the port's thresholds and on by the JAX
   package's: the serving mix, ``topk`` of a rare term and the mixed
   request with slop record which group kinds ran on the default routing,
   the first two also at the JAX thresholds, as does edismax's first pass
   (cold grams); a forced phase (the engine's thresholds set to 0) sends
   rare terms, a phrase with a stopword co-term, a same-term phrase and
   slop phrases through ``score_batch`` ranked and dense and
   ``score_batch_device``, held to the oracle.  Every K8a and K8b launch
   of the main path, K5 and K6 on
   minis and K3 over a candidate axis are held to their plain versions
   bit for bit as they run (a stand-in for the modules' kernel module).
   The launch counts are read right after and every kernel must have
   run, K10 once for every similarity and K11 for every composition.
   Then this slice's path, counted the same way: the body index saved
   (``index/store.py``, format v3, into a temporary directory), loaded
   with memory maps and attached from the store's planes (a derivation
   raises), the serving mix and the term batch bit-equal to the
   in-memory index's; the memory-mapped title index pickled (its path,
   not its postings) and unpickled, edismax bit-equal to before; 1,000
   rows of a copy of the body index assigned new documents (some with new
   terms; by index, by a slice, and through a take view that repeats a
   row), the serving mix on the mutated index held to the oracle of its
   host postings, every mutated row's termfreqs exact, the original
   index unchanged.  Then doc-axis sharding on this card, counted the
   same way: a 4 x 2 mesh of the card (``parallel/sharded.py``, 4 doc
   shards of 250,000 docs, 2 query parts each), the body index's
   BuiltIndex partitioned and attached (``ShardedIndex.build``) and the
   title corpus indexed with ``mesh=``; every launch of K1-K9 there held
   to its plain version on the same inputs bit for bit as it runs
   (``PlainCheck``), K10 and K11 by their recorders; the serving mix, the term batch and the
   mixed request with slop through ``score_batch(top_k=10)`` (K3 on each
   shard's block, then K3 over the [Q, 4k] candidates), bit for bit equal
   to the unsharded index and held to the oracle; tf, phrase and slop
   freqs exact; ``rows=`` on 20,000 doc ids in random order; ``edismax``
   exact and with ``ps=2, ps2=1`` on the sharded frame, bit-equal to the
   unsharded frame's and held to the oracle (``edismax_batch`` takes its
   per-query form there); the long-document index on 4 shards (K2, K7,
   K9 per shard); ``save_shards`` and ``ShardedIndex.load``, the loaded
   planes ``torch.equal`` to the built ones.  Every K3 merge ranks at most
   4 x 10 candidates a query; every sharded call plans its batch once
   for all four shards (``search/batch.py:plan_batch``, then
   ``run_plan`` on each shard; ``sharded.PLANS`` counts one a call);
   sharded against unsharded qps in turns, and edismax p50; the host ms
   of one sharded serving-mix call's plan and of each shard's run.  Then
   the serving warm-up, counted and held the same way: a fresh attach of
   the body index warmed by ``warm_serving()`` (its launches read apart)
   and its first serving-mix call, and the first call on a second fresh
   attach as it is; then, not held, the first call timed on two more
   fresh attaches, as it is and after ``warm_serving()`` (its query count
   and seconds), and in two new processes.  Then concurrent queries,
   counted and held the same way: 8 threads, each with a serving mix, a
   mixed request with slop and an ``edismax(ps=2, ps2=1)`` of its own,
   on the default stream and each thread on a ``torch.cuda.Stream`` of
   its own, every result bit-equal to the same calls made serially; the
   profiler's kernel events of a threaded run equal to the wrappers'
   counts; then, not held, qps of each of the three from 1, 2, 4 and 8
   threads on both kinds of stream, every result held to the serial
   calls, beside the slot maps' hold time per call (``SlotMaps.held``)
   and the call's wall time;
4. the sparse term group (``batch._term_group_fn``, reduced by K2) on the
   1M-doc index, held to the dense ``dterm`` results; K2 on those groups'
   launches (each bucket's pad tail a run on the row's last slot) and on
   a control of as many keys spread uniformly, exactly equal to plain;
   the sparse phrase group (``phrase.sparse_chain_freqs``, K7 and K2,
   then ``batch._phrase_scores``) on the 1M-doc index, held exactly to
   the dense engine's results;
5. each kernel against its plain PyTorch version, on the card, at the
   shapes the main path gave it (K1 on the slices of its tf fills, one
   row and many rows per launch, K2 on the flat keys of the
   long-document batch, of the 1M sparse term group and of its uniform
   control, K4 on the batch's plane rows, K5 on each phrase
   group of the batch, on the serving mix's rare phrases and on tf-pool
   rows, K3 on the score blocks of a mixed request for k on both sides of
   its one-pass cap and of its sort cap, on a one-value row and on a
   [150, 1M] block with ties planted at both paths' tile edges, K6 on every window launch and tf-row fill of a
   mixed request, K7 on every step the windowed phrases and the
   long-document mix launched, K2 on those steps' keys, K9 on every
   launch of the windowed, wide and repeated-term slop phrases and of the
   long-document request, K2 on their keys), with their
   times: each kernel's own device time from ``torch.profiler``, the
   wrapper's time from CUDA events, the bytes its work needs and the
   bound they give (``ops/cuda/roofline.py``), the plain version's times
   and, for K2, one ``index_add_`` call's, for K3 one ``torch.topk``
   call's (the same values, not the tie order), for K8a one
   ``torch.unique_consecutive`` call's, for K8b the torch composition
   that builds both of its minis and, for its pooled half launched
   alone, the one gather of that half with its index arithmetic, for
   K10 (the similarity launches of a serving-mix call) and K11 (the
   composition launches of one edismax call, and of one edismax_batch)
   the torch composition each replaced, no single call computing it; K3
   also on the merge of one sharded serving-mix call; the fused ranking
   pass on one terms wave (99 tf-pool rows of the index by slot, k = 10),
   beside the route it replaced (the gather, K10 and K3; the parent's
   turns run it) and that route as torch ops; K3's
   device operations per call by the profiler's event count, and K10's
   launches in a profiled call against its counter;
6. evidence: timings, ``score_batch`` qps over several windows (terms;
   a serving mix of terms and phrases, with and without the 24 slop
   phrases; the long-document index, terms and the mix), a profile of
   one ``block=False`` serving call (its kernels by device time, and
   that nothing synchronises before ``collect()``, with a K9 query in the
   request too, and ``cterm`` queries in the serving mix) and of one
   edismax call, the serving mix, the mixed request with slop and
   edismax with the candidate engine and the phase pruning on (the JAX
   package's thresholds) and off (the port's) in turns (on, off, off, on,
   twice), ``hbm_report`` of the body index and a ``trace()`` of one
   ``block=False`` serving call (its Chrome trace names the kernels the
   profile showed), edismax latency and
   ``edismax_batch`` qps, a windowed phrase's latency and memory, each
   beside the card's name and power limit; the kernels line; the result
   line.

    python3 chip_smoke.py --parent-csrc DIR

also builds the kernel sources in DIR (an earlier version's
``searcharray_tpu_torch/csrc``) and times them in turns with the
current ones (old, new, new, old) at the same shapes, and takes the
long-document and serving-mix qps in the same turns.  A kernel the
earlier version lacks runs as it ran then (``with_lib``): without the
fused ranking pass, every ranked group by K10 then K3.

    python3 chip_smoke.py --parent-tree DIR

also runs the sharded driver of the checkout in DIR (an earlier
version's tree) and this tree's, each in a process of its own
(``SHARD_DRIVER``), on the same stores and mesh, checks that both rank
the serving mix as the main process does, and takes the sharded serving
mix, mixed request and edismax in turns (parent, new, new, parent,
twice).

Exits non-zero, before printing any result, without a CUDA device or
outside the repository.
"""
import argparse
import atexit
import contextlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_DOCS = 1_000_000
LONG_DOCS = 40_000
TOP_K = 10
DEVICE = "cuda"
WINDOWS = 5       # score_batch qps windows
HOT_CALLS = 25    # calls per hot window (~0.5 s on an H100)
COLD_CALLS = 10   # calls per cold window
MIX_CALLS = 10    # calls per serving-mix window
LONG_CALLS = 40   # calls per long-document window
LMIX_CALLS = 5    # calls per long-document serving-mix window
WIN_SCORE = dict(min_posn=0, max_posn=17)    # a title-sized window
WIN_FREQS = dict(min_posn=18, max_posn=53)   # the two blocks after it
# phrases beside bench.PHRASE_QUERIES: a repeated term in a left-to-right
# chain and in a right-to-left one, and a chain split in two halves at its
# rarest term ("purpose")
EXTRA_PHRASES = [["the", "the"], ["what", "is", "purpose", "purpose"],
                 ["is", "the", "purpose", "of", "the"]]
SLOP = 2                       # bench.py's slop phrases
WIDE_SLOP = (["the", "of", "the"], 15)   # w = 17, "the" twice
WIDER_SLOP = (["what", "purpose"], 20)   # w = 21: past the dense window
TRIPLE_SLOP = (["the", "the", "the"], 2)  # a term three times
# bench.py's edismax tier: its queries and its configuration
ED_QUERIES = ["what is the purpose", "star trek", "purpose of star",
              "what is w17", "w333 w4095", "star w5 trek", "the purpose of",
              "w1000 w2000 w3000", "what w42", "star trek purpose",
              "w7 w8 w9", "w100 w200"]
ED_KW = dict(qf=["title^2", "body"], mm="2<75%", tie=0.1,
             pf=["title", "body"], pf2=["body"])
ED_SLOP = dict(ps=2, ps2=1)
THREAD_COUNTS = (1, 2, 4, 8)   # the concurrent phase's client threads
THREAD_CALLS = 5               # calls of each thread per qps window
THREAD_DELAY_CYCLES = 20_000_000  # a slow reader's sleep after a fill
ED_CALLS = 10     # passes over ED_QUERIES per latency sample set, and calls
                  # per edismax_batch qps window
K3_RADIX_TILE = 16384          # elements of a row per block of K3's radix
                               # select (k above its one-pass cap)
# the forced candidate phase (the engine's thresholds set to 0): rare and
# mid-frequency terms, a phrase with a stopword co-term (a pool source), a
# same-term phrase, and slop-2 phrases with a stopword and a repeated term
FORCED_Q = ["w17", "w4095", ["the", "w1000"], ["w17", "w17"],
            ["w1000", "the"], ["w333", "of", "w333"]]
FORCED_SLOP = [0, 0, 0, 0, SLOP, SLOP]
CAND_CONSTS = ("CAND_MIN_DOCS", "CAND_TERM_MIN_DOCS", "CAND_MAX_FRAC")
# the JAX package's thresholds of the candidate engine and of edismax's
# phase pruning: both on at 1M docs, where the port's keep them off
# (search/candidates.py, solr.py)
JAX_CAND = {"CAND_MIN_DOCS": 1 << 19, "CAND_TERM_MIN_DOCS": 1 << 16}
JAX_PHASE_SUBSET_MIN_DOCS = 1 << 17
LSB18 = np.uint32((1 << 18) - 1)


# each kernel's device function names, as the profiler shows them
KERNEL_NAMES = {"K1": ("score_term_kernel",), "K2": ("segment_sum_kernel",),
                "K4": ("plane_fill_kernel",),
                "K5": ("chain_warp_kernel", "chain_tile_kernel",
                       "phrase_chain_kernel"),
                "K7": ("merge_step_kernel", "merge_join_kernel"),
                "K3": ("topk_tile_kernel", "topk_merge_kernel",
                       "topk_hist_kernel", "topk_select_kernel",
                       "topk_tiescan_kernel", "topk_filter_kernel",
                       "topk_sort_kernel", "topk_unpack_kernel"),
                "K6": ("span_window_kernel",),
                "K8a": ("cand_rows_count_kernel", "cand_rows_kernel"),
                "K8b": ("cand_minis_kernel",),
                "K9": ("span_sparse_kernel", "span_join_kernel"),
                "K10": ("similarity_kernel",),
                "K11": ("compose_tc_kernel", "compose_fc_kernel"),
                "K3+K10": ("rank_tile_kernel", "rank_merge_kernel")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"ok: {what}", flush=True)


def oracle_tf(post, tid, n_docs):
    """Per-doc tf from the host posting words: popcount, added by doc."""
    from searcharray_tpu_torch.ops import encoding as enc

    words = post.term_slice(tid)
    keys = enc.keys_of(words).astype(np.int64)
    pops = enc.popcount64(words & enc.LSB_MASK).astype(np.float64)
    return np.bincount(keys, weights=pops, minlength=n_docs).astype(np.float32)


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, in numpy: the float64 sum (the
    product of two float32 values is exact there) rounded to odd by its
    TwoSum error, then to nearest float32, which is correctly rounded."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64)
               for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    move = (e != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(move, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def oracle_bm25(tf, doc_lens, dfs, n_docs, avgdl, k1=1.2, b=0.75):
    """float32 BM25 (Lucene 9 form) rounded as the JAX package's programs
    round it: ``denom = fma(k1, fma(b, dl / avgdl, 1 - b), tf)``, every
    other operation once; the idf sums over every query term, in
    float64."""
    dfs = np.asarray(dfs, np.float64)
    idf = np.float32(np.sum(np.log1p((n_docs - dfs + 0.5) / (dfs + 0.5))))
    k1f, bf, avg = np.float32(k1), np.float32(b), np.float32(avgdl)
    tf = np.asarray(tf, np.float32)
    denom = fma32(k1f, fma32(bf, doc_lens / avg, np.float32(1.0) - bf), tf)
    return (tf / denom) * idf


# popcount of every 18-bit payload value, from the bits of its bytes
POP18 = np.unpackbits(np.arange(1 << 18, dtype=">u4").view(np.uint8)).reshape(
    -1, 32).sum(axis=1, dtype=np.int32)


def popcount_u32(x):
    """Popcount of 18-bit values (every payload, bigram and carry is one;
    a larger value raises IndexError)."""
    return POP18[x]


def oracle_plane(post, tid, n_docs, blk_bits):
    """A term's dense uint32[N << blk_bits] payload plane, from the host
    posting words (doc key | block | 18-bit bitmap)."""
    words = post.term_slice(tid)
    keys = (words >> np.uint64(36)).astype(np.int64)
    blks = ((words >> np.uint64(18)) & np.uint64(0x3FFFF)).astype(np.int64)
    plane = np.zeros(n_docs << blk_bits, np.uint32)
    plane[(keys << blk_bits) | blks] = (words & np.uint64(0x3FFFF)).astype(
        np.uint32)
    return plane


def oracle_plan(n, split):
    """The chain layout of the reference's compute_phrase_freqs
    (middle_out.py:154-168), as the JAX package's phrase._plan has it."""
    if split <= 1:
        return [("l2r", list(range(n)))]
    if split >= n - 2:
        return [("r2l", list(range(n)))]
    return [("l2r", list(range(split))), ("r2l", list(range(split, n)))]


def oracle_chain(planes, tags, direction, n_docs, slots):
    """Per-doc counts of each bigram step of one chain half, in numpy
    uint32, with the formulas of the JAX package's dense chain
    (searcharray_tpu/search/dense.py:494-555): shifts run over the flat
    slot axis."""
    top = np.uint32(17)
    one = np.uint32(1)
    up = lambda a: np.concatenate([np.zeros(1, a.dtype), a[:-1]])  # noqa: E731
    down = lambda a: np.concatenate([a[1:], np.zeros(1, a.dtype)])  # noqa: E731

    def same_counts(p):
        ov = p & ((p << one) & LSB18)
        consec = popcount_u32(ov & (ov << one) & LSB18)
        return popcount_u32(ov) - (consec + 1) // 2, ov

    out, carry = [], None
    order = (range(1, len(planes)) if direction == "l2r"
             else range(len(planes) - 2, -1, -1))
    for i in order:
        if direction == "l2r":
            R = planes[i]
            if carry is None and tags[i] == tags[i - 1]:
                counts, ov = same_counts(R)
                adj = (up(R) >> top) & R & one
                cont = ov | adj
            else:
                L = planes[i - 1] if carry is None else carry
                inner = L & (R >> one)
                adj = (up(L) >> top) & R & one
                counts = popcount_u32(inner)
                cont = ((inner << one) & LSB18) | adj
        else:
            L = planes[i]
            if carry is None and tags[i] == tags[i + 1]:
                counts, _ = same_counts(L)
                adj = (L >> top) & down(L) & one
                cont = (L & (L >> one)) | (adj << top)
            else:
                R = planes[i + 1] if carry is None else carry
                ov = L & (R >> one)
                adj = (L >> top) & down(R) & one
                counts = popcount_u32(ov)
                cont = ov | (adj << top)
        counts = counts + adj.astype(np.int32)
        out.append(counts.reshape(n_docs, slots).sum(axis=1))
        carry = cont
    return out


def oracle_words(post, tid, blk_bits, window=None):
    """A term's posting words as (int64 flat slots doc << blk_bits |
    block, uint32 bitmaps), the bitmaps outside the block window
    zeroed."""
    words = post.term_slice(tid)
    keys = (words >> np.uint64(36)).astype(np.int64)
    blks = ((words >> np.uint64(18)) & np.uint64(0x3FFFF)).astype(np.int64)
    pay = (words & np.uint64(0x3FFFF)).astype(np.uint32)
    if window is not None:
        pay = np.where((blks >= window[0]) & (blks <= window[1]), pay,
                       np.uint32(0))
    return (keys << blk_bits) | blks, pay


def oracle_chain_sparse(lists, tags, direction, n_docs, blk_bits):
    """``oracle_chain`` on (flat slots, bitmaps) lists instead of dense
    planes: the same formulas, evaluated only at the slots of the side a
    step's counts can be non-zero at, the other side's bitmap (at the
    slot, the one before or the one after) looked up by a numpy search.
    For indexes whose dense planes would not fit the host."""
    top, one = np.uint32(17), np.uint32(1)

    def at(side, slots):
        h, p = side
        if len(h) == 0:
            return np.zeros(len(slots), np.uint32)
        j = np.minimum(np.searchsorted(h, slots), len(h) - 1)
        return np.where(h[j] == slots, p[j], np.uint32(0))

    def same_counts(p):
        ov = p & ((p << one) & LSB18)
        consec = popcount_u32(ov & (ov << one) & LSB18)
        return popcount_u32(ov) - (consec + 1) // 2, ov

    out, carry = [], None
    order = (range(1, len(lists)) if direction == "l2r"
             else range(len(lists) - 2, -1, -1))
    for i in order:
        if direction == "l2r":
            h, R = lists[i]
            if carry is None and tags[i] == tags[i - 1]:
                counts, ov = same_counts(R)
                adj = (at(lists[i], h - 1) >> top) & R & one
                cont = ov | adj
            else:
                L = lists[i - 1] if carry is None else carry
                inner = at(L, h) & (R >> one)
                adj = (at(L, h - 1) >> top) & R & one
                counts = popcount_u32(inner)
                cont = ((inner << one) & LSB18) | adj
        else:
            h, L = lists[i]
            if carry is None and tags[i] == tags[i + 1]:
                counts, _ = same_counts(L)
                adj = (L >> top) & at(lists[i], h + 1) & one
                cont = (L & (L >> one)) | (adj << top)
            else:
                R = lists[i + 1] if carry is None else carry
                ov = L & (at(R, h) >> one)
                adj = (L >> top) & at(R, h + 1) & one
                counts = popcount_u32(ov)
                cont = ov | (adj << top)
        counts = counts + adj.astype(np.int32)
        out.append(np.bincount(h >> blk_bits, weights=counts,
                               minlength=n_docs)[:n_docs].astype(np.int64))
        carry = (h, cont)
    return out


_PLANES: dict = {}
_FREQS: dict = {}
_ORACLE: dict = {}
ORACLE_THREADS = 6              # threads of oracle_warm
DENSE_ORACLE_SLOTS = 1 << 24   # larger planes take the sparse oracle
RARE_ORACLE_WORDS = 1 << 14    # and so do phrases with a rarer term


def oracle_phrase_freqs(dev, terms, window=None, sparse=None):
    """Exact phrase freqs: the min over every chain step's per-doc count
    (not a positional match count: the two differ where the plan splits
    a phrase of four or more terms).  ``window`` is a (min_posn,
    max_posn) pair: bitmaps outside its blocks are zeroed first.  On
    dense planes, or (``sparse``; by default where the planes would pass
    DENSE_ORACLE_SLOTS or a term has fewer than RARE_ORACLE_WORDS words)
    on the posting lists.  Memoized per (index,
    phrase, window, form)."""
    if sparse is None:
        # a phrase with a rare term costs the posting-list form a few
        # searches, the dense form passes over whole planes
        rarest = min(int(dev.postings.lengths[dev.vocab.get_term_id(t)])
                     for t in terms)
        sparse = (dev.corpus_size << dev.blk_bits > DENSE_ORACLE_SLOTS
                  or rarest < RARE_ORACLE_WORDS)
    key = (id(dev), tuple(terms), window, sparse)
    if key not in _FREQS:
        _FREQS[key] = _oracle_phrase_freqs(dev, terms, window, sparse)
    return _FREQS[key]


def _oracle_phrase_freqs(dev, terms, window, sparse):
    n, bb = dev.corpus_size, dev.blk_bits
    tids = [dev.vocab.get_term_id(t) for t in terms]
    lengths = [int(dev.postings.lengths[t]) for t in tids]
    pattern = [tids.index(t) for t in tids]
    blocks = None if window is None else (window[0] // 18, window[1] // 18)
    if sparse:
        sides = {t: oracle_words(dev.postings, t, bb, blocks)
                 for t in set(tids)}
    else:
        for t in tids:
            if (id(dev), t) not in _PLANES:
                _PLANES[(id(dev), t)] = oracle_plane(dev.postings, t, n, bb)
        sides = {t: _PLANES[(id(dev), t)] for t in set(tids)}
        if blocks is not None:
            blk = np.arange(n << bb) & ((1 << bb) - 1)
            outside = (blk < blocks[0]) | (blk > blocks[1])
            sides = {t: np.where(outside, np.uint32(0), p)
                     for t, p in sides.items()}
    freqs = None
    for direction, idxs in oracle_plan(len(tids), int(np.argmin(lengths))):
        sub = [sides[tids[i]] for i in idxs]
        tags = [pattern[i] for i in idxs]
        steps = (oracle_chain_sparse(sub, tags, direction, n, bb) if sparse
                 else oracle_chain(sub, tags, direction, n, 1 << bb))
        for c in steps:
            freqs = c if freqs is None else np.minimum(freqs, c)
    return freqs.astype(np.float32)


def oracle_scores(dev, query, window=None, sparse=None, slop=0):
    """BM25 of one term, exact phrase or (``slop``) slop phrase over the
    corpus of a DeviceIndex, from its host postings (zeros for a
    vocabulary miss)."""
    terms = [query] if isinstance(query, str) else list(query)
    if len(terms) == 1:
        slop = 0   # a one-term query ignores it
    key = (id(dev), tuple(terms), window, sparse, slop)
    if key in _ORACLE:
        return _ORACLE[key]
    n = dev.corpus_size
    if any(t not in dev.vocab for t in terms):
        return np.zeros(n, np.float32)
    tids = [dev.vocab.get_term_id(t) for t in terms]
    if len(tids) == 1:
        tf = oracle_tf(dev.postings, tids[0], n)
    elif slop:
        tf = oracle_span_freqs(dev, terms, slop, window, sparse)
    else:
        tf = oracle_phrase_freqs(dev, terms, window, sparse)
    _ORACLE[key] = oracle_bm25(tf, dev.doc_lens_np,
                               [int(dev.doc_freqs[t]) for t in tids], n,
                               dev.avg_doc_length)
    return _ORACLE[key]


def oracle_positions(post, tid, window=None):
    """Every occurrence of a term as (doc int64[], position int64[]),
    in (doc, position) order, from the host posting words; with a
    (min_posn, max_posn) window only the occurrences in its blocks."""
    words = post.term_slice(tid)
    keys = (words >> np.uint64(36)).astype(np.int64)
    blks = ((words >> np.uint64(18)) & np.uint64(0x3FFFF)).astype(np.int64)
    pay = (words & np.uint64(0x3FFFF)).astype("<u4")
    if window is not None:
        keep = (blks >= window[0] // 18) & (blks <= window[1] // 18)
        keys, blks, pay = keys[keep], blks[keep], pay[keep]
    bits = np.unpackbits(pay.view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")[:, :18]
    word, bit = np.nonzero(bits)
    return keys[word], blks[word] * 18 + bit


def oracle_span_freqs_sparse(dev, terms, slop, window=None):
    """``oracle_span_freqs`` from position lists instead of rasters, for
    indexes whose dense planes would not fit the host: every occurrence
    becomes one number ``doc * P + position`` with P past the longest
    document plus a window, so no window reaches another document; a
    window's count of a term is a difference of two numpy searches; an
    anchor occurrence at p is covered when one of the starts p - w .. p
    passes."""
    n, bb = dev.corpus_size, dev.blk_bits
    tids = [dev.vocab.get_term_id(t) for t in terms]
    uniq = list(dict.fromkeys(tids))
    mults = [tids.count(t) for t in uniq]
    w = len(tids) + slop - 1
    anchor = uniq[int(np.argmin([int(dev.postings.lengths[t])
                                 for t in uniq]))]
    P = (18 << bb) + w + 2
    flat = {}
    for t in uniq:
        docs, posns = oracle_positions(dev.postings, t, window)
        flat[t] = docs * P + posns
    at = flat[anchor]
    covered = np.zeros(len(at), bool)
    for back in range(w + 1):
        start = at - back
        ok = np.ones(len(at), bool)
        for t, m in zip(uniq, mults):
            ok &= (np.searchsorted(flat[t], start + w, "right")
                   - np.searchsorted(flat[t], start, "left")) >= m
        covered |= ok
    return np.bincount(at // P, weights=covered,
                       minlength=n)[:n].astype(np.float32)


def oracle_span_freqs(dev, terms, slop, window=None, sparse=None):
    """Slop phrase freqs per doc: the anchor term's positions (the
    distinct term with the fewest posting words, the first of them) that
    lie in some window of w + 1 = n + slop positions holding every
    distinct term at least as often as the query names it.  Counted from
    each doc's positions: per term a prefix sum of its position raster
    gives every window's count; a prefix sum of the windows that pass
    gives, per anchor position, whether one of them covers it.  No
    dilation and no shift across slots.  ``window`` is a (min_posn,
    max_posn) pair: bitmaps outside its blocks are zeroed first.  On
    position lists instead (``oracle_span_freqs_sparse``) with ``sparse``,
    by default where the planes would pass DENSE_ORACLE_SLOTS.
    Memoized."""
    if sparse is None:
        sparse = dev.corpus_size << dev.blk_bits > DENSE_ORACLE_SLOTS
    key = (id(dev), tuple(terms), "slop", slop, window, sparse)
    if key in _FREQS:
        return _FREQS[key]
    if sparse:
        _FREQS[key] = oracle_span_freqs_sparse(dev, terms, slop, window)
        return _FREQS[key]
    n, bb = dev.corpus_size, dev.blk_bits
    S = 1 << bb
    tids = [dev.vocab.get_term_id(t) for t in terms]
    uniq = list(dict.fromkeys(tids))
    mults = [tids.count(t) for t in uniq]
    w = len(tids) + slop - 1
    anchor = uniq[int(np.argmin([int(dev.postings.lengths[t])
                                 for t in uniq]))]
    for t in uniq:
        if (id(dev), t) not in _PLANES:
            _PLANES[(id(dev), t)] = oracle_plane(dev.postings, t, n, bb)
    planes = {t: _PLANES[(id(dev), t)].reshape(n, S) for t in uniq}
    if window is not None:
        outside = np.ones(S, bool)
        outside[window[0] // 18: window[1] // 18 + 1] = False
        planes = {t: np.where(outside[None, :], np.uint32(0), p)
                  for t, p in planes.items()}
    has_all = np.ones(n, bool)
    for t in uniq:
        has_all &= planes[t].any(axis=1)
    docs = np.flatnonzero(has_all)   # only these can hold a window
    freqs = np.zeros(n, np.float32)
    L = S * 18
    for lo in range(0, len(docs), 1 << 16):
        d = docs[lo: lo + (1 << 16)]
        ok = np.ones((len(d), L), bool)
        for t, m in zip(uniq, mults):
            # the 18 position bits of every slot, as bytes of 0 and 1
            raster = np.unpackbits(
                planes[t][d].astype("<u4").view(np.uint8).reshape(
                    len(d), S, 4), axis=2, bitorder="little")[:, :, :18]
            raster = raster.reshape(len(d), L)
            if t == anchor:
                anchor_bits = raster.astype(bool)
            # csum[:, s] = occurrences before position s, the doc padded
            # with w + 1 empty positions
            csum = np.zeros((len(d), L + w + 2), np.int16)
            np.cumsum(raster, axis=1, dtype=np.int16, out=csum[:, 1: L + 1])
            csum[:, L + 1:] = csum[:, L: L + 1]
            ok &= csum[:, w + 1: w + 1 + L] - csum[:, :L] >= m
        # windows [s, s + w] that pass, s in [p - w, p], for position p
        osum = np.zeros((len(d), L + w + 1), np.int16)
        np.cumsum(ok, axis=1, dtype=np.int16, out=osum[:, w + 1:])
        covered = osum[:, w + 1:] != osum[:, :L]
        freqs[d] = (anchor_bits & covered).sum(axis=1)
    _FREQS[key] = freqs
    return freqs


def oracle_warm(dev, queries, slops=None, window=None, sparse=None):
    """Compute ``oracle_scores`` of every distinct query on a few threads
    (the oracles are numpy passes over whole arrays, which release the
    interpreter lock) and leave the results memoized for the checks that
    follow; ``slops`` is one slop for all or one per query."""
    from concurrent.futures import ThreadPoolExecutor

    slops = ([slops or 0] * len(queries) if slops is None
             or np.isscalar(slops) else list(slops))
    jobs = list(dict.fromkeys(
        (q if isinstance(q, str) else tuple(q), sl)
        for q, sl in zip(queries, slops)))
    with ThreadPoolExecutor(ORACLE_THREADS) as pool:
        list(pool.map(lambda j: oracle_scores(
            dev, j[0], window=window, sparse=sparse, slop=j[1]), jobs))


def oracle_edismax_warm(devs, queries, ps=0, ps2=0):
    """``oracle_warm`` for the scores ``oracle_edismax`` composes."""
    terms = [q.split() for q in queries]
    for f in ("title", "body"):
        oracle_warm(devs[f], [t for ts in terms for t in ts])
        oracle_warm(devs[f], [ts for ts in terms if len(ts) >= 2], ps)
    oracle_warm(devs["body"], [ts[i: i + 2] for ts in terms
                               for i in range(len(ts) - 1)], ps2)


def oracle_edismax(devs, q, ps=0, ps2=0, chain=True):
    """bench.py's edismax configuration (ED_KW) for one query, composed in
    numpy float32 from the oracle's scores, rounded as the JAX package's
    composers round it (``fma32`` for each fused multiply-add): per term
    the boosted title and body scores, their max ``mx`` and their sum
    ``sm`` (``fma(s_body, 1, fs_title)`` where ``chain``, as per-query
    edismax rounds it; one rounding, as edismax_batch does, otherwise),
    then ``fma(sm - mx, tie, mx)``; the terms summed in order where mm
    "2<75%" holds (every term up to two, three quarters rounded down
    above); pf on both fields (the whole query as a phrase, slop ``ps``)
    and pf2 on the body (every bigram, the final one twice, slop
    ``ps2``), added where the main query matched.  ``devs`` maps "title"
    and "body" to their DeviceIndex."""
    f32 = np.float32
    terms = q.split()
    n = devs["body"].corpus_size
    if not terms:
        return np.zeros(n, f32)
    tie = f32(ED_KW["tie"])
    total = np.zeros(n, f32)
    hits = np.zeros(n, np.int32)
    for t in terms:
        st, sb = oracle_scores(devs["title"], t), oracle_scores(devs["body"], t)
        ft, fb = st * f32(2.0), sb * f32(1.0)
        mx = np.maximum(ft, fb)
        sm = fma32(sb, f32(1.0), ft) if chain else ft + fb
        ts = fma32(sm - mx, tie, mx)
        hits += ts > 0
        total = total + ts
    need = len(terms) if len(terms) <= 2 else len(terms) * 75 // 100
    qf = np.where(hits >= need, total, f32(0.0))
    extra = np.zeros(n, f32)
    if len(terms) >= 2:
        for f in ("title", "body"):
            extra = extra + oracle_scores(devs[f], terms, slop=ps)
        grams = [terms[i: i + 2] for i in range(len(terms) - 1)]
        for gram in grams + grams[-1:]:
            extra = extra + oracle_scores(devs["body"], gram, slop=ps2)
    return qf + np.where(qf > 0, extra, f32(0.0))


ED_REL_ERR = [0.0]   # the largest relative error the edismax checks saw


def rel_err(got, want):
    """The largest relative difference of ``got`` from ``want`` (0 where
    both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    err = float(np.max(np.where(got == want, 0.0, err), initial=0.0))
    ED_REL_ERR[0] = max(ED_REL_ERR[0], err)
    return err


def check_edismax(devs, queries, ranked, what, k, chain=True, **slops):
    """Ranked edismax results against ``oracle_edismax`` (``chain``: in
    per-query edismax's form, else in edismax_batch's): the scores
    within rtol 1e-6 of the oracle's k best (the port composes as the
    oracle does; the phase sums add in another order), and every
    returned doc's oracle score within the same of its returned score
    (so docs that tie may come in either order)."""
    oracle_edismax_warm(devs, queries, **slops)
    for q, (scores, idx) in zip(queries, ranked):
        want = oracle_edismax(devs, q, chain=chain, **slops)
        best = want[oracle_topk(want, k)]
        rel_err(scores, best)
        rel_err(scores, want[idx])
        if not (scores.shape == (k,) and np.all(np.isfinite(scores))
                and np.allclose(scores, best, rtol=1e-6, atol=1e-6)
                and np.allclose(want[idx], scores, rtol=1e-6, atol=1e-6)):
            raise AssertionError(f"{what}: edismax({q!r}) differs from the "
                                 "oracle")
    check(len(ranked) == len(queries),
          f"{what} agrees with the numpy composition of the oracle on "
          f"{len(queries)} queries")


def oracle_topk(scores, k):
    """Top-k by (-score, index), the smallest-index tie rule.  With k or
    more positive scores the top k are among them, so only those are
    ranked (a rare term's few docs instead of the whole corpus)."""
    pool = np.flatnonzero(scores > 0)
    if len(pool) < k:
        pool = np.arange(len(scores))
    sub = scores[pool]
    kth = np.partition(sub, len(sub) - k)[len(sub) - k]
    cand = pool[sub >= kth]
    order = np.lexsort((cand, -scores[cand]))[:k]
    return cand[order]


def check_ranking(dev, terms, scores, idx, what, sparse=None, slops=None):
    """Top-k scores within rtol 1e-6 of the oracle's, indices equal
    wherever the k-th score is > 0 (below it the zero tail ties).
    ``terms`` are the queries: terms or phrases, with ``slops`` one slop
    each."""
    slops = [0] * len(terms) if slops is None else slops
    oracle_warm(dev, terms, slops, sparse=sparse)
    for term, slop, got_s, got_i in zip(terms, slops, scores, idx):
        want = oracle_scores(dev, term, sparse=sparse, slop=slop)
        want_i = oracle_topk(want, len(got_i))
        if not np.allclose(got_s, want[want_i], rtol=1e-6, atol=0):
            raise AssertionError(f"{what}: top-k scores of {term!r} differ")
        if want[want_i[-1]] > 0 and not np.array_equal(got_i, want_i):
            raise AssertionError(f"{what}: top-k indices of {term!r} differ")
    check(len(terms) == len(scores),
          f"{what} agrees with the numpy oracle on {len(terms)} queries")


def k2_inputs(dev, offs, ns, bucket):
    """(flat keys, values, num_docs) of the K2 launch of one sparse term
    group: the posting slices ``offs``/``ns`` in one bucket, built as
    ``batch._term_group_fn`` builds them (each row's pad tail clamped onto
    its last slot, values 0)."""
    from searcharray_tpu_torch.search import batch

    keys, pops = batch._slice_keys(dev.hdrs, dev.pays, offs, ns, bucket,
                                   dev.blk_bits)
    Npad = batch._npad(dev.corpus_size)
    return (batch._flat_keys(keys, len(offs), Npad),
            pops.reshape(-1).contiguous(), len(offs) * Npad)


def long_doc_segment_sums(ldev, terms):
    """The inputs of every K2 launch ``score_batch`` makes for ``terms`` on
    an index that is not dense-eligible, by ascending bucket."""
    from searcharray_tpu_torch.search import batch

    tids = [[ldev.vocab.get_term_id(t)] for t in terms if t in ldev.vocab]
    groups = batch._classify(ldev, tids, "bm25")
    calls = []
    for (kind, bucket), rows in sorted(groups.items()):
        assert kind == "term", kind
        calls.append(k2_inputs(ldev, [r[1][0, 0] for r in rows],
                               [r[2][0, 0] for r in rows], bucket))
    return calls


def spread_like(calls, seed=4):
    """A control for K2 launches: for each (flat keys, values, num_docs),
    as many keys, spread uniformly over the slots (sorted, so runs are
    short), with integer values 0-17."""
    import torch

    out = []
    for flat, _, n_out in calls:
        g = torch.Generator(device=flat.device)
        g.manual_seed(seed + len(out))
        ids = torch.randint(0, n_out, (flat.numel(),), generator=g,
                            device=flat.device, dtype=torch.int32)
        vals = torch.randint(0, 18, (flat.numel(),), generator=g,
                             device=flat.device).to(torch.float32)
        out.append((torch.sort(ids).values, vals, n_out))
    return out


def longest_run(ids) -> int:
    import torch

    return int(torch.unique_consecutive(ids, return_counts=True)[1].max())


def cuda_ms(fn, iters=50):
    """Wrapper time: the mean time of ``fn`` over ``iters`` back-to-back
    calls between two CUDA events.  Where a kernel is shorter than the
    host's work per call (checks, allocation, ctypes, copies of index
    arrays), this is the host's enqueue rate, not the kernel's time."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class DeviceTimer:
    """Device time per call of a function, from ``torch.profiler``: the
    summed self device time of the kernels whose names hold one of
    ``names`` (of all device work when None) over ``iters`` calls.  With
    ``flush``, a read of a 64 MB buffer (more than the 50 MB L2; a read,
    so that no dirty line is left for the call to write back) runs before
    each call, so the call finds its inputs in device memory as a fresh
    request does; the read's own kernels are not counted.  With
    ``counter`` (the wrappers' launch count), the profiled run must show
    as many of the kernels as the wrappers launched, or it is run again:
    the profiler has been seen to drop events."""

    def __init__(self, device):
        import torch

        self.buf = torch.ones(64 << 20, dtype=torch.uint8, device=device)
        self.flush_keys = set()
        self.flush_keys = {k for k, _, _ in self._profile(self._flush, 1)}

    def _flush(self):
        self.buf.max()

    def _profile(self, fn, iters, flush=False):
        """(kernel name, self device us, count) of every device event."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush:
                    self._flush()
                fn()
            torch.cuda.synchronize()
        return [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.key not in self.flush_keys]

    def __call__(self, fn, iters=20, names=None, flush=False,
                 counter=None, attempts=4):
        """(device ms per call, matched kernel launches per call)."""
        import torch

        fn()
        torch.cuda.synchronize()
        for _ in range(attempts):
            before = counter() if counter else 0
            events = [e for e in self._profile(fn, iters, flush)
                      if names is None or any(n in e[0] for n in names)]
            us, seen = sum(e[1] for e in events), sum(e[2] for e in events)
            launched = counter() - before if counter else seen
            if us > 0 and seen == launched:
                return us / 1e3 / iters, seen / iters
            print(f"profiler: {seen} of {launched} launches of "
                  f"{names or 'the call'} seen; profiling again", flush=True)
        raise AssertionError(f"the profiler did not see every launch of "
                             f"{names or 'the call'}")


@contextlib.contextmanager
def thresholds(cand, solr, cand_values, phase_min=None):
    """The candidate engine's thresholds (``cand_values``) and edismax's
    pruning threshold (``phase_min``, unless None) set for a block; the
    port's restored after."""
    saved = {c: getattr(cand, c) for c in cand_values}
    saved_phase = solr.PHASE_SUBSET_MIN_DOCS
    try:
        for c, v in cand_values.items():
            setattr(cand, c, v)
        if phase_min is not None:
            solr.PHASE_SUBSET_MIN_DOCS = phase_min
        yield
    finally:
        for c, v in saved.items():
            setattr(cand, c, v)
        solr.PHASE_SUBSET_MIN_DOCS = saved_phase


def forget_phrase_rows(dev):
    """Empty the phrase-tf cache of an index: its cached phrase rows, their
    fill recipes and their hit counts (the term rows stay)."""
    for key in [k for k in dev.maps.tf_slot if isinstance(k, tuple)]:
        dev.maps.tf_free.append(dev.maps.tf_slot.pop(key))
    dev.maps.phrase_hits.clear()
    dev.maps.phrase_recipes.clear()


# The sharded driver of a checkout, run in a process of its own from that
# checkout (``--parent-tree``: an earlier version, whose package has this
# one's name; and this tree, so both sides of the turns run alike).  It
# loads the body and title stores this run saved, shards them on the
# same mesh of the card and answers commands on its standard input, one
# JSON line each: "mix" / "req" (queries/s of 5 ranked calls of the
# serving mix / the mixed request with slop), "ed" (ms of one edismax call
# per query), "check" (the serving mix's ranking), "quit".
SHARD_DRIVER = r"""
import json, sys, time
import numpy as np
import pandas as pd
import torch
from searcharray_tpu_torch import SearchArray, edismax
from searcharray_tpu_torch.index import store
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.pandas_ext.array import _IndexState
from searcharray_tpu_torch.parallel import sharded

spec = json.load(open(sys.argv[1]))
t0 = time.perf_counter()
kc.build()
mesh = sharded.default_mesh(devices=[torch.device("cuda")] * spec["devices"])
frame = {}
for field, directory in spec["stores"].items():
    built = store.load_index(directory, mmap=True)
    col = SearchArray([], device="cuda")
    col._attach(_IndexState(built, "cuda"))
    col._state.sharded = sharded.ShardedIndex.build(built, mesh=mesh)
    frame[field] = col
df = pd.DataFrame(frame)
body = frame["body"]


def calls(name, n):
    q, s = spec[name]
    t0 = time.perf_counter()
    for _ in range(n):
        out = body.score_batch(q, top_k=spec["k"], slop=s)
    return n * len(q) / (time.perf_counter() - t0), out


def ed():
    ms = []
    for q in spec["ed"]:
        t0 = time.perf_counter()
        edismax(df, q=q, top_k=spec["k"], **spec["ed_kw"])
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


for _ in range(3):   # the pools' fills and the phrase-tf cache's promotions
    calls("mix", 1), calls("req", 1), ed()
print(json.dumps({"ready": time.perf_counter() - t0}), flush=True)
for line in sys.stdin:
    cmd = line.strip()
    if cmd in ("mix", "req"):
        print(json.dumps(calls(cmd, 5)[0]), flush=True)
    elif cmd == "ed":
        print(json.dumps(ed()), flush=True)
    elif cmd == "check":
        v, i = calls("mix", 1)[1]
        print(json.dumps([v.view(np.int32).tolist(), i.tolist()]),
              flush=True)
    else:
        break
"""

# The first serving-mix call of a new process on the body store, as it is
# or after ``warm_serving()``: the process builds (or finds) the kernel
# library, attaches the store and prints one JSON line.
FIRST_CALL = r"""
import json, sys, time
import numpy as np
import torch
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.index import store
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.pandas_ext.array import _IndexState

spec = json.load(open(sys.argv[1]))
kc.build()
arr = SearchArray([], device="cuda")
arr._attach(_IndexState(store.load_index(spec["store"], mmap=True), "cuda"))
arr.dev
torch.cuda.synchronize()
out = {"warm_queries": None, "warm_s": None}
if spec["warm"]:
    t0 = time.perf_counter()
    out["warm_queries"] = arr.warm_serving()
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
t0 = time.perf_counter()
v, i = arr.score_batch(spec["mix"], top_k=spec["k"])
out["first_ms"] = (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
arr.score_batch(spec["mix"], top_k=spec["k"])
out["second_ms"] = (time.perf_counter() - t0) * 1e3
out["idx"] = i.tolist()
out["bits"] = np.asarray(v, np.float32).view(np.int32).tolist()
print(json.dumps(out), flush=True)
"""


def run_snippet(code, tree, spec, spec_path, timeout=None):
    """``code`` in a new process of the checkout ``tree`` (its package
    first on the path), given ``spec`` as a JSON file: the process."""
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return subprocess.Popen(
        [sys.executable, "-c", code, spec_path], cwd=tree,
        env={**os.environ, "PYTHONPATH": os.path.abspath(tree)},
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def json_line(proc):
    """The next JSON line ``proc`` prints (other lines are echoed)."""
    while True:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"a driver process exited (code "
                               f"{proc.wait()})")
        try:
            return json.loads(line)
        except ValueError:
            print(f"driver: {line.rstrip()}", flush=True)


class ShardDriver:
    """The process of ``SHARD_DRIVER`` in the checkout ``tree``; stopped
    by ``close`` (and at exit)."""

    def __init__(self, tree, spec, spec_path):
        self.proc = run_snippet(SHARD_DRIVER, tree, spec, spec_path)
        atexit.register(self.close)
        self.ready_s = None

    def ask(self, cmd):
        if self.ready_s is None:
            self.ready_s = json_line(self.proc)["ready"]
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return json_line(self.proc)

    def close(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=60)
            except Exception:
                self.proc.kill()
                self.proc.wait()


class K8Recorder:
    """The kernel module as search/batch.py, search/candidates.py and
    search/dense.py see it during the main path.  Every K8a and K8b launch
    is held to its plain version on the same inputs as it runs, bit for
    bit, and noted; so are K5 and K6 on mini-planes (the pool they read is
    a K8b output), K3 over a candidate axis (rows narrower than the
    corpus) and every launch of the fused ranking pass (``rank_rows``,
    "K3+K10").  Nothing else changes."""

    def __init__(self, kc, num_docs, blk_bits):
        self.kc, self.n, self.bb = kc, num_docs, blk_bits
        self.k8a, self.k8b = [], []
        # the largest absolute difference from the plain version seen
        self.err = {"K8a": 0.0, "K8b": 0.0, "K3+K10": 0.0}
        self.minis = {}   # K8b outputs not yet read by K5 or K6, by id
        self.checked = {"K5 on minis": 0, "K6 on minis": 0,
                        "K3 over Kc": 0, "K3+K10": 0}
        self.rank_shapes = set()

    def __getattr__(self, name):
        return getattr(self.kc, name)

    def _same(self, got, want, what):
        import torch

        for g, w in zip(got, want):
            if (g is None) != (w is None):
                raise AssertionError(f"{what} differs from its plain version")
            if g is None:
                continue
            if g.numel():
                err = float((g.double() - w.double()).abs().max())
                if what in self.err:
                    self.err[what] = max(self.err[what], err)
            if not torch.equal(g, w):
                raise AssertionError(f"{what} differs from its plain version")

    def cand_rows(self, *a, **kw):
        got = self.kc.cand_rows(*a, **kw)
        self._same(got, self.kc.cand_rows_plain(
            a[0], a[1], np.asarray(a[2]), np.asarray(a[3]), a[4], **kw), "K8a")
        self.k8a.append((a, kw))
        return got

    def cand_minis(self, rows, slots, offs, ns, **kw):
        got = self.kc.cand_minis(rows, slots, offs, ns, **kw)
        self._same([got], [self.kc.minis_for_rows_plain(
            rows, np.asarray(slots), offs, ns, **kw)], "K8b")
        self.k8b.append(((rows, slots, offs, ns), kw))
        self.minis[id(got)] = got
        return got

    def _minis(self, pool):
        return self.minis.pop(id(pool), None) is pool

    def phrase_chain(self, pool, *a, **kw):
        got = self.kc.phrase_chain(pool, *a, **kw)
        if self._minis(pool):
            self._same([got], [self.kc.phrase_chain_plain(pool, *a, **kw)],
                       "K5 on minis")
            self.checked["K5 on minis"] += 1
        return got

    def span_window(self, pool, *a, **kw):
        got = self.kc.span_window(pool, *a, **kw)
        if self._minis(pool):
            self._same([got], [self.kc.span_window_plain(pool, *a, **kw)],
                       "K6 on minis")
            self.checked["K6 on minis"] += 1
        return got

    def topk(self, x, k):
        vals, idx = self.kc.topk(x, k)
        if x.shape[-1] != self.n:
            want_v, want_i = self.kc.topk_plain(x, k)
            self._same([idx.long(), vals.view(want_v.dtype)],
                       [want_i, want_v], "K3 over Kc")
            self.checked["K3 over Kc"] += 1
        return vals, idx

    def rank_rows(self, kind, src, slots, doc_lens, idfs, avgdl, k1, b, k):
        import torch

        vals, idx = self.kc.rank_rows(kind, src, slots, doc_lens, idfs,
                                      avgdl, k1, b, k)
        want_v, want_i = self.kc.rank_rows_plain(kind, src, slots, doc_lens,
                                                 idfs, avgdl, k1, b, k)
        if vals.numel():
            self.err["K3+K10"] = max(self.err["K3+K10"], float(
                (vals.double() - want_v.double()).abs().nan_to_num(0.0).max()))
        if not (torch.equal(idx.long(), want_i) and torch.equal(
                vals.view(torch.int32), want_v.view(torch.int32))):
            raise AssertionError("K3+K10 differs from its plain version")
        self.checked["K3+K10"] += 1
        self.rank_shapes.add((kind, int(idx.shape[0]), int(src.shape[1]), k,
                              slots is not None))
        return vals, idx


def torch_similarity(kind, tfs, doc_lens, idf, avgdl, k1, b, out=None):
    """The similarity as torch ops, each rounded once: what the port ran
    before K10 (the parent's turns take it), and K10's yardstick."""
    import torch

    k1f, bf = np.float32(k1), np.float32(b)
    if torch.is_tensor(idf) and tfs.dim() == 2:
        idf = idf.reshape(-1, 1)
    elif not torch.is_tensor(idf):
        idf = float(np.float32(idf))
    if kind == "classic":
        got = idf * torch.sqrt(tfs) / torch.sqrt(doc_lens)
    else:
        avgdl_t = doc_lens.new_full((), float(np.float32(avgdl)))
        norm = float(k1f) * (float(np.float32(1.0) - bf)
                             + float(bf) * (doc_lens / avgdl_t))
        if kind == "bm25":
            got = (tfs / (tfs + norm)) * idf
        elif kind == "bm25_legacy":
            got = idf * ((tfs * float(k1f + np.float32(1.0)))
                         / (tfs + norm))
        else:
            got = tfs / (tfs + norm)
    return got if out is None else out.copy_(got)


def never_fused(top_k):
    """``dense.fuses`` on the route the fused ranking pass replaced: every
    ranked group by K10 then K3."""
    return False


class K10Recorder:
    """K10's wrapper as apply_similarity_device finds it during the main
    path: every launch is held to ``similarity_plain`` on the same inputs
    (computed first: the launch may overwrite its input) bit for bit, and
    counted.  The wrapper's own counter names the module's ``similarity``,
    which is this object while it stands in, so ``launches`` here counts
    the kernel's launches."""

    def __init__(self, kc):
        self.kc, self.orig = kc, kc.similarity
        self.launches, self.calls, self.err = 0, 0, 0.0
        self.shapes = set()
        self.lock = threading.Lock()

    def __call__(self, kind, tfs, doc_lens, idf, avgdl, k1, b, out=None):
        import torch

        t2 = tfs.reshape(1, -1) if tfs.dim() == 1 else tfs
        i = idf.reshape(-1, 1) if torch.is_tensor(idf) else idf
        want = self.kc.similarity_plain(kind, t2, doc_lens.reshape(
            -1, t2.shape[1]), i, avgdl, k1, b).reshape(tfs.shape)
        got = self.orig(kind, tfs, doc_lens, idf, avgdl, k1, b, out=out)
        err = (float((got.double() - want.double()).abs().max())
               if got.numel() else 0.0)
        with self.lock:
            self.calls += 1
            self.shapes.add((kind, tuple(tfs.shape), doc_lens.numel()
                             == tfs.numel() and tfs.dim() == 2))
            self.err = max(self.err, err)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"K10 {kind} on {tuple(tfs.shape)} differs "
                                 "from similarity_plain")
        return got


def torch_compose(stacks, boosts, tie, msm, *, term_centric, chain=True,
                  out=None):
    """edismax's composition as torch ops, each rounded once: what the
    port ran before K11 (the parent's turns take it), and K11's
    yardstick."""
    import torch

    bs = [float(np.float32(b)) for b in boosts]
    tie = float(np.float32(tie))
    if term_centric:
        fs = torch.stack([s * b for s, b in zip(stacks, bs)])
        mx = fs.max(dim=0).values
        ts = mx + (fs.sum(dim=0) - mx) * tie
        got = torch.where((ts > 0).sum(dim=0) >= msm, ts.sum(dim=0), 0.0)
    else:
        sums = torch.stack([torch.where((ts > 0).sum(dim=0) >= m,
                                        ts.sum(dim=0), 0.0) * b
                            for ts, b, m in zip(stacks, bs, msm)])
        mx = sums.max(dim=0).values
        got = mx + (sums.sum(dim=0) - mx) * tie
    return got if out is None else out.copy_(got)


class K11Recorder:
    """K11's wrapper as compose_device finds it during a counted path:
    every launch is held to ``compose_plain`` on the same inputs (on the
    card; it adds the rows one at a time, so it rounds as the CPU does)
    bit for bit, and counted (the wrapper's counter names the module's
    ``compose``, which is this object while it stands in)."""

    def __init__(self, kc):
        self.kc, self.orig = kc, kc.compose
        self.launches, self.calls, self.err = 0, 0, 0.0
        self.shapes = set()
        self.lock = threading.Lock()

    def __call__(self, stacks, boosts, tie, msm, *, term_centric,
                 chain=True, out=None):
        import torch

        want = self.kc.compose_plain(stacks, boosts, tie, msm,
                                     term_centric=term_centric, chain=chain)
        got = self.orig(stacks, boosts, tie, msm, term_centric=term_centric,
                        chain=chain, out=out)
        err = (float((got.double() - want.double()).abs().max())
               if got.numel() else 0.0)
        with self.lock:
            self.calls += 1
            self.shapes.add((term_centric, chain,
                             tuple(int(s.shape[0]) for s in stacks)))
            self.err = max(self.err, err)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(
                f"K11 on {[tuple(s.shape) for s in stacks]} (term-centric "
                f"{term_centric}, chain {chain}) differs from compose_plain")
        return got


class PlainCheck:
    """The kernel module as the engine's modules see it during a counted
    path: every launch of K1-K9 is held to its plain version on the same
    inputs, on the card, bit for bit, as it runs, and noted by kernel and
    shape.  An in-place launch's rows are read back and held to its plain
    version written into rows of their own; K7's continuations are held on
    the words whose query asked for them.  The wrappers count their own
    launches as ever, and the plain versions launch no kernel of the port.
    While ``on``, K3 notes the width of every block it ranks and keeps a
    copy of each block at most ``narrow`` wide (a merge)."""

    def __init__(self, kc, narrow):
        self.kc, self.narrow = kc, narrow
        self.err, self.calls = Counter(), Counter()
        self.shapes = {}
        self.on, self.widths, self.merges = False, [], []
        self.lock = threading.Lock()   # threads launch through it at once

    def __getattr__(self, name):
        return getattr(self.kc, name)

    def _same(self, name, shape, got, want):
        import torch

        err = 0.0
        for g, w in zip(got, want):
            if g.numel():   # (-inf pads of a merge: equal, no difference)
                err = max(err, float(
                    (g.double() - w.double()).abs().nan_to_num(0.0).max()))
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g, w):
                raise AssertionError(f"{name} on {shape} differs from its "
                                     "plain version")
        with self.lock:
            self.calls[name] += 1
            self.shapes.setdefault(name, set()).add(shape)
            self.err[name] = max(self.err[name], err)

    def _rows(self, out, rows):
        import torch

        return out[torch.as_tensor(np.asarray(rows, np.int64),
                                   device=out.device)]

    def score_term(self, *a, out=None, **kw):
        got = self.kc.score_term(*a, out=out, **kw)
        self._same("K1", (a[0].numel(), kw["num_docs"]), [got],
                   [self.kc.score_term_plain(*a, **kw)])
        return got

    def score_term_rows(self, hdrs, pays, offs, ns, out, out_rows, **kw):
        import torch

        got = self.kc.score_term_rows(hdrs, pays, offs, ns, out, out_rows,
                                      **kw)
        R = len(out_rows)
        want = self.kc.score_term_rows_plain(
            hdrs, pays, np.asarray(offs, np.int64), np.asarray(ns, np.int64),
            torch.empty((R, kw["num_docs"]), dtype=torch.float32,
                        device=out.device), np.arange(R), **kw)
        self._same("K1 rows", (R, kw["num_docs"]),
                   [self._rows(out, out_rows)], [want])
        return got

    def segment_sum(self, ids, values, *, num_docs):
        got = self.kc.segment_sum(ids, values, num_docs=num_docs)
        self._same("K2", (ids.numel(), num_docs), [got],
                   [self.kc.segment_sum_plain(ids, values,
                                              num_docs=num_docs)])
        return got

    def topk(self, x, k):
        vals, idx = self.kc.topk(x, k)
        if self.on:
            self.widths.append(int(x.shape[-1]))
            if x.shape[-1] <= self.narrow * k:
                self.merges.append((x.clone(), k))
        want_v, want_i = self.kc.topk_plain(x, k)
        self._same("K3", (tuple(x.shape), k), [idx.long(), vals],
                   [want_i, want_v])
        return vals, idx

    def rank_rows(self, kind, src, slots, doc_lens, idfs, avgdl, k1, b, k):
        vals, idx = self.kc.rank_rows(kind, src, slots, doc_lens, idfs,
                                      avgdl, k1, b, k)
        want_v, want_i = self.kc.rank_rows_plain(kind, src, slots, doc_lens,
                                                 idfs, avgdl, k1, b, k)
        self._same("K3+K10", (kind, int(idx.shape[0]), int(src.shape[1]),
                              k), [idx.long(), vals], [want_i, want_v])
        return vals, idx

    def plane_fill(self, hdrs, pays, offs, ns, slots, pool):
        import torch

        got = self.kc.plane_fill(hdrs, pays, offs, ns, slots, pool)
        R = len(slots)
        want = self.kc.plane_fill_plain(
            hdrs, pays, np.asarray(offs, np.int64), np.asarray(ns, np.int64),
            np.arange(R), torch.empty((R, pool.shape[1]), dtype=torch.int32,
                                      device=pool.device))
        self._same("K4", (R, pool.shape[1]), [self._rows(pool, slots)],
                   [want])
        return got

    def _pool_kernel(self, name, fn, plain, pool, slots, *a, out=None,
                     out_rows=None, **kw):
        got = fn(pool, slots, *a, out=out, out_rows=out_rows, **kw)
        want = plain(pool, slots, *a, **kw)
        self._same(name, (np.shape(slots), kw["num_docs"], out is not None),
                   [got if out is None else self._rows(out, out_rows)],
                   [want])
        return got

    def phrase_chain(self, pool, slots, *a, **kw):
        return self._pool_kernel("K5", self.kc.phrase_chain,
                                 self.kc.phrase_chain_plain, pool, slots,
                                 *a, **kw)

    def span_window(self, pool, slots, *a, **kw):
        return self._pool_kernel("K6", self.kc.span_window,
                                 self.kc.span_window_plain, pool, slots,
                                 *a, **kw)

    def merge_step(self, *a, **kw):
        import torch

        got = self.kc.merge_step(*a, **kw)
        want = self.kc.merge_step_plain(
            *a, **{k: v for k, v in kw.items() if k != "need_cont"})
        pair = [got[0], got[1]], [want[0], want[1]]
        if got[2] is not None:
            need = torch.as_tensor(np.repeat(
                self.kc.per_query(kw.get("need_cont", True), len(a[4]),
                                  "need_cont"),
                np.asarray(a[4], np.int64)), device=got[2].device)
            pair[0].append(got[2][need])
            pair[1].append(want[2][need])
        self._same("K7", (len(a[4]), int(np.sum(a[4]))), *pair)
        return got

    def cand_rows(self, *a, **kw):
        got = self.kc.cand_rows(*a, **kw)
        want = self.kc.cand_rows_plain(a[0], a[1], np.asarray(a[2]),
                                       np.asarray(a[3]), a[4], **kw)
        self._same("K8a", (len(a[2]), a[4]),
                   [g for g in got if g is not None],
                   [w for w in want if w is not None])
        return got

    def cand_minis(self, rows, slots, offs, ns, **kw):
        got = self.kc.cand_minis(rows, slots, offs, ns, **kw)
        self._same("K8b", (np.shape(slots), rows.shape[-1]), [got],
                   [self.kc.minis_for_rows_plain(
                       rows, np.asarray(slots), offs, ns, **kw)])
        return got

    def span_sparse(self, *a, **kw):
        got = self.kc.span_sparse(*a, **kw)
        self._same("K9", (np.shape(a[2]), a[4]), list(got),
                   list(self.kc.span_sparse_plain(*a, **kw)))
        return got


def parent_cand_rows(lib, counted, extra):
    """K8a's wrapper for a library of the two-kernel design (count each
    tile's runs, then write; no ``sa_cand_rows_grid``): its ``meta`` ends
    with one scratch entry per tile.  ``counted`` (the current wrapper)
    counts the launches, ``extra`` (a list of one int) the second kernel
    of each."""
    import torch

    from searcharray_tpu_torch.ops.cuda import score as kc

    def cand_rows(hdrs, pays, offs, ns, Kc, *, num_docs, blk_bits,
                  with_tf=True):
        dev = hdrs.device
        offs = np.asarray(offs, np.int64)
        ns = np.asarray(ns, np.int64)
        Q = len(offs)
        rows = torch.empty((Q, Kc), dtype=torch.int32, device=dev)
        tf = (torch.empty((Q, Kc), dtype=torch.float32, device=dev)
              if with_tf else None)
        if Q == 0:
            return rows, tf
        tiles = -(-ns // lib.sa_cand_rows_tile())
        n_tiles = int(tiles.sum())
        meta = kc.host_to_device(np.concatenate(
            [offs, ns, [0], np.cumsum(tiles),
             np.zeros(n_tiles, np.int64)]), dev)
        err = lib.sa_cand_rows(
            hdrs.data_ptr(), pays.data_ptr(), meta.data_ptr(), Q, n_tiles,
            Kc, num_docs, blk_bits, rows.data_ptr(),
            None if tf is None else tf.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"parent K8a: CUDA error {err}")
        counted.launches += 1
        extra[0] += 1
        return rows, tf

    return cand_rows


def parent_merge_step(lib, counted):
    """K7's wrapper for a library of the one-block-a-tile design (C entry
    ``sa_merge_step``, before the sorted join: one direction and one
    same-term flag a launch).  A call's queries go in one launch per
    (direction, same-term) pair that has any, each launch writing its
    queries' words where the call's outputs hold them; ``counted`` (the
    current wrapper) counts the launches."""
    import ctypes

    import torch

    from searcharray_tpu_torch.ops.cuda import score as kc

    entry = lib.sa_merge_step
    entry.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
                      + [ctypes.c_int, ctypes.c_void_p])
    entry.restype = ctypes.c_int

    def merge_step(hdrs, base_pays, other_pays, base_off, base_n, other_off,
                   other_n, other_pay_off, *, cont_side, same_term=False,
                   blk_bits, key_stride=0, min_blk=None, max_blk=None,
                   need_cont=True):
        dev = hdrs.device
        base_off = np.asarray(base_off, np.int64)
        base_n = np.asarray(base_n, np.int64)
        Q = len(base_n)
        sides = kc.per_query(cont_side, Q, "cont_side")
        same = kc.per_query(same_term, Q, "same_term")
        conts = kc.per_query(need_cont, Q, "need_cont")
        M = int(base_n.sum())
        keys = torch.empty(M, dtype=torch.int32, device=dev)
        counts = torch.empty(M, dtype=torch.float32, device=dev)
        cont = (torch.empty(M, dtype=torch.int32, device=dev) if any(conts)
                else None)
        out_off = kc.prefix_offsets(base_n)
        tile = lib.sa_merge_step_tile()
        window = ((0, (1 << 18) - 1) if min_blk is None
                  else (int(min_blk), int(max_blk)))
        for side in ("rhs", "lhs"):
            for st in (False, True):
                qs = np.asarray([q for q in range(Q) if sides[q] == side
                                 and bool(same[q]) == st and base_n[q] > 0],
                                np.int64)
                if not len(qs):
                    continue
                n_tiles = -(-base_n[qs] // tile)
                oo = base_off[qs] if st else np.asarray(other_off)[qs]
                on = base_n[qs] if st else np.asarray(other_n)[qs]
                po = base_off[qs] if st else np.asarray(other_pay_off)[qs]
                meta = kc.host_to_device(np.concatenate([
                    base_off[qs], base_n[qs], oo, on, po, out_off[qs],
                    qs * key_stride, kc.prefix_offsets(n_tiles),
                    np.repeat(np.arange(len(qs)), n_tiles)]).astype(
                        np.int64), dev)
                err = entry(hdrs.data_ptr(), base_pays.data_ptr(),
                            (base_pays if st else other_pays).data_ptr(),
                            meta.data_ptr(), len(qs), int(n_tiles.sum()),
                            blk_bits, *window, int(side == "rhs"), int(st),
                            keys.data_ptr(), counts.data_ptr(),
                            None if cont is None else cont.data_ptr(),
                            dev.index,
                            torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"parent K7: CUDA error {err}")
                counted.launches += 1
        return keys, counts, cont

    return merge_step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", metavar="DIR",
                    help="also build the kernel sources in DIR and time "
                         "them in turns with the current ones")
    ap.add_argument("--parent-tree", metavar="DIR",
                    help="also run the sharded driver of the checkout in "
                         "DIR (its own process) in turns with this one's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from bench import PHRASE_QUERIES, TERM_QUERIES, build_corpus
    from bench import serving_queries, slop_queries
    import pandas as pd

    from searcharray_tpu_torch import SearchArray, edismax, edismax_batch
    from searcharray_tpu_torch import solr
    from searcharray_tpu_torch.ops.cuda import roofline as rl
    from searcharray_tpu_torch.ops.cuda import score as kc
    from searcharray_tpu_torch.search import batch, dense, phrase, scoring
    from searcharray_tpu_torch.search import candidates as cand
    from searcharray_tpu_torch.search import spans as spans_mod

    phases = []  # (phase, wall seconds), in the order they ran
    marks = [time.perf_counter()]

    def phase_done(name):
        marks.append(time.perf_counter())
        phases.append((name, marks[-1] - marks[-2]))

    # ---- 1. environment ----------------------------------------------
    card = card_line()
    tag = f"[{card}]"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    so = kc.build()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s -> {so}",
          flush=True)
    parent = None
    if args.parent_csrc:
        t0 = time.perf_counter()
        parent = kc.load_library(kc.build(
            args.parent_csrc, os.path.join(kc.BUILD_DIR, "parent")))
        print(f"parent kernels from {args.parent_csrc} built in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    phase_done("environment and kernel build")

    k7_wrapper = kc.merge_step   # every K7 launch adds to its counter
    k8a_wrapper = kc.cand_rows   # and every K8a launch to its
    k8a_extra = [0]   # the second kernel of each two-kernel K8a launch

    def with_lib(lib, fn):
        """``fn`` with the kernels of ``lib`` in place of the current
        ones.  A library of the one-block-a-tile K7 (no sa_merge_join)
        takes K7 through ``parent_merge_step``, and a call's sparse phrase
        groups one group at a time, as that design ran them; one without
        K10 (no sa_similarity) takes the similarity as torch ops, as the
        port did before K10; one of the two-kernel K8a (no
        sa_cand_rows_grid) takes K8a through ``parent_cand_rows``; one
        without K11 (no sa_compose) composes edismax as torch ops; one
        without the fused ranking pass (no sa_rank_rows) ranks every group
        by K10 then K3, the route the pass replaced."""
        def run():
            saved = (kc._lib, kc.merge_step, batch.sparse_chains_freqs,
                     kc.similarity, kc.cand_rows, kc.compose, dense.fuses)
            kc._lib = lib
            if not hasattr(lib, "sa_merge_join"):
                kc.merge_step = parent_merge_step(lib, k7_wrapper)
                batch.sparse_chains_freqs = (
                    lambda hd, pa, chains, **kw: [
                        f for c in chains for f in saved[2](hd, pa, [c],
                                                            **kw)])
            if not hasattr(lib, "sa_similarity"):
                kc.similarity = torch_similarity
            if not hasattr(lib, "sa_cand_rows_grid"):
                kc.cand_rows = parent_cand_rows(lib, k8a_wrapper, k8a_extra)
            if not hasattr(lib, "sa_compose"):
                kc.compose = torch_compose
            if not hasattr(lib, "sa_rank_rows"):
                dense.fuses = never_fused
            try:
                return fn()
            finally:
                (kc._lib, kc.merge_step, batch.sparse_chains_freqs,
                 kc.similarity, kc.cand_rows, kc.compose, dense.fuses) = saved
        return run

    # ---- 3. main path (counted) -----------------------------------------
    t0 = time.perf_counter()
    corpus = build_corpus(N_DOCS, seed=42)
    corpus_s = time.perf_counter() - t0
    kc.score_term.launches = 0
    kc.score_term_rows.launches = 0
    kc.segment_sum.launches = 0
    kc.plane_fill.launches = 0
    kc.phrase_chain.launches = 0
    kc.merge_step.launches = 0
    kc.topk.launches = 0
    kc.span_window.launches = 0
    kc.span_sparse.launches = 0
    kc.cand_rows.launches = 0
    kc.cand_minis.launches = 0
    kc.similarity.launches = 0
    kc.compose.launches = 0
    kc.rank_rows.launches = 0
    # every similarity of the main path is K10's and every edismax
    # composition K11's, each launch held to its plain version as it runs
    k10_rec = K10Recorder(kc)
    kc.similarity = k10_rec
    k11_rec = K11Recorder(kc)
    kc.compose = k11_rec
    # a phrase above K5's cap that matches at least one doc: the first 40
    # tokens of the first doc that has as many
    long_doc, long_ph = next((d, t[:40]) for d, t in enumerate(
        doc.split() for doc in corpus) if len(t) >= 40)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arr = SearchArray.index(corpus, device=DEVICE, autowarm=False)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = arr.dev  # attach: upload the posting planes
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr.warm()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # the title field of bench.py's edismax tier: each doc's first 8 tokens
    titles = [" ".join(doc.split()[:8]) for doc in corpus]
    del corpus
    n = len(arr)
    post = dev.postings
    check(n == N_DOCS and dev.blk_bits == 3,
          f"index of {n} docs on {dev.device}, blk_bits {dev.blk_bits}")
    phase_done("corpus, host build, upload, warm")

    # the main path's K8 launches, and K5/K6 on minis and K3 over a
    # candidate axis, each held to its plain version as it runs; and the
    # group kinds of every batch
    rec = K8Recorder(kc, n, dev.blk_bits)
    batch.kernels_cuda = cand.kernels_cuda = dense.kernels_cuda = rec
    classify_log = []
    classify = batch._classify

    def classify_spy(*a, **kw):
        groups = classify(*a, **kw)
        classify_log.append(sorted({g[0] for g in groups}))
        return groups

    batch._classify = classify_spy

    def kinds_since(mark):
        return sorted({k for ks in classify_log[mark:] for k in ks})

    avgdl = dev.avg_doc_length
    s_what = arr.score("what")
    s_rare = arr.score("w4095")
    top_scores, top_idx = arr.topk("star", k=TOP_K)
    rare = [f"w{i}" for i in range(4000, 29000, 125)]
    queries = list(TERM_QUERIES) + rare
    b_scores, b_idx = arr.score_batch(queries, top_k=TOP_K)
    collect = arr.score_batch(queries, top_k=TOP_K, block=False)
    p_scores, p_idx = collect()

    for term, got in (("what", s_what), ("w4095", s_rare)):
        tid = arr.term_dict.get_term_id(term)
        tf = oracle_tf(post, tid, n)
        check(np.array_equal(arr.termfreqs(term), tf),
              f"termfreqs({term!r}) equals the numpy oracle exactly")
        # a position window takes the term's posting slice: one K1 launch
        docs, _ = oracle_positions(post, tid, (WIN_FREQS["min_posn"],
                                               WIN_FREQS["max_posn"]))
        check(np.array_equal(arr.termfreqs(term, **WIN_FREQS),
                             np.bincount(docs, minlength=n)
                             .astype(np.float32)),
              f"termfreqs({term!r}, {WIN_FREQS}) equals the numpy oracle "
              "exactly")
        want = oracle_scores(dev, term)
        check(got.shape == (n,) and np.all(np.isfinite(got))
              and np.allclose(got, want, rtol=1e-6, atol=0),
              f"score({term!r}) within rtol 1e-6 of the oracle "
              f"(max abs err {np.abs(got - want).max():.3g})")
    check_ranking(dev, ["star"], [top_scores], [top_idx],
                  f"topk('star', k={TOP_K})")
    check_ranking(dev, queries, b_scores, b_idx,
                  f"score_batch(top_k={TOP_K})")
    check(np.array_equal(p_idx, b_idx) and np.array_equal(p_scores, b_scores),
          "score_batch(block=False) + collect() equals the blocking call")
    phase_done("terms: drive and oracle checks")

    # exact phrases on the dense plane engine: planes filled by K4, freqs
    # by K5.  The first score() or termfreqs() (a one-query batch) and the
    # first batch run the chain; the second encounter of a phrase promotes
    # it (PHRASE_TF_MIN_HITS), and K5 fills its tf-pool row; the third
    # batch reads the cached rows (the batch holds more rows than the
    # 192-slot tf pool, so LRU evicts some of them between calls and K5
    # refills those).
    ph3 = ["what", "is", "the"]
    ph4 = ["what", "is", "the", "purpose"]
    s_ph3 = arr.score(ph3)
    f_ph4 = arr.termfreqs(ph4)
    mixed = list(TERM_QUERIES) + list(PHRASE_QUERIES) + EXTRA_PHRASES + rare
    phrases = list(PHRASE_QUERIES) + EXTRA_PHRASES
    k5_before = kc.phrase_chain.launches
    mixed_runs = [arr.score_batch(mixed, top_k=TOP_K)]
    k5_chain = kc.phrase_chain.launches - k5_before
    promoted_first = set(dev.maps.phrase_recipes)
    mixed_runs.append(arr.score_batch(mixed, top_k=TOP_K, block=False)())
    k5_fill = kc.phrase_chain.launches - k5_before - k5_chain
    mixed_runs.append(arr.score_batch(mixed, top_k=TOP_K))
    phase_done("phrases: drive")

    check(np.array_equal(f_ph4, oracle_phrase_freqs(dev, ph4)),
          f"termfreqs({ph4}) equals the numpy oracle exactly "
          f"({int(f_ph4.sum())} matches)")
    want = oracle_scores(dev, ph3)
    check(s_ph3.shape == (n,) and np.all(np.isfinite(s_ph3))
          and np.allclose(s_ph3, want, rtol=1e-6, atol=0)
          and float(want.max()) > 0,
          f"score({ph3}) within rtol 1e-6 of the oracle "
          f"(max abs err {np.abs(s_ph3 - want).max():.3g})")
    # the first batch (the chain) against the oracle; the promotion
    # (block=False) and the cached rows must then return it bit for bit
    check_ranking(dev, mixed, *mixed_runs[0],
                  f"mixed score_batch(top_k={TOP_K}), chain")
    check(all(np.array_equal(r[0], mixed_runs[0][0])
              and np.array_equal(r[1], mixed_runs[0][1])
              for r in mixed_runs[1:]),
          "the promotion (block=False) and cached-row batches return the "
          "chain batch's top-k bit for bit")
    sig = lambda q: (tuple(arr.term_dict.get_term_id(t) for t in q), 0)  # noqa: E731
    check(k5_chain > 0 and k5_fill > 0
          and promoted_first == {sig(ph3), sig(ph4)}
          and set(dev.maps.phrase_recipes) == {sig(q) for q in phrases},
          f"phrases ran the chain ({k5_chain} K5 launches in the first "
          f"batch) and were promoted on their second hit ({k5_fill} K5 "
          f"launches filling tf-pool rows, {len(dev.maps.phrase_recipes)} "
          "phrases cached)")
    for ph in phrases:
        got = arr.termfreqs(ph)
        if not np.array_equal(got, oracle_phrase_freqs(dev, ph)):
            raise AssertionError(f"termfreqs({ph}) differs from the oracle")
    check(True, f"termfreqs of all {len(phrases)} phrases equal the oracle "
          "exactly")
    phase_done("phrases: oracle checks")

    # slop phrases on the dense planes (K6).  bench.py's mixed request:
    # 120 term and phrase queries and 24 slop-2 phrases in one batch, with
    # a slop per query.  The first call runs the window groups (one K6
    # launch per (distinct terms, window, multiplicities)), the second
    # promotes each slop phrase and K6 fills its tf-pool row, the third
    # reads the cached rows.  Then score and termfreqs of each distinct
    # slop shape and of a stopword phrase that repeats a term at the
    # widest window the dense path takes.
    def mixed_request(r):
        return (serving_queries(r) + slop_queries(r),
                [0] * len(serving_queries(r)) + [SLOP] * len(slop_queries(r)))

    sq, ss = mixed_request(0)
    slop_shapes = [list(q) for q in dict.fromkeys(map(tuple,
                                                      slop_queries(0)))]
    k6_before = kc.span_window.launches
    mark = len(classify_log)
    slop_runs = [arr.score_batch(sq, top_k=TOP_K, slop=ss)]
    kinds_mixs = kinds_since(mark)
    k6_group = kc.span_window.launches - k6_before
    slop_runs.append(arr.score_batch(sq, top_k=TOP_K, slop=ss,
                                     block=False)())
    k6_fill = kc.span_window.launches - k6_before - k6_group
    slop_runs.append(arr.score_batch(sq, top_k=TOP_K, slop=ss))
    k6_cached = kc.span_window.launches - k6_before - k6_group - k6_fill
    slop_sigs = {k for k in dev.maps.phrase_recipes if k[1] == SLOP}
    slop_scores = [arr.score(q, slop=SLOP) for q in slop_shapes]
    slop_freqs = [arr.termfreqs(q, slop=SLOP) for q in slop_shapes]
    wide_q, wide_slop = WIDE_SLOP
    s_wide = arr.score(wide_q, slop=wide_slop)
    f_wide = arr.termfreqs(wide_q, slop=wide_slop)
    phase_done("slop: drive")

    check_ranking(dev, sq, *slop_runs[0],
                  f"mixed request with slop, score_batch(top_k={TOP_K}), "
                  "window groups", slops=ss)
    check(all(np.array_equal(r[0], slop_runs[0][0])
              and np.array_equal(r[1], slop_runs[0][1])
              for r in slop_runs[1:]),
          "the promotion (block=False) and cached-row batches of the mixed "
          "request return the first batch's top-k bit for bit")
    tid_of = arr.term_dict.get_term_id
    check(k6_group > 0 and k6_fill > 0 and k6_cached <= k6_fill
          and slop_sigs == {(tuple(tid_of(t) for t in q), SLOP)
                            for q in slop_shapes},
          f"slop phrases ran {k6_group} K6 group launches in the first "
          f"batch, were promoted on their second hit ({k6_fill} K6 launches "
          f"filling tf-pool rows, {len(slop_sigs)} slop phrases cached) and "
          "then read their rows with no K6 launch")
    slop_err, slop_matches = 0.0, 0
    oracle_warm(dev, slop_shapes + [wide_q],
                [SLOP] * len(slop_shapes) + [wide_slop])
    oracle_warm(dev, slop_shapes[:3] + [wide_q])
    for q, slop, got_s, got_f in [
            *zip(slop_shapes, [SLOP] * len(slop_shapes), slop_scores,
                 slop_freqs), (wide_q, wide_slop, s_wide, f_wide)]:
        want_f = oracle_span_freqs(dev, q, slop)
        want_s = oracle_scores(dev, q, slop=slop)
        if not np.array_equal(got_f, want_f):
            raise AssertionError(f"termfreqs({q}, slop={slop}) differs from "
                                 "the oracle")
        if not (got_s.shape == (n,) and np.all(np.isfinite(got_s))
                and np.allclose(got_s, want_s, rtol=1e-6, atol=0)):
            raise AssertionError(f"score({q}, slop={slop}) differs from the "
                                 "oracle")
        # each exact occurrence covers an anchor position of its own
        # (held on the repeating shapes, whose exact planes are there)
        if (q in slop_shapes[:3] + [wide_q]
                and not (want_f >= oracle_phrase_freqs(dev, q)).all()):
            raise AssertionError(f"slop freqs of {q} below its exact freqs")
        slop_err = max(slop_err, float(np.abs(got_s - want_s).max()))
        slop_matches += int(want_f.sum())
    check(slop_matches > 0 and float(f_wide.sum()) > 0,
          f"termfreqs(phrase, slop) equal the oracle exactly and "
          f"score(phrase, slop) is within rtol 1e-6 of it (max abs err "
          f"{slop_err:.3g}) on the {len(slop_shapes)} slop-{SLOP} shapes and "
          f"on {wide_q} at slop {wide_slop} ({slop_matches} covered anchor "
          "positions; the repeating shapes never below their exact "
          "phrase's freqs)")
    phase_done("slop: oracle checks")

    # the candidate-subset engine at 1M docs: the serving mix (the first
    # part of the mixed request above, whose oracle scores are at hand) and
    # topk of a rare term on the port's default routing (the engine off at
    # 1M: search/candidates.py) and at the JAX package's thresholds (on);
    # then forced on (its thresholds set to 0, as the tests set them) for
    # rare and mid-frequency terms, a phrase with a stopword co-term, a
    # same-term phrase and slop phrases, ranked, dense and on the device
    k8_before = (kc.cand_rows.launches, kc.cand_minis.launches)

    def k8_since(before):
        return (kc.cand_rows.launches - before[0],
                kc.cand_minis.launches - before[1])

    mark = len(classify_log)
    d_scores, d_idx = arr.score_batch(serving_queries(0), top_k=TOP_K)
    dt_scores, dt_idx = arr.topk("w7001", k=TOP_K)
    kinds_default = kinds_since(mark)
    k8_default = k8_since(k8_before)
    k8_before = (kc.cand_rows.launches, kc.cand_minis.launches)
    with thresholds(cand, solr, JAX_CAND):
        mark = len(classify_log)
        sm_n8 = len(rec.k8a)
        sm_scores, sm_idx = arr.score_batch(serving_queries(0), top_k=TOP_K)
        sm_k8a = rec.k8a[sm_n8:]
        kinds_mix = kinds_since(mark)
        mark = len(classify_log)
        rt_scores, rt_idx = arr.topk("w7001", k=TOP_K)
        kinds_topk = kinds_since(mark)
    k8_jax = k8_since(k8_before)
    k8_before = (kc.cand_rows.launches, kc.cand_minis.launches)
    with thresholds(cand, solr, dict.fromkeys(CAND_CONSTS, 0)):
        mark = len(classify_log)
        f_n8b = len(rec.k8b)
        f_ranked = arr.score_batch(FORCED_Q, top_k=TOP_K, slop=FORCED_SLOP)
        kinds_forced = kinds_since(mark)
        f_k8b = rec.k8b[f_n8b:]
        f_dense = arr.score_batch(FORCED_Q, slop=FORCED_SLOP)
        f_device = arr.score_batch_device(FORCED_Q,
                                          slop=FORCED_SLOP).cpu().numpy()
    k8_forced = k8_since(k8_before)
    for what, (sc, ix), (tsc, tix) in (
            ("the port's default routing", (d_scores, d_idx),
             (dt_scores, dt_idx)),
            ("the JAX package's thresholds", (sm_scores, sm_idx),
             (rt_scores, rt_idx))):
        check_ranking(dev, serving_queries(0), sc, ix,
                      f"serving mix score_batch(top_k={TOP_K}) on {what}")
        check_ranking(dev, ["w7001"], [tsc], [tix],
                      f"topk('w7001', k={TOP_K}) on {what}")
    check("cterm" in kinds_mix and "cterm" in kinds_topk
          and {"cterm", "cphrase", "cspan"} <= set(kinds_forced)
          and min(k8_jax) > 0 and min(k8_forced) > 0,
          f"the candidate engine at {n} docs: the port's default routing "
          f"ran groups {kinds_default} for the serving mix and topk of a "
          f"rare term ({kinds_mixs} for the mixed request with slop), the "
          f"JAX package's thresholds {kinds_mix} and {kinds_topk}, the "
          f"forced phase {kinds_forced}; K8a and K8b launched {k8_default} "
          f"times on the default routing, {k8_jax} at the JAX thresholds, "
          f"{k8_forced} forced")
    check_ranking(dev, FORCED_Q, *f_ranked,
                  f"forced candidates, score_batch(top_k={TOP_K})",
                  slops=FORCED_SLOP)
    f_err = 0.0
    for i, (q, sl) in enumerate(zip(FORCED_Q, FORCED_SLOP)):
        want = oracle_scores(dev, q, slop=sl)
        f_err = max(f_err, float(np.abs(f_dense[i] - want).max()))
        if not (np.allclose(f_dense[i], want, rtol=1e-6, atol=0)
                and float(want.max()) > 0):
            raise AssertionError(f"forced candidates: dense {q} at slop "
                                 f"{sl} differs from the oracle")
    pooled = [c for c in f_k8b if (np.asarray(c[0][1]) >= 0).any()
              and (np.asarray(c[0][1]) < 0).any()]
    check(np.array_equal(f_device, f_dense) and pooled,
          f"forced candidates: score_batch dense within rtol 1e-6 of the "
          f"oracle on {len(FORCED_Q)} queries (max abs err {f_err:.3g}), "
          "score_batch_device equal to it, and K8b built minis of a pooled "
          "stopword plane and of own slices in one launch")
    phase_done("candidate engine: drive and oracle checks")

    # long documents: one ~220k-token doc needs 14 block bits, so dense
    # planes would pass the per-plane limit and score_batch takes the
    # sparse term group, reduced by K2
    long_corpus = build_corpus(LONG_DOCS, seed=7)
    long_corpus[0] = " ".join(long_corpus[1:4001])
    larr = SearchArray.index(long_corpus, device=DEVICE)
    long_titles = [" ".join(doc.split()[:8]) for doc in long_corpus]
    del long_corpus
    ldev = larr.dev
    check(ldev.blk_bits == 14 and not dense.dense_eligible(ldev),
          f"long-document index of {len(larr)} docs is not dense-eligible")
    k2_before = kc.segment_sum.launches
    l_scores, l_idx = larr.score_batch(TERM_QUERIES, top_k=TOP_K)
    k2_long = kc.segment_sum.launches - k2_before
    check_ranking(ldev, TERM_QUERIES, l_scores, l_idx,
                  f"long-document score_batch(top_k={TOP_K})")

    phase_done("long-document index: build, term drive, checks")

    # the sparse phrase chain: every step one K7 launch, its (doc key,
    # count) pairs summed by one K2 launch.  Windowed phrases on the 1M
    # index (the stopword phrases merge posting lists of millions of
    # words), a 40-term phrase (K5 takes 32) through score and score_batch,
    # and the serving mix of terms and phrases on the long-document index
    k72_before = (kc.merge_step.launches, kc.segment_sum.launches)
    win_scores = [arr.score(q, **WIN_SCORE) for q in phrases]
    win_freqs = [arr.termfreqs(q, **WIN_FREQS) for q in phrases]
    k7_windows = kc.merge_step.launches - k72_before[0]
    s_long = arr.score(long_ph)
    f_long = arr.termfreqs(long_ph)
    bl_scores, bl_idx = arr.score_batch(["star", long_ph], top_k=TOP_K)
    k7_long = kc.merge_step.launches - k72_before[0] - k7_windows
    lmix = serving_queries(0) + [["the", "of"]] + EXTRA_PHRASES
    lm_scores, lm_idx = larr.score_batch(lmix, top_k=TOP_K)
    lp_scores, lp_idx = larr.score_batch(lmix, top_k=TOP_K, block=False)()
    k7_lmix = (kc.merge_step.launches - k72_before[0] - k7_windows
               - k7_long)
    k2_chain = kc.segment_sum.launches - k72_before[1]
    phase_done("sparse phrase chain: drive")

    # slop phrases on the posting slices: every launch is K9, its (doc
    # key, count) pairs summed by K2.  At 1M docs what the dense window
    # cannot take: every slop shape inside a position window, a window of
    # 21 positions, a term three times; and one request whose slop list
    # sends bench.py's 24 slop-2 phrases to K6 (or their cached rows) and
    # three more to K9.  On the long-document index no plane fits, so
    # every slop phrase of the request takes K9.
    k9_before = kc.span_sparse.launches
    maps = dev.maps
    pools = lambda: (dict(maps.plane_slot), dict(maps.tf_slot),  # noqa: E731
                     list(maps.plane_free), list(maps.tf_free))
    pools_before = pools()
    wins_scores = [arr.score(q, slop=SLOP, **WIN_SCORE) for q in slop_shapes]
    wins_freqs = [arr.termfreqs(q, slop=SLOP, **WIN_SCORE)
                  for q in slop_shapes]
    k9_windows = kc.span_sparse.launches - k9_before
    k9_singles = [(q, sl, arr.score(q, slop=sl), arr.termfreqs(q, slop=sl))
                  for q, sl in (WIDER_SLOP, TRIPLE_SLOP)]
    pools_same = pools() == pools_before
    k9_extra = [WIDER_SLOP, TRIPLE_SLOP, (["star", "trek"], 18)]
    k9q = sq + [q for q, _ in k9_extra]
    k9s = ss + [sl for _, sl in k9_extra]
    k69_before = (kc.span_window.launches, kc.span_sparse.launches,
                  kc.topk.launches)
    k9_scores, k9_idx = arr.score_batch(k9q, top_k=TOP_K, slop=k9s)
    k69_mixed = (kc.span_window.launches - k69_before[0],
                 kc.span_sparse.launches - k69_before[1],
                 kc.topk.launches - k69_before[2])
    k9_1m = kc.span_sparse.launches - k9_before
    lsq = lmix + slop_queries(0)
    lss = [0] * len(lmix) + [SLOP] * len(slop_queries(0))
    ls_scores, ls_idx = larr.score_batch(lsq, top_k=TOP_K, slop=lss)
    lsp_scores, lsp_idx = larr.score_batch(lsq, top_k=TOP_K, slop=lss,
                                           block=False)()
    k9_long = kc.span_sparse.launches - k9_before - k9_1m
    phase_done("sparse slop: drive")

    # Solr edismax: a title index beside the body index in one dataframe,
    # bench.py's configuration, per query and as one batch, exact phases
    # and slop phases (ps on the whole phrase, ps2 on the bigrams); then
    # the same frame on the long-document corpus, where the body's exact
    # bigrams run K7 and its slop phrases K9
    t0 = time.perf_counter()
    # the title postings memory-mapped from a file (data_dir=) in a
    # directory of its own, removed when the script ends
    title_dir = tempfile.mkdtemp(prefix="sa_titles_")
    atexit.register(shutil.rmtree, title_dir, True)
    tarr = SearchArray.index(titles, device=DEVICE, data_dir=title_dir)
    ltarr = SearchArray.index(long_titles, device=DEVICE)
    del long_titles
    title_s = time.perf_counter() - t0
    df = pd.DataFrame({"title": tarr, "body": arr})
    ldf = pd.DataFrame({"title": ltarr, "body": larr})
    check(tarr.dev.blk_bits == 1 and dense.dense_eligible(tarr.dev)
          and dense.dense_eligible(ltarr.dev),
          f"title indexes of {len(tarr)} and {len(ltarr)} docs (8 tokens "
          f"each, blk_bits {tarr.dev.blk_bits}) beside the body indexes, "
          f"built and attached in {title_s:.1f} s")
    ed_before = {k: getattr(kc, k).launches for k in (
        "span_sparse", "span_window", "merge_step", "phrase_chain", "topk",
        "cand_minis")}
    # which calls scored their exact phases at the main query's matches
    pruned = []
    phase_rows = solr._phase_candidate_rows

    def phase_rows_spy(qf_scores):
        got = phase_rows(qf_scores)
        pruned.append(None if got is None else len(got))
        return got

    solr._phase_candidate_rows = phase_rows_spy
    # the first pass, on cold grams, prunes at the JAX package's threshold
    # (the port's keeps the mask path at 1M: solr.py)
    ed_n8b = len(rec.k8b)
    with thresholds(cand, solr, {}, JAX_PHASE_SUBSET_MIN_DOCS):
        ed_one = [edismax(df, q=q, top_k=TOP_K, **ED_KW)
                  for q in ED_QUERIES]
    ed_k8b = len(rec.k8b) - ed_n8b
    ed_pruned = list(pruned)
    ed_batch = edismax_batch(df, ED_QUERIES, top_k=TOP_K, **ED_KW)
    ed_dense = [edismax(df, q=q, **ED_KW) for q in ED_QUERIES[:3]]
    eds_one = [edismax(df, q=q, top_k=TOP_K, **ED_KW, **ED_SLOP)
               for q in ED_QUERIES]
    eds_batch = edismax_batch(df, ED_QUERIES, top_k=TOP_K, **ED_KW,
                              **ED_SLOP)
    k9_ed_before = kc.span_sparse.launches
    led_one = [edismax(ldf, q=q, top_k=TOP_K, ps=SLOP, **ED_KW)
               for q in ED_QUERIES]
    led_batch = edismax_batch(ldf, ED_QUERIES, top_k=TOP_K, ps=SLOP, **ED_KW)
    k9_ed = kc.span_sparse.launches - k9_ed_before
    solr._phase_candidate_rows = phase_rows
    ed_launches = {k: getattr(kc, k).launches - v
                   for k, v in ed_before.items()}

    # the main path ends here: read its launch counts before anything else
    # launches a kernel
    launches = {"score_term": kc.score_term.launches,
                "score_term_rows": kc.score_term_rows.launches,
                "segment_sum": kc.segment_sum.launches,
                "plane_fill": kc.plane_fill.launches,
                "phrase_chain": kc.phrase_chain.launches,
                "merge_step": kc.merge_step.launches,
                "topk": kc.topk.launches,
                "span_window": kc.span_window.launches,
                "cand_rows": kc.cand_rows.launches,
                "cand_minis": kc.cand_minis.launches,
                "span_sparse": kc.span_sparse.launches,
                "similarity": k10_rec.launches,
                "compose": k11_rec.launches,
                "rank_rows": kc.rank_rows.launches}
    kc.similarity = k10_rec.orig
    kc.similarity.launches += k10_rec.launches
    kc.compose = k11_rec.orig
    kc.compose.launches += k11_rec.launches
    batch.kernels_cuda = cand.kernels_cuda = dense.kernels_cuda = kc
    batch._classify = classify
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"main path launches: {launches}", flush=True)
    phase_done("edismax: drive")
    check(all(v > 0 for v in launches.values()),
          "every kernel of the path launched in the main-path run")
    check(k10_rec.calls == k10_rec.launches > 0,
          f"every similarity of the main path ran as K10 ({k10_rec.launches} "
          f"launches over {len(k10_rec.shapes)} (kind, shape) pairs), each "
          "equal to similarity_plain bit for bit (max abs err "
          f"{k10_rec.err})")
    check(k11_rec.calls == k11_rec.launches > 0,
          f"every edismax composition of the main path ran as K11 "
          f"({k11_rec.launches} launches over {len(k11_rec.shapes)} "
          "(centric, chain, term counts) shapes), each equal to "
          f"compose_plain bit for bit (max abs err {k11_rec.err})")
    check(rec.checked["K3+K10"] == launches["rank_rows"] > 0,
          f"every ranked group of the main path with whole rows and k up to "
          f"{kc.RANK_MAX_K} ran the fused ranking pass ({launches['rank_rows']}"
          f" launches over {len(rec.rank_shapes)} (kind, rows, docs, k, by "
          "slot) shapes), each equal to rank_rows_plain bit for bit (max abs "
          f"err {rec.err['K3+K10']})")
    check(min(k7_windows, k7_long, k7_lmix) > 0
          and k2_chain >= k7_windows + k7_long + k7_lmix,
          f"the sparse chain launched K7 {k7_windows} times for the "
          f"windowed phrases, {k7_long} for the {len(long_ph)}-term phrase "
          f"and {k7_lmix} for the long-document mix, and K2 {k2_chain} "
          "times on their steps and the mix's term groups")
    win_s = (WIN_SCORE["min_posn"], WIN_SCORE["max_posn"])
    win_f = (WIN_FREQS["min_posn"], WIN_FREQS["max_posn"])
    win_err, win_matches = 0.0, [0, 0]
    oracle_warm(dev, phrases, window=win_s)
    if win_f != win_s:
        oracle_warm(dev, phrases, window=win_f)
    for q, got_s, got_f in zip(phrases, win_scores, win_freqs):
        want_s = oracle_scores(dev, q, window=win_s)
        want_f = oracle_phrase_freqs(dev, q, win_f)
        if not (got_s.shape == (n,) and np.all(np.isfinite(got_s))
                and np.allclose(got_s, want_s, rtol=1e-6, atol=0)):
            raise AssertionError(f"score({q}, {WIN_SCORE}) differs from "
                                 "the oracle")
        if not np.array_equal(got_f, want_f):
            raise AssertionError(f"termfreqs({q}, {WIN_FREQS}) differs "
                                 "from the oracle")
        win_err = max(win_err, float(np.abs(got_s - want_s).max()))
        win_matches[0] += int((want_s > 0).sum())
        win_matches[1] += int(want_f.sum())
    check(min(win_matches) > 0,
          f"score(phrase, {WIN_SCORE}) within rtol 1e-6 of the oracle (max "
          f"abs err {win_err:.3g}, {win_matches[0]} matching docs) and "
          f"termfreqs(phrase, {WIN_FREQS}) equal to it exactly "
          f"({win_matches[1]} matches) on all {len(phrases)} phrases, the "
          "oracle's planes zeroed outside the window")
    # the sparse oracle, which the 40-term phrase and the long-document
    # index need, against the dense-plane one
    for q in (ph4, phrases[-1], phrases[-3]):
        if not np.array_equal(oracle_phrase_freqs(dev, q, win_f, sparse=True),
                              oracle_phrase_freqs(dev, q, win_f,
                                                  sparse=False)):
            raise AssertionError(f"the two oracles differ on {q}")
    check(np.array_equal(oracle_phrase_freqs(dev, ph4, sparse=True),
                         oracle_phrase_freqs(dev, ph4, sparse=False)),
          "the posting-list oracle equals the dense-plane oracle")
    want = oracle_scores(dev, long_ph, sparse=True)
    check(np.array_equal(f_long, oracle_phrase_freqs(dev, long_ph,
                                                     sparse=True))
          and f_long[long_doc] >= 1
          and np.allclose(s_long, want, rtol=1e-6, atol=0),
          f"termfreqs and score of the first {len(long_ph)} tokens of doc "
          f"{long_doc} (above K5's cap of {dense.CHAIN_MAX_TERMS}) equal "
          f"the oracle ({int(f_long.sum())} matching docs)")
    check_ranking(dev, ["star", long_ph], bl_scores, bl_idx,
                  f"score_batch of a term and the {len(long_ph)}-term "
                  "phrase", sparse=True)
    check_ranking(ldev, lmix, lm_scores, lm_idx,
                  f"long-document serving mix score_batch(top_k={TOP_K})")
    check(np.array_equal(lp_idx, lm_idx)
          and np.array_equal(lp_scores, lm_scores)
          and sum(1 for q in lmix if not isinstance(q, str)) * 2
          >= len(lmix),
          "the long-document mix with block=False equals the blocking "
          f"call ({len(lmix)} queries, half of them phrases)")
    phase_done("sparse phrase chain: oracle checks")

    # the sparse slop results against the prefix-sum oracle, its planes
    # zeroed outside the window; the long-document ones against the
    # position-list oracle, which is first held to the other at 1M docs
    check(k9_windows == 2 * len(slop_shapes) and pools_same
          and k9_1m - k9_windows == 4 + k69_mixed[1] and k9_long > 0
          and k69_mixed[1] == len(k9_extra) and k69_mixed[2] > 0,
          f"slop phrases outside the dense window launched K9 "
          f"{k9_windows} times for the windowed shapes and "
          f"{k9_1m - k9_windows} for a window of "
          f"{len(WIDER_SLOP[0]) + WIDER_SLOP[1] - 1} positions, a term three "
          f"times and the request that mixes both routes (K6 "
          f"{k69_mixed[0]}, K9 {k69_mixed[1]} launches: one per (terms, "
          f"window, multiplicities) group), and {k9_long} times for two "
          "long-document requests; the single queries left both pools as "
          "they were")
    win_b = (WIN_SCORE["min_posn"], WIN_SCORE["max_posn"])
    ws_err, ws_matches = 0.0, 0
    oracle_warm(dev, slop_shapes, SLOP, window=win_b)
    oracle_warm(dev, [q for q, _, _, _ in k9_singles],
                [sl for _, sl, _, _ in k9_singles])
    for q, sl, got_s, got_f, window in [
            *((q, SLOP, s_, f_, win_b) for q, s_, f_ in zip(
                slop_shapes, wins_scores, wins_freqs)),
            *((q, sl, s_, f_, None) for q, sl, s_, f_ in k9_singles)]:
        want_f = oracle_span_freqs(dev, q, sl, window)
        want_s = oracle_scores(dev, q, window=window, slop=sl)
        if not np.array_equal(got_f, want_f):
            raise AssertionError(f"termfreqs({q}, slop={sl}, {window}) "
                                 "differs from the oracle")
        if not (got_s.shape == (n,) and np.all(np.isfinite(got_s))
                and np.allclose(got_s, want_s, rtol=1e-6, atol=0)):
            raise AssertionError(f"score({q}, slop={sl}, {window}) differs "
                                 "from the oracle")
        ws_err = max(ws_err, float(np.abs(got_s - want_s).max()))
        ws_matches += int(want_f.sum())
    check(ws_matches > 0 and all(f.sum() > 0 for _, _, _, f in k9_singles),
          f"termfreqs(phrase, slop) equal the oracle exactly and "
          f"score(phrase, slop) is within rtol 1e-6 of it (max abs err "
          f"{ws_err:.3g}) on the {len(slop_shapes)} slop-{SLOP} shapes in "
          f"positions {win_b[0]}-{win_b[1]}, on {WIDER_SLOP[0]} at slop "
          f"{WIDER_SLOP[1]} and on {TRIPLE_SLOP[0]} at slop "
          f"{TRIPLE_SLOP[1]} ({ws_matches} covered anchor positions)")
    for q, sl, window in ((slop_shapes[0], SLOP, win_b),
                          (slop_shapes[2], SLOP, None),
                          (WIDER_SLOP[0], WIDER_SLOP[1], None)):
        if not np.array_equal(
                oracle_span_freqs(dev, q, sl, window, sparse=True),
                oracle_span_freqs(dev, q, sl, window, sparse=False)):
            raise AssertionError(f"the two slop oracles differ on {q}")
    check(True, "the position-list slop oracle equals the prefix-sum one")
    check_ranking(dev, k9q, k9_scores, k9_idx,
                  f"the request mixing K6 and K9 slop phrases, "
                  f"score_batch(top_k={TOP_K})", slops=k9s)
    check_ranking(ldev, lsq, ls_scores, ls_idx,
                  f"long-document serving mix with slop, "
                  f"score_batch(top_k={TOP_K})", slops=lss)
    check(np.array_equal(lsp_idx, ls_idx)
          and np.array_equal(lsp_scores, ls_scores),
          "the long-document request with slop and block=False equals the "
          f"blocking call ({len(lsq)} queries, {len(slop_queries(0))} of "
          "them slop phrases)")
    phase_done("sparse slop: oracle checks")

    # edismax against the numpy composition of the oracle's scores
    devs, ldevs = ({"title": tarr.dev, "body": dev},
                   {"title": ltarr.dev, "body": ldev})
    check_edismax(devs, ED_QUERIES, [r for r, _ in ed_one],
                  f"edismax(top_k={TOP_K}) at 1M docs, per query", TOP_K)
    check_edismax(devs, ED_QUERIES, list(zip(*ed_batch[0])),
                  f"edismax_batch(top_k={TOP_K}) at 1M docs", TOP_K,
                  chain=False)
    for q, (got, _) in zip(ED_QUERIES, ed_dense):
        want = oracle_edismax(devs, q)
        rel_err(got, want)
        if not (got.shape == (n,) and np.all(np.isfinite(got))
                and np.allclose(got, want, rtol=1e-6, atol=1e-6)
                and (want > 0).any()):
            raise AssertionError(f"dense edismax({q!r}) differs from the "
                                 "oracle")
    check(True, f"dense edismax scores within rtol 1e-6 of the oracle on "
          f"{len(ed_dense)} queries")
    check_edismax(devs, ED_QUERIES[:6], [r for r, _ in eds_one[:6]],
                  f"edismax(top_k={TOP_K}, ps=2, ps2=1) at 1M docs, per "
                  "query", TOP_K, **ED_SLOP)
    check_edismax(devs, ED_QUERIES[:6], list(zip(*eds_batch[0]))[:6],
                  f"edismax_batch(top_k={TOP_K}, ps=2, ps2=1) at 1M docs",
                  TOP_K, chain=False, **ED_SLOP)
    check_edismax(ldevs, ED_QUERIES, [r for r, _ in led_one],
                  f"edismax(top_k={TOP_K}, ps=2) on the long-document frame, "
                  "per query", TOP_K, ps=SLOP)
    check_edismax(ldevs, ED_QUERIES, list(zip(*led_batch[0])),
                  f"edismax_batch(top_k={TOP_K}, ps=2) on the long-document "
                  "frame", TOP_K, chain=False, ps=SLOP)
    check(all(exp_b == exp_1 for run_1, run_b in (
        (ed_one, ed_batch), (eds_one, eds_batch), (led_one, led_batch))
        for (_, exp_1), exp_b in zip(run_1, run_b[1]))
          and all(np.allclose(sc_b, sc_1, rtol=1e-6, atol=1e-6)
                  for (((sc_1, _), _), sc_b) in zip(eds_one[6:],
                                                    eds_batch[0][0][6:]))
          and k9_ed > 0 and min(ed_launches.values()) > 0,
          f"edismax_batch and per-query edismax give the same explain "
          f"strings and (on the other {len(ED_QUERIES) - 6} slop-phase "
          f"queries) scores; the edismax phase launched {ed_launches}, K9 "
          f"{k9_ed} times on the long-document frame")
    check(any(c is not None for c in ed_pruned) and ed_k8b > 0
          and len(rec.k8a) == launches["cand_rows"]
          and len(rec.k8b) == launches["cand_minis"]
          and min(rec.checked.values()) > 0,
          f"edismax at {n} docs scored its exact phases at the main query's "
          f"matches on {sum(c is not None for c in ed_pruned)} of "
          f"{len(ED_QUERIES)} queries (matched docs {ed_pruned}), with "
          f"{ed_k8b} K8b launches in the first pass; all {len(rec.k8a)} K8a "
          f"and {len(rec.k8b)} K8b launches of the main path equal their "
          f"plain versions bit for bit, as do {rec.checked}")
    phase_done("edismax: oracle checks")

    # ---- 3b. this slice's path, counted: the body index saved and loaded
    # (format v3), the title index (memory-mapped by data_dir=) pickled,
    # and the body index mutated at 1M docs ---------------------------------

    from searcharray_tpu_torch.index import device as device_mod
    from searcharray_tpu_torch.index import store
    from searcharray_tpu_torch.pandas_ext.array import _IndexState

    counted = ("score_term", "score_term_rows", "segment_sum", "plane_fill",
               "phrase_chain", "merge_step", "topk", "span_window",
               "cand_rows", "cand_minis", "span_sparse", "similarity",
               "compose", "rank_rows")
    saved_counts = {k: getattr(kc, k).launches for k in counted}
    for k in counted:
        getattr(kc, k).launches = 0
    k10_slice, k11_slice = K10Recorder(kc), K11Recorder(kc)
    kc.similarity, kc.compose = k10_slice, k11_slice
    smix = serving_queries(777)
    term_q = list(TERM_QUERIES) + rare
    mix_ref = arr.score_batch(smix, top_k=TOP_K)
    terms_ref = arr.score_batch(term_q, top_k=TOP_K)

    def same_ranked(a, b):
        return (np.array_equal(a[1], b[1])
                and np.array_equal(a[0].view(np.int32), b[0].view(np.int32)))

    # persistence: save_index into a temporary directory, load_index with
    # memory maps, attach from the store's planes (a re-derivation raises)
    store_dir = tempfile.mkdtemp(prefix="sa_store_")
    atexit.register(shutil.rmtree, store_dir, True)
    t0 = time.perf_counter()
    store.save_index(arr._built, store_dir)
    save_s = time.perf_counter() - t0
    store_bytes = sum(os.path.getsize(os.path.join(store_dir, f))
                      for f in os.listdir(store_dir))
    t0 = time.perf_counter()
    built_l = store.load_index(store_dir, mmap=True)
    load_s = time.perf_counter() - t0
    derive = device_mod.derive_attach_arrays

    def no_derivation(*_a, **_kw):
        raise AssertionError("the store's planes were derived again")

    device_mod.derive_attach_arrays = no_derivation
    try:
        sarr = SearchArray([], tokenizer=arr.tokenizer, device=DEVICE)
        sarr._attach(_IndexState(built_l, DEVICE))
        t0 = time.perf_counter()
        sdev = sarr.dev
        torch.cuda.synchronize()
        attach_store_s = time.perf_counter() - t0
    finally:
        device_mod.derive_attach_arrays = derive
    t0 = time.perf_counter()
    mem_dev = device_mod.DeviceIndex(arr._built, DEVICE)
    torch.cuda.synchronize()
    attach_mem_s = time.perf_counter() - t0
    check(isinstance(built_l.postings.data, np.memmap)
          and torch.equal(sdev.hdrs, dev.hdrs)
          and torch.equal(sdev.pays, dev.pays)
          and torch.equal(mem_dev.hdrs, dev.hdrs),
          f"save_index wrote {store_bytes} bytes in {save_s:.2f} s; "
          f"load_index(mmap=True) took {load_s:.3f} s; the store's planes "
          f"attached as they are in {attach_store_s:.3f} s (an in-memory "
          f"index derives and attaches in {attach_mem_s:.3f} s), "
          "torch.equal to the in-memory index's")
    del mem_dev
    s_mix = sarr.score_batch(smix, top_k=TOP_K)
    s_terms = sarr.score_batch(term_q, top_k=TOP_K)
    check(same_ranked(s_mix, mix_ref) and same_ranked(s_terms, terms_ref),
          f"the loaded 1M index answers the serving mix ({len(smix)} "
          f"queries) and the term batch ({len(term_q)}) as the in-memory "
          "index does, scores and indices bit for bit")
    del sarr, sdev, built_l

    # pickling: the title index memory-mapped by data_dir= pickles as its
    # file's path and answers edismax as before
    t_post = tarr._built.postings
    t0 = time.perf_counter()
    blob = pickle.dumps(tarr)
    tarr2 = pickle.loads(blob)
    pickle_s = time.perf_counter() - t0
    pickle_bytes = len(blob)
    df2 = pd.DataFrame({"title": tarr2, "body": arr})
    ed_ref = [edismax(df, q=q, top_k=TOP_K, **ED_KW)[0] for q in ED_QUERIES]
    ed_pk = [edismax(df2, q=q, top_k=TOP_K, **ED_KW)[0] for q in ED_QUERIES]
    check(isinstance(t_post.data, np.memmap)
          and t_post.mmap_path.startswith(title_dir)
          and t_post.mmap_path.encode() in blob
          and len(blob) < t_post.data.nbytes
          and tarr2.device == DEVICE and tarr2._state.dev is None
          and all(same_ranked(a, b) for a, b in zip(ed_pk, ed_ref)),
          f"the title index's postings ({t_post.data.nbytes} bytes) are "
          f"memory-mapped from {os.path.basename(t_post.mmap_path)}; its "
          f"pickle is {len(blob)} bytes (dumps and loads "
          f"{pickle_s:.3f} s) and the unpickled array answers "
          f"{len(ED_QUERIES)} edismax queries bit for bit as before")
    del df2, tarr2, blob

    # mutation: 1,000 rows of a copy of the body index, spread over the
    # corpus, take new documents (some with terms new to the vocabulary):
    # 998 by one fancy assignment, 2 by a slice; then one assignment
    # through a take view that repeats a row (de-aliasing)
    mrng = np.random.default_rng(2024)
    m_rows = np.sort(mrng.choice(n, 1000, replace=False))
    new_docs = build_corpus(1000, seed=4242)
    for i in range(0, 1000, 9):
        new_docs[i] += f" novel{i} novel{i} w5"
    donor = SearchArray.index(new_docs, device=DEVICE, autowarm=False)
    m = arr.copy()
    s0 = int(m_rows[500]) + 1
    while s0 in m_rows or s0 + 1 in m_rows:
        s0 += 1
    fancy = np.concatenate([m_rows[:500], m_rows[501:]])[:998]
    t0 = time.perf_counter()
    m[fancy] = donor[np.arange(998)]
    m[s0: s0 + 2] = donor[[998, 999]]
    setitem_s = time.perf_counter() - t0
    new_by_row = dict(zip(fancy.tolist(), new_docs[:998]))
    new_by_row[s0], new_by_row[s0 + 1] = new_docs[998], new_docs[999]
    alias = int(fancy[0])
    tv = m.take([alias, alias, s0])
    tv[0] = donor[5]
    check(m._state.dev is None and len(new_by_row) == 1000
          and dict(tv[0].terms()) == dict(donor[5].terms())
          and dict(tv[1].terms()) == dict(m[alias].terms())
          and dict(m[alias].terms()) == dict(donor[0].terms())
          and tv.subset and len(tv._built.doc_lens) == n + 1,
          f"__setitem__ of 1,000 rows (998 by index, 2 by a slice) took "
          f"{setitem_s:.3f} s and dropped the device copy; assigning "
          "through a take view that repeats a row gave that position a "
          "row of its own and left its alias and the array alone")
    t0 = time.perf_counter()
    mdev = m.dev
    torch.cuda.synchronize()
    reattach_s = time.perf_counter() - t0
    m_mix = m.score_batch(smix, top_k=TOP_K)
    check_ranking(mdev, smix, m_mix[0], m_mix[1],
                  f"the serving mix on the mutated index (re-attached in "
                  f"{reattach_s:.3f} s)")
    # every mutated row's tf of its new terms, and 0 for the terms it lost
    want_tf = {}
    old_vocab = arr.term_dict
    for row, doc in new_by_row.items():
        cnt = Counter(doc.split())
        for t, c in cnt.items():
            want_tf.setdefault(t, []).append((row, c))
        for tid in arr._built.doc_term.row_terms(row):
            t = old_vocab.get_term(int(tid))
            if t not in cnt:
                want_tf.setdefault(t, []).append((row, 0))
    got_tf, exp_tf = [], []
    for t, pairs in want_tf.items():
        rows_t = torch.as_tensor([r for r, _ in pairs], device=mdev.device)
        tf = scoring.termfreqs_dense(mdev, m.term_dict.get_term_id(t))
        got_tf.append(tf[rows_t])
        exp_tf += [c for _, c in pairs]
    got_tf = torch.cat(got_tf).cpu().numpy()
    novel = sum(t.startswith("novel") for t in want_tf)
    check(np.array_equal(got_tf, np.asarray(exp_tf, np.float32))
          and novel > 0 and m.docfreq(f"novel{9}") == 1,
          f"termfreqs of the 1,000 mutated rows: {len(exp_tf)} (row, term) "
          f"pairs over {len(want_tf)} terms ({novel} new to the "
          "vocabulary) equal the new documents' counts, 0 for the terms "
          "each row lost")
    check(same_ranked(arr.score_batch(smix, top_k=TOP_K), mix_ref),
          "the body index itself still answers the serving mix as before "
          "the mutation of its copy")
    slice_counts = {k: getattr(kc, k).launches for k in counted
                    if k not in ("similarity", "compose")}
    slice_counts["similarity"] = k10_slice.launches
    slice_counts["compose"] = k11_slice.launches
    kc.similarity, kc.compose = k10_slice.orig, k11_slice.orig
    for k in counted:
        getattr(kc, k).launches = saved_counts[k] + slice_counts[k]
    print(f"persistence, pickling and mutation path launches: "
          f"{slice_counts}", flush=True)
    check(all(slice_counts[k] > 0 for k in (
        "score_term", "plane_fill", "phrase_chain", "topk", "similarity",
        "compose"))
          and k10_slice.calls == k10_slice.launches
          and k11_slice.calls == k11_slice.launches,
          "that path launched K1, K3, K4, K5, K10 and K11, each K10 and K11 "
          "launch equal to its plain version bit for bit")
    slice_evidence = [
        ("save_index of the 1M body index: s; bytes on disk",
         f"{save_s}; {store_bytes}"),
        ("load_index(mmap=True) s", load_s),
        ("attach s: from the store's planes; deriving them in memory",
         f"{attach_store_s}; {attach_mem_s}"),
        ("pickle of the memory-mapped 1M title index: bytes; its postings' "
         "bytes (not in it); its doc-term matrix's bytes (in it); dumps + "
         "loads s", f"{pickle_bytes}; {t_post.data.nbytes}; "
         f"{tarr._built.doc_term.nbytes}; {pickle_s}"),
        ("__setitem__ of 1,000 rows s; re-attach s",
         f"{setitem_s}; {reattach_s}"),
    ]
    del m, mdev, donor, tv
    phase_done("persistence, pickling, mutation")

    # ---- 3c. this slice's path, counted: doc-axis sharding on one card.
    # A 4 x 2 mesh of this card (4 doc shards, 2 query parts each): the
    # body index's BuiltIndex partitioned and attached, the title corpus
    # indexed with mesh=, the serving mix, the mixed request with slop and
    # the term batch ranked through the shards' K3 and the K3 merge;
    # freqs; rows= in an unsorted order; edismax on the sharded frame; the
    # long-document index on 4 shards (K2, K7, K9 per shard); the shard
    # store saved and loaded.  Every reference it is held to was computed
    # before the counts were zeroed, so the counts are this path's alone.
    from searcharray_tpu_torch.parallel import sharded as sharded_mod
    from searcharray_tpu_torch.utils.profiling import hbm_report

    S, QA = 4, 2
    mesh = sharded_mod.default_mesh(devices=[torch.device(DEVICE)] * (S * QA))
    tid_of = arr.term_dict.get_term_id
    drivers = {}
    if args.parent_tree:
        # the earlier checkout's sharded driver and this tree's, each in a
        # process of its own, on the body store saved above and the title
        # index's (their start, their kernels' build and their first calls
        # overlap this phase's checks)
        title_store = tempfile.mkdtemp(prefix="sa_title_store_")
        atexit.register(shutil.rmtree, title_store, True)
        store.save_index(tarr._built, title_store)
        spec = {"devices": S * QA, "k": TOP_K,
                "stores": {"title": title_store, "body": store_dir},
                "mix": [smix, 0], "req": [list(sq), [int(x) for x in ss]],
                "ed": ED_QUERIES, "ed_kw": ED_KW}
        for label, tree in (("parent", args.parent_tree), ("new", REPO)):
            drivers[label] = ShardDriver(
                tree, spec, os.path.join(title_store, f"{label}.json"))
    qt_mix = [arr._resolve_tids(arr._check_token_arg(q)) for q in smix]
    rows_u = np.random.default_rng(77).choice(n, 20000, replace=False)
    rows_ref = batch.score_batch_fused(dev, qt_mix, as_device=True)[
        :, torch.as_tensor(rows_u, device=dev.device)]
    ed_slop_ref = [edismax(df, q=q, top_k=TOP_K, **ED_KW, **ED_SLOP)[0]
                   for q in ED_QUERIES]
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in counted:
        saved_counts[k] = getattr(kc, k).launches
        getattr(kc, k).launches = 0
    k10_sh, k11_sh = K10Recorder(kc), K11Recorder(kc)
    kc.similarity, kc.compose = k10_sh, k11_sh
    # every kernel launch of this path is held to its plain version as it
    # runs (K10 and K11 by their recorders, K1-K9 by PlainCheck, which
    # stands in for the kernel module in each module of the engine); while
    # ``on``, K3 notes the width of every block the sharded rankings rank
    # (a shard's, or a merge of the shards' candidates, kept for phase 5)
    engine_mods = (batch, cand, dense, phrase, spans_mod, scoring,
                   sharded_mod)
    sh_check = PlainCheck(kc, S)
    for mod in engine_mods:
        mod.kernels_cuda = sh_check
    merges0, shard_k3s0 = (sharded_mod.TOPK_MERGES[0],
                           sharded_mod.SHARD_TOPKS[0])
    # every sharded scoring call goes through _batch_blocks once: each
    # must plan once (one lane: the mesh's two query parts share the card)
    plans0, blocks_calls = sharded_mod.PLANS[0], [0]
    batch_blocks = sharded_mod.ShardedIndex._batch_blocks

    def counted_blocks(self, *a, **kw):
        blocks_calls[0] += 1
        return batch_blocks(self, *a, **kw)

    sharded_mod.ShardedIndex._batch_blocks = counted_blocks
    # ShardedIndex.build, the call SearchArray.index(mesh=) makes, its
    # partition timed inside it; the sharded runtime then rides on a copy
    # of the body array as index(mesh=) attaches it (the title corpus
    # below goes through index(mesh=) itself)
    partition_s = []
    partition = sharded_mod._partition

    def timed_partition(*a, **kw):
        t0 = time.perf_counter()
        try:
            return partition(*a, **kw)
        finally:
            partition_s.append(time.perf_counter() - t0)

    sharded_mod._partition = timed_partition
    try:
        t0 = time.perf_counter()
        sh = sharded_mod.ShardedIndex.build(arr._built, mesh=mesh)
        torch.cuda.synchronize()
        sh_build_s = time.perf_counter() - t0
    finally:
        sharded_mod._partition = partition
    partition_s = partition_s[0]
    sh_attach_s = sh_build_s - partition_s
    sbody = arr.copy()
    sbody._state.sharded = sh
    t0 = time.perf_counter()
    stitle = SearchArray.index(titles, device=DEVICE, mesh=mesh,
                               autowarm=False)
    torch.cuda.synchronize()
    stitle_s = time.perf_counter() - t0
    del titles
    print(f"sharded body index: ShardedIndex.build {sh_build_s:.3f} s "
          f"(partition {partition_s:.3f} s, attach {sh_attach_s:.3f} s), "
          f"shard sizes {sh.shard_sizes.tolist()}; title corpus indexed "
          f"with mesh= in {stitle_s:.3f} s", flush=True)
    check(sh.blk_bits == dev.blk_bits and sh.num_shards == S
          and sh.shard_sizes.sum() == n
          and all(len(r) == 1
                  and r[0].device == device_mod.canonical_device(DEVICE)
                  for r in sh.shards + stitle._state.sharded.shards)
          and all(d.pool_share == S for d in sh.device_indexes()),
          f"the body index partitioned into {S} shards of "
          f"{sh.shard_sizes.tolist()} docs on a {S} x {QA} mesh of one card "
          "(the two entries of a row share one DeviceIndex; four shards "
          "divide its pools' budgets), blk_bits the corpus's")

    sh_check.on = True
    sh_mix =sbody.score_batch(smix, top_k=TOP_K)
    sh_terms = sbody.score_batch(term_q, top_k=TOP_K)
    sh_req = sbody.score_batch(sq, top_k=TOP_K, slop=ss)
    sh_check.on = False
    sh_tf = sh.score_batch_device([[tid_of("what")], [tid_of("w4095")]],
                                  kind="none").cpu().numpy()
    sh_ph4 = sh.phrase_freqs(ph4).cpu().numpy()
    sh_slop = [sh.span_freqs(q, SLOP).cpu().numpy() for q in slop_shapes[:3]]
    sh_wide = sh.span_freqs(wide_q, wide_slop).cpu().numpy()
    sh_rows = sh.score_batch_device(qt_mix, rows=rows_u)
    sdf = pd.DataFrame({"title": stitle, "body": sbody})
    sh_ed = [edismax(sdf, q=q, top_k=TOP_K, **ED_KW)[0] for q in ED_QUERIES]
    sh_eds = [edismax(sdf, q=q, top_k=TOP_K, **ED_KW, **ED_SLOP)[0]
              for q in ED_QUERIES]
    sh_edb = edismax_batch(sdf, ED_QUERIES, top_k=TOP_K, **ED_KW,
                           **ED_SLOP)[0]
    # the shards' tensors and pools once they have served
    sh_bytes = {k: v for k, v in hbm_report(sbody).items()
                if k.startswith(("sharded.", "index.total"))}
    print(f"hbm_report of the sharded body array: {sh_bytes}", flush=True)
    # the long-document index on 4 shards: the long doc lands in shard 0,
    # and no shard's planes fit (blk_bits 14 is the corpus's), so terms
    # take K2, phrases K7 + K2 and slop phrases K9 + K2 per shard
    lsh = sharded_mod.ShardedIndex.build(larr._built, mesh=mesh)
    slarr = larr.copy()
    slarr._state.sharded = lsh
    sh_check.on = True
    sh_lmix = slarr.score_batch(lmix, top_k=TOP_K)
    sh_lreq = slarr.score_batch(lsq, top_k=TOP_K, slop=lss)
    sh_check.on = False
    # the shard store: the partition saved beside the body index's store
    # (3b), loaded memory-mapped and attached as it is
    t0 = time.perf_counter()
    store.save_shards(arr._built, store_dir, S)
    save_sh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shl = sharded_mod.ShardedIndex.load(store_dir, mesh=mesh)
    torch.cuda.synchronize()
    load_sh_s = time.perf_counter() - t0
    sh_check.on = True
    shl_mix = shl.topk(qt_mix, TOP_K)
    sh_check.on = False
    shl_mix = (shl_mix[0].cpu().numpy(), shl_mix[1].cpu().numpy())
    torch.cuda.synchronize()
    for mod in engine_mods:
        mod.kernels_cuda = kc
    sharded_mod.ShardedIndex._batch_blocks = batch_blocks
    sh_plans = sharded_mod.PLANS[0] - plans0
    sh_counts = {k: getattr(kc, k).launches for k in counted
                 if k not in ("similarity", "compose")}
    sh_counts["similarity"] = k10_sh.launches
    sh_counts["compose"] = k11_sh.launches
    sh_merges = sharded_mod.TOPK_MERGES[0] - merges0
    sh_shard_k3s = sharded_mod.SHARD_TOPKS[0] - shard_k3s0
    sh_peak = torch.cuda.max_memory_allocated()
    kc.similarity, kc.compose = k10_sh.orig, k11_sh.orig
    for k in counted:
        getattr(kc, k).launches = saved_counts[k] + sh_counts[k]
    print(f"sharded path launches: {sh_counts}; K3 on shard blocks "
          f"{sh_shard_k3s}, K3 merges {sh_merges}", flush=True)
    check(sh_plans == blocks_calls[0] > 0,
          f"the sharded path planned each of its {blocks_calls[0]} batches "
          f"once for all {S} shards ({sh_plans} plans: 1 a call)")
    # a wrapper called with no work returns without a launch, so each
    # kernel's held calls are at least its launches
    held_of = {"score_term": "K1", "score_term_rows": "K1 rows",
               "segment_sum": "K2", "topk": "K3", "plane_fill": "K4",
               "phrase_chain": "K5", "span_window": "K6",
               "merge_step": "K7", "cand_rows": "K8a", "cand_minis": "K8b",
               "span_sparse": "K9", "rank_rows": "K3+K10"}
    check(all(sh_counts[k] > 0 for k in (
        "segment_sum", "plane_fill", "phrase_chain", "merge_step", "topk",
        "span_window", "span_sparse", "similarity", "compose"))
          and sh_counts["score_term"] + sh_counts["score_term_rows"] > 0
          and all(sh_check.calls[h] >= sh_counts[k]
                  for k, h in held_of.items())
          and k10_sh.calls == k10_sh.launches
          and k11_sh.calls == k11_sh.launches,
          "the sharded path launched K1, K2, K3, K4, K5, K6, K7, K9, K10 and "
          "K11 on the card, every launch equal to its plain version on the "
          f"same inputs bit for bit (K1-K9 calls held {dict(sh_check.calls)},"
          f" at {sum(map(len, sh_check.shapes.values()))} distinct shapes; "
          f"largest differences {dict(sh_check.err)})")
    shard_widths = set(sh.shard_sizes.tolist()) | set(
        lsh.shard_sizes.tolist())
    k3_widths, merge_calls = sh_check.widths, sh_check.merges
    narrow = [w for w in k3_widths if w not in shard_widths]
    check(sh_merges == len(narrow) == len(merge_calls) > 0
          and max(narrow) <= S * TOP_K
          and n not in k3_widths and len(larr) not in k3_widths,
          f"every K3 merge ranked at most S * k = {S * TOP_K} candidates a "
          f"query ({sh_merges} merges of widths {sorted(set(narrow))}); "
          f"the {len(k3_widths) - len(narrow)} other K3 calls each ranked "
          "one shard's block, none the whole doc axis")

    check(same_ranked(sh_mix, mix_ref) and same_ranked(sh_terms, terms_ref)
          and same_ranked(sh_req, slop_runs[0]),
          f"the sharded body index answers the serving mix ({len(smix)} "
          f"queries), the term batch ({len(term_q)}) and the mixed request "
          f"with slop ({len(sq)}) as the unsharded index does, scores and "
          "indices bit for bit")
    check_ranking(dev, sq, *sh_req, "the sharded mixed request with slop",
                  slops=ss)
    check_ranking(dev, term_q, *sh_terms, "the sharded term batch")
    check(all(np.array_equal(sh_tf[i], oracle_tf(post, tid_of(t), n))
              for i, t in enumerate(("what", "w4095")))
          and np.array_equal(sh_ph4, oracle_phrase_freqs(dev, ph4))
          and all(np.array_equal(g, w) for g, w in zip(sh_slop, slop_freqs))
          and np.array_equal(sh_wide, f_wide),
          "sharded tf of 'what' and 'w4095', phrase freqs of "
          f"{ph4}, slop freqs of {len(sh_slop)} slop shapes and of {wide_q} "
          f"at slop {wide_slop} equal the oracle (and the unsharded "
          "index's) exactly")
    check(torch.equal(sh_rows.view(torch.int32), rows_ref.view(torch.int32)),
          f"sharded rows= on {len(rows_u)} doc ids in random order equals "
          "the unsharded scores at those columns bit for bit")
    check(all(same_ranked(a, b) for a, b in zip(sh_ed, ed_ref))
          and all(same_ranked(a, b) for a, b in zip(sh_eds, ed_slop_ref))
          and all(same_ranked((sh_edb[0][i], sh_edb[1][i]), sh_eds[i])
                  for i in range(len(ED_QUERIES))),
          f"edismax(top_k={TOP_K}) over the sharded title and body fields, "
          "exact and ps=2, ps2=1, equals the unsharded frame's bit for bit; "
          "edismax_batch there takes the per-query form")
    check_edismax(devs, ED_QUERIES, sh_ed,
                  f"sharded edismax(top_k={TOP_K})", TOP_K)
    check_edismax(devs, ED_QUERIES[:6], sh_eds[:6],
                  f"sharded edismax(top_k={TOP_K}, ps=2, ps2=1)", TOP_K,
                  **ED_SLOP)
    check(same_ranked(sh_lmix, (lm_scores, lm_idx))
          and same_ranked(sh_lreq, (ls_scores, ls_idx))
          and lsh.shard_sizes[0] > 0
          and not any(dense.dense_eligible(d) for d in lsh.device_indexes()),
          f"the long-document index on {S} shards answers its serving mix "
          f"({len(lmix)} queries) and its request with slop ({len(lsq)}) "
          "as the unsharded index does, bit for bit (held to the oracle "
          "above)")
    check(all(torch.equal(a.hdrs, b.hdrs) and torch.equal(a.pays, b.pays)
              for a, b in zip(shl.device_indexes(), sh.device_indexes()))
          and same_ranked(shl_mix, mix_ref),
          f"save_shards wrote shards-S{S} in {save_sh_s:.3f} s; "
          f"ShardedIndex.load attached it in {load_sh_s:.3f} s, its planes "
          "torch.equal to the built shards', and answers the serving mix "
          "bit for bit")
    del shl, shl_mix, sh_rows, rows_ref

    # sharded against unsharded on the same card, in turns (unsharded,
    # sharded, sharded, unsharded): the serving mix and the mixed request
    # with slop, queries/s of 5 calls a turn; edismax p50
    def qps_turn(a, queries, slops):
        t0 = time.perf_counter()
        for _ in range(5):
            a.score_batch(queries, top_k=TOP_K, slop=slops)
        return 5 * len(queries) / (time.perf_counter() - t0)

    # the peak of serving alone: the counted path's above includes the
    # plain versions' temporaries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sh_qps = {"serving mix": {"unsharded": [], "sharded": []},
              "mixed request with slop": {"unsharded": [], "sharded": []}}
    for label, a in (("unsharded", arr), ("sharded", sbody),
                     ("sharded", sbody), ("unsharded", arr)):
        sh_qps["serving mix"][label].append(qps_turn(a, smix, 0))
        sh_qps["mixed request with slop"][label].append(qps_turn(a, sq, ss))
    sh_ed_ms = {}
    for label, frame in (("unsharded", df), ("sharded", sdf),
                         ("sharded", sdf), ("unsharded", df)):
        for q in ED_QUERIES:
            t0 = time.perf_counter()
            edismax(frame, q=q, top_k=TOP_K, **ED_KW)
            sh_ed_ms.setdefault(label, []).append(
                (time.perf_counter() - t0) * 1e3)
    sh_ed_p50 = {k: float(np.median(v)) for k, v in sh_ed_ms.items()}
    serve_peak = torch.cuda.max_memory_allocated()
    print(f"sharded qps in turns: {sh_qps}; edismax p50 ms {sh_ed_p50}",
          flush=True)

    # where one serving-mix call's host time goes: the plan (dedup,
    # classify, chunks, waves, slots), each shard's run (fills and
    # launches enqueued) and its placing, on the sharded index and on the
    # unsharded one (its plan and its one run)
    host_ms = {"plan": [], "run": [], "assemble": []}
    stages = {k: getattr(batch, k) for k in ("plan_batch", "run_plan",
                                             "assemble")}

    def timed_stage(name, fn):
        def f(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host_ms[name].append((time.perf_counter() - t0) * 1e3)
        return f

    breakdown = {}
    for label, a in (("sharded", sbody), ("unsharded", arr)):
        for v in host_ms.values():
            v.clear()
        for k, fn in stages.items():
            setattr(batch, k, timed_stage(k.split("_")[0], fn))
        try:
            plans0 = sharded_mod.PLANS[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.score_batch(smix, top_k=TOP_K)
            call_ms = (time.perf_counter() - t0) * 1e3
            plans = sharded_mod.PLANS[0] - plans0
        finally:
            for k, fn in stages.items():
                setattr(batch, k, fn)
        breakdown[label] = {"call_ms": call_ms, "plans": plans,
                            **{k: list(v) for k, v in host_ms.items()}}
    check(breakdown["sharded"]["plans"] == 1
          and len(breakdown["sharded"]["plan"]) == 1
          and len(breakdown["sharded"]["run"]) == S,
          "one sharded serving-mix call: 1 plan, run on each of the "
          f"{S} shards; host ms {breakdown['sharded']} (unsharded "
          f"{breakdown['unsharded']})")

    # the earlier checkout's sharded driver against this tree's, each in
    # a process of its own, in turns (parent, new, new, parent, twice):
    # the serving mix, the mixed request with slop (queries/s of 5 calls
    # a turn) and edismax (ms a call)
    parent_turns = None
    if drivers:
        new_v, new_i = sbody.score_batch(smix, top_k=TOP_K)
        for label, drv in drivers.items():
            pv, pi = drv.ask("check")
            check(np.array_equal(np.asarray(pi), new_i)
                  and np.array_equal(np.asarray(pv), new_v.view(np.int32)),
                  f"the {label} sharded driver's process ranks the serving "
                  "mix as this process does, bit for bit (ready after "
                  f"{drv.ready_s:.1f} s: kernels built, stores loaded and "
                  "sharded, three warm-up passes)")
        parent_turns = {"serving mix": {"parent": [], "new": []},
                        "mixed request with slop": {"parent": [], "new": []},
                        "edismax ms": {"parent": [], "new": []}}
        for label in ("parent", "new", "new", "parent") * 2:
            drv = drivers[label]
            parent_turns["serving mix"][label].append(drv.ask("mix"))
            parent_turns["mixed request with slop"][label].append(
                drv.ask("req"))
            parent_turns["edismax ms"][label] += drv.ask("ed")
        for drv in drivers.values():
            drv.close()
        parent_turns["edismax p50 ms"] = {
            k: float(np.median(v))
            for k, v in parent_turns.pop("edismax ms").items()}
        print(f"sharded driver, parent against new, each in its own "
              f"process, in turns: {parent_turns}", flush=True)
    sharded_evidence = [
        ("plans of the counted sharded path; its sharded calls",
         f"{sh_plans}; {blocks_calls[0]}"),
        ("one serving-mix call, host ms: the call; the plan; each shard's "
         "run; each shard's assemble (sharded | unsharded)",
         "; ".join(f"{breakdown[k]['call_ms']}, {breakdown[k]['plan']}, "
                   f"{breakdown[k]['run']}, {breakdown[k]['assemble']}"
                   for k in ("sharded", "unsharded"))),
        ("sharded driver, each in its own process, in turns (parent, new, "
         "new, parent, twice; 5 calls a turn): serving mix qps; mixed "
         "request qps; edismax p50 ms", parent_turns),
        ("sharded body index: partition s; attach s; title corpus indexed "
         "with mesh= s", f"{partition_s}; {sh_attach_s}; {stitle_s}"),
        ("sharded body index: hbm_report sharded.* bytes", sh_bytes),
        ("shard store: save_shards s; ShardedIndex.load s",
         f"{save_sh_s}; {load_sh_s}"),
        ("sharded path launches; K3 on shard blocks; K3 merges",
         f"{sh_counts}; {sh_shard_k3s}; {sh_merges}"),
        ("serving mix qps in turns (unsharded, sharded, sharded, "
         "unsharded), 5 calls a turn", sh_qps["serving mix"]),
        ("mixed request with slop qps in turns",
         sh_qps["mixed request with slop"]),
        ("edismax(top_k=10) p50 ms: unsharded frame; sharded frame",
         f"{sh_ed_p50['unsharded']}; {sh_ed_p50['sharded']}"),
        ("device bytes allocated before the sharded path; its peak (the "
         "plain checks' temporaries included); the peak while the qps and "
         "edismax turns served", f"{mem_before}; {sh_peak}; {serve_peak}"),
    ]
    del sdf, stitle, sbody, slarr, sh, lsh
    phase_done("doc-axis sharding on one card")

    # ---- 3d. this slice's path, counted: the serving warm-up.  A fresh
    # attach of the body index's BuiltIndex (empty pools) warmed by
    # warm_serving(), its launches read apart, then its first serving-mix
    # call; and the first call on a second fresh attach as it is.  Every
    # launch is held to its plain version as it runs, as in 3c.  Then two
    # more fresh attaches, not held, time the first call as it is and
    # after warm_serving: this process has loaded every kernel by now, so
    # what warming saves here is the pools' fills and the allocator's
    # growth, not the library's build or the modules' first loads.
    def fresh_attach():
        fresh = SearchArray([], tokenizer=arr.tokenizer, device=DEVICE)
        fresh._attach(_IndexState(arr._built, DEVICE))
        fresh.dev  # attach: upload the posting planes
        torch.cuda.synchronize()
        return fresh

    saved_counts = {k: getattr(kc, k).launches for k in counted}
    for k in counted:
        getattr(kc, k).launches = 0
    k10_warm, k11_warm = K10Recorder(kc), K11Recorder(kc)
    kc.similarity, kc.compose = k10_warm, k11_warm
    w_check = PlainCheck(kc, 1)
    for mod in engine_mods:
        mod.kernels_cuda = w_check
    try:
        fresh = fresh_attach()
        n_warm = fresh.warm_serving()
        # (the recorders stand in for K10 and K11, so their counts read)
        warm_only = {k: getattr(kc, k).launches for k in counted}
        held_first = {"after warm_serving": fresh.score_batch(
            smix, top_k=TOP_K)}
        fresh = fresh_attach()
        held_first["as it is"] = fresh.score_batch(smix, top_k=TOP_K)
        del fresh
        torch.cuda.synchronize()
        warm_counts = {k: getattr(kc, k).launches for k in counted}
    finally:
        for mod in engine_mods:
            mod.kernels_cuda = kc
        kc.similarity, kc.compose = k10_warm.orig, k11_warm.orig
    for k in counted:
        getattr(kc, k).launches = saved_counts[k] + warm_counts[k]
    for label, first in held_first.items():
        check(same_ranked(first, mix_ref),
              f"the first serving-mix call on a fresh attach ({label}) "
              "ranks as the main path's index does, bit for bit")
    print(f"warm-up path launches: warm_serving alone {warm_only}; with "
          f"the two first calls {warm_counts}", flush=True)
    check(n_warm > 0 and all(warm_only[k] > 0 for k in (
        "score_term_rows", "plane_fill", "phrase_chain", "span_window",
        "rank_rows")),
          f"warm_serving issued its {n_warm} queries through score_batch: "
          "K1, K4, K5, K6 and the fused ranking pass (K3 with K10 inside) "
          "launched, counted before any first call")
    check(all(w_check.calls[h] >= warm_counts[k]
              for k, h in held_of.items())
          and k10_warm.calls == k10_warm.launches
          and k11_warm.calls == k11_warm.launches,
          "every launch of the warm-up path (warm_serving and the two "
          "first calls) equal to its plain version on the same inputs bit "
          f"for bit (K1-K9 calls held {dict(w_check.calls)}, K10 "
          f"{k10_warm.calls}, K11 {k11_warm.calls}; largest differences "
          f"{dict(w_check.err)}, K10 {k10_warm.err}, K11 {k11_warm.err})")
    first_ms = {}
    for label in ("as it is", "after warm_serving"):
        fresh = fresh_attach()
        if label != "as it is":
            t0 = time.perf_counter()
            n_timed = fresh.warm_serving()
            torch.cuda.synchronize()
            warm_serving_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = fresh.score_batch(smix, top_k=TOP_K)
        first_ms[label] = (time.perf_counter() - t0) * 1e3
        check(same_ranked(first, mix_ref),
              f"the timed first serving-mix call on a fresh attach "
              f"({label}) ranks as the main path's index does, bit for bit")
        del fresh, first
    # the same in new processes (one at a time, from this tree, on the body
    # store): there the first call also loads the kernel library and each
    # kernel's module and grows the allocator and the pinned buffers
    fresh_proc = {}
    for label, warm in (("as it is", False), ("after warm_serving", True)):
        proc = run_snippet(FIRST_CALL, REPO, {
            "store": store_dir, "mix": smix, "k": TOP_K, "warm": warm},
            os.path.join(store_dir, "first_call.json"))
        fresh_proc[label] = json_line(proc)
        proc.stdin.close()
        proc.wait(timeout=300)
        check(np.array_equal(np.asarray(fresh_proc[label].pop("idx")),
                             mix_ref[1])
              and np.array_equal(np.asarray(fresh_proc[label].pop("bits")),
                                 mix_ref[0].view(np.int32)),
              f"a new process's first serving-mix call ({label}) ranks as "
              "the main path's index does, scores and indices bit for bit")
    print(f"first serving-mix call on a fresh attach of the body index: "
          f"{first_ms['as it is']:.3f} ms as it is, "
          f"{first_ms['after warm_serving']:.3f} ms after warm_serving; in "
          f"a new process: {fresh_proc} {tag}", flush=True)
    print(f"warm_serving on the 1M body index: {n_warm} queries in "
          f"{warm_serving_s:.3f} s (in a new process: "
          f"{fresh_proc['after warm_serving']['warm_queries']} in "
          f"{fresh_proc['after warm_serving']['warm_s']:.3f} s)", flush=True)
    check(n_timed == n_warm
          == fresh_proc["after warm_serving"]["warm_queries"],
          f"warm_serving issued {n_warm} queries on each fresh attach, in "
          "this process and in a new one")
    warm_evidence = [
        ("first serving-mix call on a fresh attach of the body index, ms: "
         "as it is; after warm_serving",
         f"{first_ms['as it is']}; {first_ms['after warm_serving']}"),
        ("a new process on the body store: first and second serving-mix "
         "call ms, as it is | after warm_serving (its queries, s)",
         f"{fresh_proc['as it is']} | {fresh_proc['after warm_serving']}"),
        ("warm_serving on the 1M body index: queries; s",
         f"{n_warm}; {warm_serving_s}"),
        ("warm-up path launches (held): warm_serving alone; with the two "
         "first calls", f"{warm_only}; {warm_counts}"),
    ]
    phase_done("serving warm-up")

    # ---- 3e. this slice's path, counted: concurrent queries.  Thread i
    # serves a serving mix, a mixed request with slop and an
    # edismax(ps=2, ps2=1) of its own on the body index and the edismax
    # frame; 8 threads at once on the default stream, then 8 threads each
    # on a stream of its own.  Every launch is held to its plain version
    # as it runs (as in 3c) and every result to the same calls made
    # serially before the counts were zeroed, bit for bit.  Then a
    # threaded run under the profiler, whose kernel events must equal the
    # wrappers' counts, and, not held, qps from 1, 2, 4 and 8 threads on
    # both kinds of stream beside the slot maps' hold time per call.
    T_MAX = THREAD_COUNTS[-1]
    thr_mix = [serving_queries(6000 + i) for i in range(T_MAX)]
    thr_req = [mixed_request(6100 + i) for i in range(T_MAX)]
    thr_ed = [ED_QUERIES[i % len(ED_QUERIES)] for i in range(T_MAX)]
    thr_calls = {
        "serving mix": lambda i: arr.score_batch(thr_mix[i], top_k=TOP_K),
        "mixed request with slop": lambda i: arr.score_batch(
            thr_req[i][0], top_k=TOP_K, slop=thr_req[i][1]),
        "edismax ps=2 ps2=1": lambda i: edismax(
            df, q=thr_ed[i], top_k=TOP_K, **ED_KW, **ED_SLOP)[0],
    }

    def thread_item(i):
        return [fn(i) for fn in thr_calls.values()]

    # the serial oracle: each thread's calls, one after another
    thr_ref = [thread_item(i) for i in range(T_MAX)]
    thr_streams = [torch.cuda.Stream(dev.device) for _ in range(T_MAX)]

    def run_threads(n_t, fn, own_stream):
        """fn(i) on n_t threads started together, each on the default
        stream or on a stream of its own (waited for before the thread
        ends); their results in thread order."""
        out, errors = [None] * n_t, []
        start = threading.Barrier(n_t)

        def worker(i):
            try:
                start.wait()
                if own_stream:
                    with torch.cuda.stream(thr_streams[i]):
                        out[i] = fn(i)
                    thr_streams[i].synchronize()
                else:
                    out[i] = fn(i)
            except BaseException as e:  # noqa: BLE001 (raised below)
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_t)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a thread did not finish in 300 s")
        if errors:
            raise AssertionError(f"threads raised: {errors}")
        return out

    def same_items(got, want):
        return all(same_ranked(g, w) for g, w in zip(got, want))

    torch.cuda.synchronize()
    for k in counted:
        saved_counts[k] = getattr(kc, k).launches
        getattr(kc, k).launches = 0
    k10_thr, k11_thr = K10Recorder(kc), K11Recorder(kc)
    kc.similarity, kc.compose = k10_thr, k11_thr
    t_check = PlainCheck(kc, 1)
    for mod in engine_mods:
        mod.kernels_cuda = t_check
    try:
        t0 = time.perf_counter()
        held_thr = {own: run_threads(T_MAX, thread_item, own)
                    for own in (False, True)}
        torch.cuda.synchronize()
        held_thr_s = time.perf_counter() - t0
        thr_counts = {k: getattr(kc, k).launches for k in counted}
    finally:
        for mod in engine_mods:
            mod.kernels_cuda = kc
        kc.similarity, kc.compose = k10_thr.orig, k11_thr.orig
    for k in counted:
        getattr(kc, k).launches = saved_counts[k] + thr_counts[k]
    print(f"concurrent-query path launches: {thr_counts}", flush=True)
    for own, got in held_thr.items():
        check(all(same_items(got[i], thr_ref[i]) for i in range(T_MAX)),
              f"{T_MAX} threads on one index "
              f"({'each on its own stream' if own else 'the default stream'})"
              f", each serving {', '.join(thr_calls)}: every result equal "
              "to the same calls made serially, scores and indices bit for "
              "bit")
    # the cross-stream order (not counted): a fresh attach of the body
    # index with pools of 24 tf and 12 plane rows, so the threads' waves
    # evict each other's rows, and 8 threads on streams of their own; the
    # odd threads' streams sleep on the card after each pool fill, so
    # their reads run long after they released the maps while an even
    # thread's evicting fills start on an idle stream: only the maps'
    # event orders those fills after the reads
    fill_rows = dense.fill_rows
    slow = {thr_streams[i].cuda_stream for i in range(1, T_MAX, 2)}

    def slow_reads(dev_, fill):
        fill_rows(dev_, fill)
        if torch.cuda.current_stream(dev_.device).cuda_stream in slow:
            torch.cuda._sleep(THREAD_DELAY_CYCLES)

    pool_caps = dense.TF_POOL_MAX_SLOTS, dense.PLANE_POOL_MAX_SLOTS
    dense.TF_POOL_MAX_SLOTS, dense.PLANE_POOL_MAX_SLOTS = 24, 12
    dense.fill_rows = slow_reads
    try:
        small = fresh_attach()
        t0 = time.perf_counter()
        delayed = run_threads(T_MAX, lambda i: [
            small.score_batch(thr_mix[i], top_k=TOP_K),
            small.score_batch(thr_req[i][0], top_k=TOP_K,
                              slop=thr_req[i][1])], True)
        delayed_s = time.perf_counter() - t0
        small_maps = small.dev.maps
    finally:
        dense.fill_rows = fill_rows
        dense.TF_POOL_MAX_SLOTS, dense.PLANE_POOL_MAX_SLOTS = pool_caps
    del small
    check((small_maps.tf_cap, small_maps.plane_cap) == (24, 12)
          and all(same_items(delayed[i], thr_ref[i][:2])
                  for i in range(T_MAX)),
          f"{T_MAX} threads, each on its own stream, on a fresh attach "
          "with pools of 24 tf and 12 plane rows, the odd threads' reads "
          "delayed on the card after each pool fill: every serving mix and "
          "mixed request equal to the serial calls, bit for bit "
          f"({small_maps.holds} holds, {delayed_s:.3f} s)")
    check(all(thr_counts[k] > 0 for k in (
        "plane_fill", "phrase_chain", "span_window", "topk", "similarity",
        "compose"))
          and all(t_check.calls[h] >= thr_counts[k]
                  for k, h in held_of.items())
          and k10_thr.calls == k10_thr.launches
          and k11_thr.calls == k11_thr.launches,
          "the concurrent-query path launched K3, K4, K5, K6, K10 and K11 "
          "from its threads, every launch equal to its plain version on the "
          f"same inputs bit for bit (K1-K9 calls held {dict(t_check.calls)}"
          f", K10 {k10_thr.calls}, K11 {k11_thr.calls}; largest differences "
          f"{dict(t_check.err)}, K10 {k10_thr.err}, K11 {k11_thr.err}) in "
          f"{held_thr_s:.3f} s")

    # qps from 1, 2, 4 and 8 threads; hold time per call of the body
    # index's maps against the call's wall time (not held)
    body_maps = dev.maps
    thr_qps, thr_hold = {}, {}
    for label, fn in thr_calls.items():
        n_q = {"serving mix": len(thr_mix[0]),
               "mixed request with slop": len(thr_req[0][0]),
               "edismax ps=2 ps2=1": 1}[label]
        col = list(thr_calls).index(label)
        for own in (False, True):
            for n_t in THREAD_COUNTS:
                wall_per = [0.0] * n_t

                def calls_of(i):
                    t_in = time.perf_counter()
                    got = [fn(i) for _ in range(THREAD_CALLS)]
                    wall_per[i] = (time.perf_counter() - t_in) / THREAD_CALLS
                    return got

                holds0, held0 = body_maps.holds, body_maps.hold_seconds
                t0 = time.perf_counter()
                outs = run_threads(n_t, calls_of, own)
                wall = time.perf_counter() - t0
                check(all(same_ranked(g, thr_ref[i][col])
                          for i in range(n_t) for g in outs[i]),
                      f"{label} from {n_t} threads "
                      f"({'own streams' if own else 'default stream'}): "
                      "every result bit-equal to the serial calls")
                n_holds = body_maps.holds - holds0
                key = (label, "own streams" if own else "default stream",
                       n_t)
                thr_qps[key] = n_t * THREAD_CALLS * n_q / wall
                thr_hold[key] = (
                    (body_maps.hold_seconds - held0) * 1e3 / max(1, n_holds),
                    n_holds / (n_t * THREAD_CALLS),
                    float(np.mean(wall_per)) * 1e3)
    for label in thr_calls:
        for mode in ("default stream", "own streams"):
            print(f"concurrent {label} ({mode}): "
                  + "; ".join(
                      f"{n_t} threads {thr_qps[(label, mode, n_t)]:.1f} "
                      f"{'calls' if label.startswith('edismax') else 'queries'}"
                      f"/s, body-index hold "
                      f"{thr_hold[(label, mode, n_t)][0]:.3f} ms x "
                      f"{thr_hold[(label, mode, n_t)][1]:.0f} a call, call "
                      f"wall {thr_hold[(label, mode, n_t)][2]:.3f} ms"
                      for n_t in THREAD_COUNTS) + f" {tag}", flush=True)
    thread_evidence = [
        ("concurrent-query path launches (held)", thr_counts),
        ("concurrent queries: (call, stream, threads) -> queries/s "
         "(edismax: calls/s)", thr_qps),
        ("concurrent queries: (call, stream, threads) -> body-index maps' "
         "hold ms per hold; holds a call; call wall ms", thr_hold),
    ]
    phase_done("concurrent queries")

    # ---- 4. sparse term group (K2) vs dterm ------------------------------
    dense_want = batch.score_batch_fused(
        dev, [[arr.term_dict.get_term_id(t)] for t in TERM_QUERIES])
    sparse_rows = []
    for term in TERM_QUERIES:
        tid = arr.term_dict.get_term_id(term)
        off, length, bucket = dev.term_span(tid)
        idf = scoring.query_idf(dev, "bm25", [tid])
        fn = batch._term_group_fn(dev, 1, bucket, "bm25", 1.2, 0.75, None)
        sparse_rows.append(fn(dev.hdrs, dev.pays, dev.doc_lens,
                              np.float32(avgdl), [off], [length], [idf]))
    sparse = torch.cat(sparse_rows).cpu().numpy()
    check(np.allclose(sparse, dense_want, rtol=1e-6, atol=0),
          "sparse term group (K2) equals the dterm results within rtol 1e-6 "
          f"(max abs err {np.abs(sparse - dense_want).max():.3g})")
    # the K2 launches of those groups (timing unit 2): one per term, each
    # bucket's pad tail a run of equal keys on the row's last slot; and a
    # control of as many keys spread uniformly (unit 3)
    sparse_k2 = []
    for term in TERM_QUERIES:
        off, length, bucket = dev.term_span(arr.term_dict.get_term_id(term))
        sparse_k2.append(k2_inputs(dev, [off], [length], bucket))
    control_k2 = spread_like(sparse_k2)
    for name, calls in (("the 1M sparse term group", sparse_k2),
                        ("its uniform control", control_k2)):
        for flat, fvals, n_out in calls:
            if not torch.equal(kc.segment_sum(flat, fvals, num_docs=n_out),
                               kc.segment_sum_plain(flat, fvals,
                                                    num_docs=n_out)):
                raise AssertionError(f"K2 differs on {name}, "
                                     f"{flat.numel()} keys")
    pad_runs = [longest_run(f) for f, _, _ in sparse_k2]
    check(max(longest_run(f) for f, _, _ in control_k2) <= 32,
          f"K2 equals its plain version exactly on the {len(sparse_k2)} "
          f"launches of the 1M sparse term group "
          f"({sum(f.numel() for f, _, _ in sparse_k2)} keys, longest runs "
          f"{pad_runs}) and on a uniform control with no run over 32")

    # the sparse phrase group on the 1M index, run directly as the term
    # group above (score_batch routes these phrases to the dense engine
    # here): held exactly to the dense engine's rows for the same phrases
    ph_tids_all = [[arr.term_dict.get_term_id(t) for t in q]
                   for q in phrases]
    dphrase_want = torch.as_tensor(
        batch.score_batch_fused(dev, ph_tids_all), device=dev.device)
    sparse_groups = {}
    for qi, tids in enumerate(ph_tids_all):
        spans = phrase.trim_spans(dev, [dev.term_span(t) for t in tids])
        idf = scoring.query_idf(dev, "bm25", tids)
        sparse_groups.setdefault(phrase.chain_key(dev, tids), []).append(
            (qi, [s[0] for s in spans], [s[1] for s in spans], idf))
    k7_before = kc.merge_step.launches
    for (plan_key, pattern), rows in sparse_groups.items():
        freqs = phrase.sparse_chain_freqs(
            dev.hdrs, dev.pays, [r[1] for r in rows], [r[2] for r in rows],
            plan_key, pattern, blk_bits=dev.blk_bits,
            key_stride=batch._npad(n))[:, :n]
        got = batch._phrase_scores(freqs, "bm25", 1.2, 0.75, None,
                                   dev.doc_lens, np.float32(avgdl),
                                   [r[3] for r in rows])
        if not torch.equal(got, dphrase_want[[r[0] for r in rows]]):
            raise AssertionError(f"the sparse phrase group {plan_key} "
                                 "differs from the dense engine")
    steps = sum(max(len(ix) - 1 for _, ix in pk) for pk, _ in sparse_groups)
    check(kc.merge_step.launches - k7_before == steps,
          f"sparse phrase group (K7, K2) equals the dense engine's rows "
          f"exactly on {len(phrases)} phrases in {len(sparse_groups)} "
          f"groups, {steps} K7 launches (one per step index of a group's "
          "longer half)")
    del dphrase_want

    phase_done("sparse term and phrase groups vs the dense engine")

    # ---- 5. kernels vs plain at the main path's shapes --------------------
    k1_err = 0.0
    for term in ("what", "w333", "w4095"):
        tid = arr.term_dict.get_term_id(term)
        h, p = scoring.term_planes(dev, tid)
        idf = scoring.query_idf(dev, "bm25", [tid])
        for kind in ("none", "bm25", "bm25_legacy", "bm25_impact"):
            args = (h, p, dev.doc_lens, idf, np.float32(avgdl))
            kw = dict(num_docs=n, blk_bits=dev.blk_bits, kind=kind)
            got = kc.score_term(*args, **kw)
            want = kc.score_term_plain(*args, **kw)
            err = (got - want).abs().max().item()
            k1_err = max(k1_err, err)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"K1 {term}/{kind} differs: {err}")
    check(True, f"K1 equals its plain version bit for bit (the two-FMA "
          f"similarity in its epilogue) on 3 terms x 4 kinds, max abs err "
          f"{k1_err:.3g}")

    # the multi-row K1 on two waves of tf rows, as ensure_batch fills them:
    # 30 rare query terms (4096-doc blocks) and the batches' dense terms
    # with 20 rare ones ("what" has 2.9M words: 1024-doc blocks), each
    # against its plain version and one single-row launch per row, bit for
    # bit
    kwr = dict(num_docs=n, blk_bits=dev.blk_bits)

    def k1_single(planes, pool):
        return lambda: [kc.score_term(h, p, dev.doc_lens, 0.0, 1.0,
                                      kind="none", out=pool[i], **kwr)
                        for i, (h, p) in enumerate(planes)]

    def k1_rows_fill(fn, rows, pool):
        return lambda: fn(dev.hdrs, dev.pays, *rows[:2], pool, rows[2],
                          **kwr)

    dense_terms = list(dict.fromkeys(
        list(TERM_QUERIES) + [t for q in PHRASE_QUERIES for t in q]))
    k1r_err = 0.0
    waves = {}
    for name, terms, wide in (("rare", rare[:30], True),
                              ("dense and rare", dense_terms + rare[:20],
                               False)):
        tids = [arr.term_dict.get_term_id(t) for t in terms]
        spans = np.asarray([dev.term_span(t)[:2] for t in tids])
        planes = [scoring.term_planes(dev, t) for t in tids]
        rows = (spans[:, 0], spans[:, 1], np.arange(len(tids)))
        pools = [torch.full((len(tids), n), -1.0, device=dev.device)
                 for _ in range(3)]
        k1_rows_fill(kc.score_term_rows, rows, pools[0])()
        k1_rows_fill(kc.score_term_rows_plain, rows, pools[1])()
        k1_single(planes, pools[2])()
        k1r_err = max(k1r_err, (pools[0] - pools[1]).abs().max().item())
        # the kernel's block width: 4096 docs when every row has at most
        # one word per 4 docs (score_term.cu, wide())
        check((int(spans[:, 1].max()) * 4 <= n) == wide
              and torch.equal(pools[0], pools[1])
              and torch.equal(pools[0], pools[2]),
              f"multi-row K1 equals its plain version and {len(tids)} "
              f"single-row K1 launches bit for bit on the tf rows of "
              f"{len(tids)} {name} terms ({int(spans[:, 1].sum())} words, "
              f"{4096 if wide else 1024}-doc blocks)")
        waves[name] = (rows, planes, pools)
    k1_rows, rare_planes, k1_pools = waves["rare"]

    # K2 on the flat keys _flat_segment_sum built for the long-document
    # score_batch: one launch per (term, bucket) group
    k2_calls = long_doc_segment_sums(ldev, TERM_QUERIES)
    check(len(k2_calls) == k2_long,
          f"{len(k2_calls)} rebuilt sparse groups = {k2_long} K2 launches "
          "of the long-document score_batch")
    k2_err = 0.0
    pad = 1 << 30
    tail = (torch.full((4096,), pad, dtype=torch.int32, device=ldev.device),
            torch.ones(4096, dtype=torch.float32, device=ldev.device))
    for flat, fvals, n_out in [
            *k2_calls,
            # the largest group again, with a 2^30 pad tail to drop
            (torch.cat([k2_calls[-1][0], tail[0]]),
             torch.cat([k2_calls[-1][1], tail[1]]), k2_calls[-1][2])]:
        got = kc.segment_sum(flat, fvals, num_docs=n_out)
        want = kc.segment_sum_plain(flat, fvals, num_docs=n_out)
        err = (got - want).abs().max().item()
        k2_err = max(k2_err, err)
        # integer-valued popcounts: exact in any order of adds
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs on {flat.numel()} keys: {err}")
    k2_keys = sum(c[0].numel() for c in k2_calls)
    k2_slots = sum(c[2] for c in k2_calls)
    check(True, f"K2 equals its plain version exactly on the "
          f"{len(k2_calls)} groups of the long-document batch ({k2_keys} "
          f"flat keys, {k2_slots} slots, longest run "
          f"{max(longest_run(c[0]) for c in k2_calls)}) and with a 2^30 pad "
          "tail")

    # K4 on the plane rows of the mixed batch's phrases, all in one launch
    # as ensure_batch fills them, into scratch pools; the rows must also
    # equal the ones the main path left in the plane pool
    ph_tids = list(dict.fromkeys(arr.term_dict.get_term_id(t)
                                 for q in phrases for t in q))
    spans = [dev.term_span(t)[:2] for t in ph_tids]
    k4_rows = (np.asarray([o for o, _ in spans]),
               np.asarray([m for _, m in spans]),
               np.arange(len(ph_tids)))
    NS = dense.plane_size(dev)
    k4_pools = [torch.full((len(ph_tids), NS), -1, dtype=torch.int32,
                           device=dev.device) for _ in range(2)]
    kc.plane_fill(dev.hdrs, dev.pays, *k4_rows, k4_pools[0])
    kc.plane_fill_plain(dev.hdrs, dev.pays, *k4_rows, k4_pools[1])
    k4_err = (k4_pools[0] - k4_pools[1]).abs().max().item()
    check(torch.equal(k4_pools[0], k4_pools[1])
          and all(torch.equal(k4_pools[0][i],
                              dev.plane_pool[dev.maps.plane_slot[t]])
                  for i, t in enumerate(ph_tids)),
          f"K4 equals its plain version bit for bit on the {len(ph_tids)} "
          f"plane rows of the mixed batch ({NS} slots each, "
          f"{int(k4_rows[1].sum())} posting words), as do the main path's "
          "plane-pool rows")

    # K5 on each dphrase group of the first mixed batch (every phrase but
    # the one score() had already promoted), and in the tf-row form of the
    # phrase-tf cache's fills
    groups = {}
    for q in phrases:
        if q != ph3:
            tids = [arr.term_dict.get_term_id(t) for t in q]
            plan_key, pattern = phrase.chain_key(dev, tids)
            groups.setdefault((plan_key, pattern), []).append(tids)
    dense.ensure_planes(dev, [t for g in groups.values() for ts in g
                              for t in ts])
    k5_specs = [(np.stack([dense.plane_slots_of(dev.maps, ts) for ts in g]),
                 plan_key, pattern)
                for (plan_key, pattern), g in groups.items()]
    check(any(len(pk) == 2 for _, pk, _ in k5_specs)
          and any(len(set(pt)) < len(pt) for _, _, pt in k5_specs),
          f"{len(k5_specs)} K5 groups, with a two-half plan and same-term "
          "patterns")
    kw5 = dict(num_docs=n, blk_bits=dev.blk_bits)
    k5_err = 0.0
    for slots5, plan_key, pattern in k5_specs:
        got = kc.phrase_chain(dev.plane_pool, slots5, plan_key, pattern,
                              **kw5)
        want = kc.phrase_chain_plain(dev.plane_pool, slots5, plan_key,
                                     pattern, **kw5)
        rows5 = torch.full((len(slots5) + 2, n), -1.0, device=dev.device)
        kc.phrase_chain(dev.plane_pool, slots5, plan_key, pattern,
                        out=rows5, out_rows=range(2, len(slots5) + 2),
                        **kw5)
        k5_err = max(k5_err, (got - want).abs().max().item())
        if not (torch.equal(got, want) and torch.equal(rows5[2:], want)
                and bool((rows5[:2] == -1).all())):
            raise AssertionError(f"K5 differs on {plan_key} {pattern}")
    # and on the serving mix's rare two-term phrases of one
    # bench.serving_queries call as one chain launch on their full planes
    # (the route they take with the candidate engine off)
    serve_tids = [[arr.term_dict.get_term_id(t) for t in q]
                  for q in serving_queries(3)
                  if not isinstance(q, str)
                  and all(t[0] == "w" and t[1:].isdigit() for t in q)]
    serve_keys = {phrase.chain_key(dev, ts) for ts in serve_tids}
    check(len(serve_keys) == 1 and len(serve_tids) == 10,
          f"the serving mix's rare phrases form one K5 group of "
          f"{len(serve_tids)} two-term queries on full planes")
    serve_plan, serve_pattern = serve_keys.pop()

    def serve_slots():
        dense.ensure_planes(dev, [t for ts in serve_tids for t in ts])
        return np.stack([dense.plane_slots_of(dev.maps, ts)
                         for ts in serve_tids])

    got = kc.phrase_chain(dev.plane_pool, serve_slots(), serve_plan,
                          serve_pattern, **kw5)
    serve_want = kc.phrase_chain_plain(dev.plane_pool, serve_slots(),
                                       serve_plan, serve_pattern, **kw5)
    if not torch.equal(got, serve_want):
        raise AssertionError("K5 differs on the serving mix's phrases")
    check(True, f"K5 equals its plain version bit for bit on the "
          f"{len(k5_specs)} phrase groups of the mixed batch, on the "
          "serving mix's rare phrases on full planes, and in the tf-row "
          "form")

    # K7 on every step the windowed phrases and the long-document mix
    # launch, recorded from the wrapper's own calls (single-query steps
    # with a window, both sides, the same-term step, carry steps; then
    # without a window: the 40-term phrase; then the mix's batched
    # launches), and K2 on each step's keys
    k7_calls = []

    class RecordingKernels:
        """The kernel module as search/phrase.py sees it, its K7 calls
        noted."""

        def __getattr__(self, name):
            return getattr(kc, name)

        def merge_step(self, *a, **kw):
            k7_calls.append((a, kw))
            return kc.merge_step(*a, **kw)

    phrase.kernels_cuda = RecordingKernels()
    try:
        for q in phrases:
            arr.termfreqs(q, **WIN_SCORE)
        n_windowed = len(k7_calls)
        arr.termfreqs(long_ph)
        n_single = len(k7_calls)
        larr.score_batch(lmix, top_k=TOP_K)
        n_mix = len(k7_calls)
        # the same call with its sparse phrase groups one at a time (the
        # launch pattern of the one-block-a-tile design, before the chains
        # of a call were stepped together): timed, not counted
        chains_fn = batch.sparse_chains_freqs
        batch.sparse_chains_freqs = lambda hd, pa, chains, **kw: [
            f for c in chains for f in chains_fn(hd, pa, [c], **kw)]
        try:
            larr.score_batch(lmix, top_k=TOP_K)
        finally:
            batch.sparse_chains_freqs = chains_fn
    finally:
        phrase.kernels_cuda = kc
    k7_groups = k7_calls[n_mix:]
    del k7_calls[n_mix:]
    lmix_tids = [larr._resolve_tids(q) for q in lmix
                 if not isinstance(q, str) and len(q) > 1]
    lmix_steps = max(
        len(ix) - 1 for tids in lmix_tids
        if min(tids) >= 0 and min(ldev.term_span(t)[1] for t in tids) > 0
        for _, ix in phrase.chain_key(ldev, tids)[0])
    k7_err, k7_k2 = 0.0, []
    for a, kw in k7_calls:
        got = kc.merge_step(*a, **kw)
        want = kc.merge_step_plain(*a, **{k: v for k, v in kw.items()
                                          if k != "need_cont"})
        k7_err = max(k7_err, (got[1] - want[1]).abs().max().item())
        need = torch.as_tensor(np.repeat(
            kc.per_query(kw.get("need_cont", True), len(a[4]), "need_cont"),
            np.asarray(a[4], np.int64)), device=got[1].device)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and (got[2] is None
                     or torch.equal(got[2][need], want[2][need]))):
            raise AssertionError(f"K7 differs from its plain version: "
                                 f"{kw}, {int(np.sum(a[4]))} base words")
        n_out = len(a[4]) * kw["key_stride"]
        k7_k2.append((got[0], got[1], n_out))
        if not torch.equal(kc.segment_sum(got[0], got[1], num_docs=n_out),
                           kc.segment_sum_plain(got[0], got[1],
                                                num_docs=n_out)):
            raise AssertionError(f"K2 differs on the keys of a K7 step: "
                                 f"{got[0].numel()} keys, {n_out} slots")
    seen = set()
    for a, kw in k7_calls:
        Q = len(a[4])
        sides = set(kc.per_query(kw["cont_side"], Q, "cont_side"))
        sames = set(map(bool, kc.per_query(kw["same_term"], Q, "same")))
        seen |= sides | {"same-term" if x else "merge" for x in sames}
        seen |= {"window" if kw["min_blk"] is not None else "no window",
                 "carry" if a[2] is not a[1] else "raw",
                 "batched" if Q > 1 else "single"}
        if len(sides) > 1 or len(sames) > 1:
            seen.add("mixed launch")
    check(seen == {"rhs", "lhs", "same-term", "merge", "window", "no window",
                   "carry", "raw", "batched", "single", "mixed launch"}
          and len(k7_calls) - n_single == k7_lmix // 2 == lmix_steps,
          f"K7 equals its plain version bit for bit (counts, keys and "
          f"continuations) on the {len(k7_calls)} steps of the windowed "
          f"phrases ({n_windowed}), the {len(long_ph)}-term phrase "
          f"({n_single - n_windowed}) and the long-document mix "
          f"({len(k7_calls) - n_single} launches, each over the call's "
          f"phrase groups; its longest chain half has {lmix_steps} steps): "
          "both sides, same-term, carry, windowed and mixed launches; K2 "
          "equals its plain version exactly on every step's keys")
    # timing units: the largest single step of the windowed phrases, and
    # one long-document mix call's launches
    k7_big = max(k7_calls[:n_windowed],
                 key=lambda c: int(np.sum(c[0][4]) + np.sum(c[0][6])))
    k7_batch = k7_calls[n_single:]   # one mix call, its groups' chains
                                     # stepped together
    big_k2 = k7_k2[next(i for i, c in enumerate(k7_calls) if c is k7_big)]

    # K9 on every launch of the windowed slop shapes, the wide and the
    # repeated-term phrase, one long-document request, the request that
    # mixes K6 and K9 queries, and edismax (per query and as a batch) on
    # the long-document frame, whose ps phase sends whole-query phrases of
    # two to four terms: recorded from the wrapper's own calls, and K2 on
    # each launch's keys
    k9_calls = []

    class RecordingSpans:
        """The kernel module as search/spans.py sees it, its K9 calls
        noted."""

        def __getattr__(self, name):
            return getattr(kc, name)

        def span_sparse(self, *a, **kw):
            k9_calls.append((a, kw))
            return kc.span_sparse(*a, **kw)

    spans_mod.kernels_cuda = RecordingSpans()
    try:
        for q in slop_shapes:
            arr.termfreqs(q, slop=SLOP, **WIN_SCORE)
        n_win9 = len(k9_calls)
        for q, sl in (WIDER_SLOP, TRIPLE_SLOP):
            arr.termfreqs(q, slop=sl)
        n_single9 = len(k9_calls)
        larr.score_batch(lsq, top_k=TOP_K, slop=lss)
        n_long9 = len(k9_calls)
        arr.score_batch(k9q, top_k=TOP_K, slop=k9s)
        n_mixed9 = len(k9_calls)
        for q in ED_QUERIES:
            edismax(ldf, q=q, top_k=TOP_K, ps=SLOP, **ED_KW)
        n_ed9 = len(k9_calls)
        edismax_batch(ldf, ED_QUERIES, top_k=TOP_K, ps=SLOP, **ED_KW)
    finally:
        spans_mod.kernels_cuda = kc
    k9_err, k9_k2 = 0.0, []
    for a, kw in k9_calls:
        got = kc.span_sparse(*a, **kw)
        want = kc.span_sparse_plain(*a, **kw)
        k9_err = max(k9_err, (got[1] - want[1]).abs().max().item())
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K9 differs from its plain version: w "
                                 f"{a[4]}, multiplicities {a[5]}, {kw}")
        n_out = len(a[2]) * kw["key_stride"]
        k9_k2.append((got[0], got[1], n_out))
        if not torch.equal(kc.segment_sum(got[0], got[1], num_docs=n_out),
                           kc.segment_sum_plain(got[0], got[1],
                                                num_docs=n_out)):
            raise AssertionError(f"K2 differs on the keys of a K9 launch: "
                                 f"{got[0].numel()} keys, {n_out} slots")
    k9_seen = {(len(a[5]), a[4], tuple(int(m) for m in a[5]))
               for a, _ in k9_calls}
    check(n_win9 == len(slop_shapes) and n_single9 - n_win9 == 2
          and n_long9 - n_single9 == k9_long // 2
          and n_mixed9 - n_long9 == k69_mixed[1]
          and len(k9_calls) - n_mixed9 == k9_ed
          and any(w > 18 for _, w, _ in k9_seen)
          and any(max(m) > 2 for _, _, m in k9_seen)
          and any(T >= 4 for T, _, _ in k9_seen)
          and any(len(a[2]) > 1 for a, _ in k9_calls[n_single9:n_long9])
          and any(len(a[2]) > 1 for a, _ in k9_calls[n_ed9:]),
          f"K9 equals its plain version bit for bit (keys and counts) on "
          f"the {len(k9_calls)} launches of the windowed slop shapes "
          f"({n_win9}), the wide and the repeated-term phrase "
          f"({n_single9 - n_win9}), a long-document request "
          f"({n_long9 - n_single9} batched launches), the request mixing K6 "
          f"and K9 queries ({n_mixed9 - n_long9}) and edismax on the "
          f"long-document frame ({n_ed9 - n_mixed9} per query, "
          f"{len(k9_calls) - n_ed9} batched): every launch the main path "
          f"made; (terms, w, multiplicities) {sorted(k9_seen)}; K2 equals "
          "its plain version exactly on every launch's keys")
    # timing units: the windowed launch with the most anchor words, and one
    # long-document request's launches
    def anchor_first_cols(a, kw):
        """The columns of a recorded K9 call, the anchor's first."""
        T = np.asarray(a[2]).shape[1]
        return [kw.get("anchor", 0)] + [c for c in range(T)
                                        if c != kw.get("anchor", 0)]

    def anchor_first(a, kw):
        """(offs, ns) of a recorded K9 call with the anchor's column
        first."""
        cols = anchor_first_cols(a, kw)
        return np.asarray(a[2])[:, cols], np.asarray(a[3])[:, cols]

    k9_big = max(k9_calls[:n_win9],
                 key=lambda c: int(anchor_first(*c)[1][:, 0].sum()))
    k9_batch = k9_calls[n_single9:n_long9]

    # K3 and K6 at the shapes one mixed request gives them, recorded from
    # the wrappers' own calls: the request twice (new rare queries, so
    # the first call launches the window groups and the second promotes
    # them and fills their tf-pool rows)
    k36_calls = []

    class RecordingDense:
        """The kernel module as search/dense.py sees it, its K3 and K6
        calls noted."""

        def __getattr__(self, name):
            return getattr(kc, name)

        def topk(self, *a, **kw):
            k36_calls.append(("topk", a, kw))
            return kc.topk(*a, **kw)

        def span_window(self, *a, **kw):
            k36_calls.append(("span_window", a, kw))
            return kc.span_window(*a, **kw)

    # The phrase-tf cache is emptied first, so that the slop phrases'
    # rows cached on the main path do not decide whether the request's
    # window groups run
    # The request takes the route the fused ranking pass replaced (K10
    # then K3 a ranked group; the route full scores, k above 64 and rows=
    # still take), so that K3's units stay the launches they were
    rq, rs = mixed_request(7)
    forget_phrase_rows(dev)
    dense.kernels_cuda = RecordingDense()
    fuses, dense.fuses = dense.fuses, never_fused
    try:
        arr.score_batch(rq, top_k=TOP_K, slop=rs)
        n_first = len(k36_calls)
        arr.score_batch(rq, top_k=TOP_K, slop=rs)
    finally:
        dense.kernels_cuda = kc
        dense.fuses = fuses
    k6_groups = [(a, kw) for name, a, kw in k36_calls[:n_first]
                 if name == "span_window"]
    # the second call's launches: tf-row fills, and window launches again
    # for the phrases the phrase-tf cache had no room to promote (at most
    # half the tf pool holds phrase rows, and edismax's grams share it)
    k6_second = [(a, kw) for name, a, kw in k36_calls[n_first:]
                 if name == "span_window"]
    k6_fills = [(a, kw) for a, kw in k6_second if "out" in kw]
    # (the candidate groups' K3 launches over their Kc axis were held to
    # the plain version on the main path)
    k3_calls = [(a[0], a[1]) for name, a, _ in k36_calls[:n_first]
                if name == "topk" and a[0].shape[-1] == n]
    # the second call's (its slop phrases' rows cached by the first)
    k3_calls2 = [(a[0], a[1]) for name, a, _ in k36_calls[n_first:]
                 if name == "topk" and a[0].shape[-1] == n]
    check(k6_groups and k6_fills and k3_calls and k3_calls2
          and all("out" not in kw for _, kw in k6_groups)
          and all(kw.get("out") is dev.tf_pool for _, kw in k6_fills),
          f"one mixed request launched K6 {len(k6_groups)} times on its "
          f"window groups ({sum(len(a[1]) for a, _ in k6_groups)} queries) "
          f"and K3 {len(k3_calls)} times "
          f"({sum(x.shape[0] for x, _ in k3_calls)} rows of {n}); its second "
          f"call launched K3 {len(k3_calls2)} times "
          f"({sum(x.shape[0] for x, _ in k3_calls2)} rows) and "
          f"filled tf-pool rows with {len(k6_fills)} K6 launches (and "
          f"ran {len(k6_second) - len(k6_fills)} window launches for "
          "phrases the cache had no room for)")
    k6_err = 0.0
    for a, kw in k6_groups + k6_second:
        plain_kw = {k: v for k, v in kw.items() if k not in ("out",
                                                             "out_rows")}
        want = kc.span_window_plain(*a, **plain_kw)
        if "out" in kw:   # the rows the main path's fill left in the pool
            got = dev.tf_pool[torch.as_tensor(np.asarray(kw["out_rows"]),
                                              device=dev.device)]
        else:
            got = kc.span_window(*a, **kw)
        k6_err = max(k6_err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"K6 differs from its plain version: w "
                                 f"{a[2]}, multiplicities {a[3]}")
    wide_tids = [arr.term_dict.get_term_id(t) for t in wide_q]
    wide_uniq, _, wide_key = batch._slop_structure(dev, wide_tids, wide_slop)
    dense.ensure_planes(dev, wide_uniq)
    wide_args = (dev.plane_pool, [dense.plane_slots_of(dev.maps, wide_uniq)],
                 wide_key[3], wide_key[4])
    kw6 = dict(anchor=0, num_docs=n, blk_bits=dev.blk_bits)
    got = kc.span_window(*wide_args, **kw6)
    if not (torch.equal(got, kc.span_window_plain(*wide_args, **kw6))
            and np.array_equal(got[0].cpu().numpy(), f_wide)):
        raise AssertionError(f"K6 differs on {wide_q} at slop {wide_slop}")
    check(True, f"K6 equals its plain version bit for bit on the "
          f"{len(k6_groups)} window launches and {len(k6_fills)} tf-row "
          f"fills of a mixed request and on {wide_q} at w = {wide_key[3]}, "
          f"multiplicities {wide_key[4]}")

    def k3_same(x, k):
        """K3 against its plain version: indices equal, values equal bit
        for bit; returns the largest difference of values."""
        vals, idx = kc.topk(x, k)
        want_v, want_i = kc.topk_plain(x, k)
        if not (torch.equal(idx.long(), want_i)
                and torch.equal(vals.view(torch.int32),
                                want_v.view(torch.int32))):
            raise AssertionError(f"K3 differs from its plain version on "
                                 f"{tuple(x.shape)}, k = {k}")
        return (vals - want_v).abs().nan_to_num(0.0).max().item()

    sort_cap = kc._get_lib().sa_topk_sort_cap()
    k3_tile = kc._get_lib().sa_topk_tile()
    one_cap = kc._get_lib().sa_topk_one_pass_cap()
    k3_ks = (1, 10, one_cap, one_cap + 1, 100, 1000, sort_cap,
             sort_cap + 952)
    k3_big = max(k3_calls, key=lambda c: c[0].shape[0])[0]
    k3_err = max([k3_same(x, k) for x, k in k3_calls + k3_calls2]
                 + [k3_same(k3_big, k) for k in k3_ks]
                 + [k3_same(torch.full((1, n), 2.5, device=dev.device), k)
                    for k in (1, TOP_K, sort_cap + 952)])
    # a [150, 1M] block of scores like BM25's (mostly 0, many equal) with
    # runs of one value planted across the edges of the kernel's tiles
    # (the two-launch path's, read from the library, in odd rows; the
    # radix select's in even ones): k places among k + 3 ties that start
    # before, at and after an edge
    g = torch.Generator(device=dev.device)
    g.manual_seed(3)
    ties = torch.randint(0, 40, (150, n), generator=g,
                         device=dev.device).to(torch.float32) / 3
    ties[torch.rand((150, n), generator=g, device=dev.device) < 0.9] = 0.0
    for r in range(150):
        at = (1 + r % 50) * (k3_tile if r % 2 else K3_RADIX_TILE) - (r % 7)
        ties[r, at: at + TOP_K + 3] = 50.0 + r
    ties[100:, :] = torch.where(ties[100:, :] > 40, ties[100:, :], 0.0)
    k3_err = max([k3_err] + [k3_same(ties, k) for k in (
        1, TOP_K, one_cap, one_cap + 1, 100, sort_cap + 952)])
    check(True, f"K3 equals its plain version (indices, and values bit for "
          f"bit) on the {len(k3_calls)} score blocks of a mixed request at "
          f"k = {TOP_K}, on its largest ({k3_big.shape[0]} rows) at k = "
          f"{k3_ks}, on a row of one value, and on a [150, {n}] block with "
          "ties planted across tile edges (50 rows of them with fewer than "
          "k positive scores)")

    phase_done("kernels vs plain: checks")

    # ---- 6. evidence -------------------------------------------------------
    def host_ms(fn, iters):
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    score_ms = host_ms(lambda: arr.score("what"), 30)
    topk_ms = host_ms(lambda: arr.topk("star", k=TOP_K), 30)

    # score_batch qps over WINDOWS windows.  "hot": the same 206 queries
    # every call (most tf rows stay in the pool); "cold": every call a
    # fresh set of 200 rare terms, so each call fills ~200 tf rows (K1)
    def k1_launches():
        return kc.score_term.launches + kc.score_term_rows.launches

    def qps_windows(window, n_queries):
        rates, fills = [], 0
        for w in range(WINDOWS):
            k1_before = k1_launches()
            t0 = time.perf_counter()
            calls = window(w)
            rates.append(calls * n_queries / (time.perf_counter() - t0))
            fills += k1_launches() - k1_before
        return rates, fills / (WINDOWS * calls)

    def hot_blocking(w):
        for _ in range(HOT_CALLS):
            arr.score_batch(queries, top_k=TOP_K)
        return HOT_CALLS

    def hot_pipelined(w):
        pending = None
        for _ in range(HOT_CALLS):
            nxt = arr.score_batch(queries, top_k=TOP_K, block=False)
            if pending is not None:
                pending()
            pending = nxt
        pending()
        return HOT_CALLS

    cold_sets = [[f"w{4000 + j + 125 * i}" for i in range(200)]
                 for j in range(1, 1 + WINDOWS * COLD_CALLS)]
    check(all(t in arr.term_dict for s in cold_sets for t in s),
          f"{WINDOWS * COLD_CALLS} cold query sets of 200 indexed terms")

    def cold_blocking(w):
        for c in range(COLD_CALLS):
            arr.score_batch(cold_sets[w * COLD_CALLS + c], top_k=TOP_K)
        return COLD_CALLS

    # the serving mix of bench.py: 120 queries per call, half of them
    # phrases, hot stopword phrases and a rare tail that changes per call
    mix_n = len(serving_queries(0))

    def mix_blocking(w):
        for c in range(MIX_CALLS):
            arr.score_batch(serving_queries(w * MIX_CALLS + c), top_k=TOP_K)
        return MIX_CALLS

    def mix_pipelined(w):
        pending = None
        for c in range(MIX_CALLS):
            nxt = arr.score_batch(serving_queries(1000 + w * MIX_CALLS + c),
                                  top_k=TOP_K, block=False)
            if pending is not None:
                pending()
            pending = nxt
        pending()
        return MIX_CALLS

    # the mixed request of bench.py: the serving mix and 24 slop-2 phrases
    # in one batch, the rare tail of both new every call
    mixs_n = len(sq)

    def mixs_blocking(w):
        for c in range(MIX_CALLS):
            arr.score_batch(mixed_request(2000 + w * MIX_CALLS + c)[0],
                            top_k=TOP_K, slop=ss)
        return MIX_CALLS

    def mixs_pipelined(w):
        pending = None
        for c in range(MIX_CALLS):
            nxt = arr.score_batch(
                mixed_request(4000 + w * MIX_CALLS + c)[0], top_k=TOP_K,
                slop=ss, block=False)
            if pending is not None:
                pending()
            pending = nxt
        pending()
        return MIX_CALLS

    arr.score_batch(queries, top_k=TOP_K)
    qps_hot, fills_hot = qps_windows(hot_blocking, len(queries))
    qps_pipe, fills_pipe = qps_windows(hot_pipelined, len(queries))
    qps_cold, fills_cold = qps_windows(cold_blocking, 200)
    k45_before = (kc.plane_fill.launches, kc.phrase_chain.launches)
    qps_mix, fills_mix = qps_windows(mix_blocking, mix_n)
    qps_mixp, fills_mixp = qps_windows(mix_pipelined, mix_n)
    k45_per_call = [(a - b) / (2 * WINDOWS * MIX_CALLS) for a, b in zip(
        (kc.plane_fill.launches, kc.phrase_chain.launches), k45_before)]
    k36_before = (kc.topk.launches, kc.span_window.launches)
    qps_mixs, fills_mixs = qps_windows(mixs_blocking, mixs_n)
    qps_mixsp, fills_mixsp = qps_windows(mixs_pipelined, mixs_n)
    k36_per_call = [(a - b) / (2 * WINDOWS * MIX_CALLS) for a, b in zip(
        (kc.topk.launches, kc.span_window.launches), k36_before)]
    slop_ms = [host_ms(lambda q=q: arr.score(q, slop=SLOP), 30)
               for q in (slop_shapes[0], slop_shapes[2])]
    tf_wide_ms = host_ms(lambda: arr.termfreqs(wide_q, slop=wide_slop), 30)
    score_ph_ms = host_ms(lambda: arr.score(ph3), 30)
    tf_ph_ms = host_ms(lambda: arr.termfreqs(ph4), 30)

    # the sparse chain end to end: a windowed stopword phrase (one step
    # of two ~2.5M-word lists), a windowed five-term phrase, and the
    # serving mix on the long-document index (terms and phrases both
    # sparse groups there), new rare queries every call
    win_ph_ms = [host_ms(lambda q=q: arr.score(q, **WIN_SCORE), 30)
                 for q in (phrases[0], phrases[3])]

    def lmix_blocking(w):
        for c in range(LMIX_CALLS):
            larr.score_batch(serving_queries(5000 + w * LMIX_CALLS + c)
                             + lmix[120:], top_k=TOP_K)
        return LMIX_CALLS

    lmix_blocking(-1)
    qps_lmix, _ = qps_windows(lmix_blocking, len(lmix))

    # the long-document request with slop: the serving mix and bench.py's
    # 24 slop-2 phrases, every one of them K9's there
    def lsmix_blocking(w):
        for c in range(LMIX_CALLS):
            i = 6000 + w * LMIX_CALLS + c
            larr.score_batch(serving_queries(i) + lmix[120:]
                             + slop_queries(i), top_k=TOP_K, slop=lss)
        return LMIX_CALLS

    lsmix_blocking(-1)
    qps_lsmix, _ = qps_windows(lsmix_blocking, len(lsq))

    # edismax: per-call latency over bench.py's 12 queries and the qps of
    # one edismax_batch of them, exact phases and slop phases, at 1M docs
    # and on the long-document frame
    def ed_latency(frame, **kw):
        times = []
        for _ in range(ED_CALLS):
            for q in ED_QUERIES:
                t = time.perf_counter()
                edismax(frame, q=q, top_k=TOP_K, **ED_KW, **kw)
                times.append((time.perf_counter() - t) * 1e3)
        return [float(np.percentile(times, 50)),
                float(np.percentile(times, 95))]

    def ed_batch_qps(frame, **kw):
        rates = []
        for _ in range(WINDOWS):
            t = time.perf_counter()
            for _ in range(ED_CALLS):
                edismax_batch(frame, ED_QUERIES, top_k=TOP_K, **ED_KW, **kw)
            rates.append(ED_CALLS * len(ED_QUERIES)
                         / (time.perf_counter() - t))
        return rates

    ed_stats = [(name, ed_latency(frame, **kw), ed_batch_qps(frame, **kw))
                for name, frame, kw in (
                    ("1M docs", df, {}),
                    ("1M docs, ps=2, ps2=1", df, ED_SLOP),
                    ("long-document frame, ps=2", ldf, {"ps": SLOP}))]

    # the long-document score_batch (K2's end-to-end path) and the serving
    # mix, with the parent's kernels in turns when given (parent, new,
    # new, parent; only K2 differs between them)
    def long_window(w):
        for _ in range(LONG_CALLS):
            larr.score_batch(TERM_QUERIES, top_k=TOP_K)
        return LONG_CALLS

    def mix_turn(w):
        for c in range(MIX_CALLS):
            arr.score_batch(serving_queries(3000 + w * MIX_CALLS + c),
                            top_k=TOP_K)
        return MIX_CALLS

    def mixs_turn(w):
        for c in range(MIX_CALLS):
            arr.score_batch(mixed_request(4000 + w * MIX_CALLS + c)[0],
                            top_k=TOP_K, slop=ss)
        return MIX_CALLS

    def lmix_turn(w):
        for c in range(LMIX_CALLS):
            larr.score_batch(serving_queries(7000 + w * LMIX_CALLS + c)
                             + lmix[120:], top_k=TOP_K)
        return LMIX_CALLS

    def ed_long_turn(w):
        """p50 ms of edismax(ps=2) over bench.py's queries on the
        long-document frame (its phrase phases run K7 and K9)."""
        times = []
        for _ in range(2):
            for q in ED_QUERIES:
                t0 = time.perf_counter()
                edismax(ldf, q=q, top_k=TOP_K, ps=SLOP, **ED_KW)
                times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    e2e_turns = ([("parent", parent), ("new", None), ("new", None),
                  ("parent", parent)] * 2 if parent is not None
                 else [("new", None)])
    e2e = {}
    for name, window, n_q in (("long-document", long_window,
                               len(TERM_QUERIES)),
                              ("serving mix", mix_turn, mix_n),
                              ("mixed request with slop", mixs_turn,
                               mixs_n),
                              ("long-document mix", lmix_turn, len(lmix)),
                              ("long-document edismax(ps=2) p50 ms",
                               ed_long_turn, None)):
        for t, (label, lib) in enumerate(e2e_turns):
            def turn(w, window=window):
                return window(w) if lib is None else with_lib(
                    lib, lambda: window(w))()
            turn(100 + t)  # warm, on other queries
            t0 = time.perf_counter()
            got = turn(t)
            e2e.setdefault(name, []).append(
                (label, got if n_q is None
                 else got * n_q / (time.perf_counter() - t0)))

    # the candidate engine and edismax's phase pruning on (the JAX
    # package's thresholds) and off (the port's, at 1M docs) in turns (on,
    # off, off, on, twice), by the port's module constants: the
    # serving mix, the mixed request with slop (both new rare queries every
    # call) and edismax over bench.py's queries, at 1M docs.  Each turn
    # starts from an empty phrase-tf cache, so that one mode's promotions
    # do not decide what the next finds cached, and is warmed on other
    # queries first
    turn_kernels = ("cand_rows", "cand_minis", "plane_fill", "phrase_chain",
                    "span_window", "topk")

    def engine(on):
        """The JAX package's thresholds (the engine and the pruning on at
        1M docs), or the port's."""
        return (thresholds(cand, solr, JAX_CAND, JAX_PHASE_SUBSET_MIN_DOCS)
                if on else contextlib.nullcontext())

    def onoff_turn(t):
        out = {}
        before = {k: getattr(kc, k).launches for k in turn_kernels}
        t0 = time.perf_counter()
        for c in range(MIX_CALLS):
            arr.score_batch(serving_queries(11000 + 100 * t + c), top_k=TOP_K)
        out["serving mix qps"] = MIX_CALLS * mix_n / (time.perf_counter()
                                                      - t0)
        t0 = time.perf_counter()
        for c in range(MIX_CALLS):
            arr.score_batch(mixed_request(12000 + 100 * t + c)[0],
                            top_k=TOP_K, slop=ss)
        out["mixed request with slop qps"] = MIX_CALLS * mixs_n / (
            time.perf_counter() - t0)
        out["launches per serving and mixed call"] = {
            k: (getattr(kc, k).launches - v) / (2 * MIX_CALLS)
            for k, v in before.items()}
        times = []
        for q in ED_QUERIES:
            t0 = time.perf_counter()
            edismax(df, q=q, top_k=TOP_K, **ED_KW)
            times.append((time.perf_counter() - t0) * 1e3)
        out["edismax p50 ms"] = float(np.median(times))
        return out

    onoff = []
    for t, on in enumerate((True, False, False, True) * 2):
        with engine(on):
            forget_phrase_rows(dev)
            onoff_turn(50 + t)   # warm, on other queries
            onoff.append(("on" if on else "off", onoff_turn(t)))
    onoff_medians = {
        mode: {m: float(np.median([r[m] for md, r in onoff if md == mode]))
               for m in ("serving mix qps", "mixed request with slop qps",
                         "edismax p50 ms")}
        for mode in ("on", "off")}
    phase_done("qps windows and latencies")

    # ---- 5, continued: kernel timing ---------------------------------------
    # Each unit of work is timed by its kernels' own device time
    # (torch.profiler) and by CUDA events around the wrapper calls, beside
    # the bound of the bytes and operations it needs and the plain
    # version's times.  With --parent-csrc the parent's kernels run the
    # same calls in turns: old, new, new, old.  This runs after the
    # end-to-end windows above, so that none of them runs in a process
    # the profiler has been attached to.
    timer = DeviceTimer(dev.device)
    names = KERNEL_NAMES
    counters = {"K1": lambda: (kc.score_term.launches
                               + kc.score_term_rows.launches),
                "K2": lambda: kc.segment_sum.launches,
                "K4": lambda: kc.plane_fill.launches,
                "K5": lambda: kc.phrase_chain.launches,
                "K7": lambda: k7_wrapper.launches,
                # a K3 launch enqueues one, two or nine kernels
                "K3": lambda: kc.topk.kernels,
                "K6": lambda: kc.span_window.launches,
                # the parent's K8a launches are two kernels each
                "K8a": lambda: (kc.cand_rows.launches
                                * kc.CAND_ROWS_KERNELS_PER_LAUNCH
                                + k8a_extra[0]),
                "K8b": lambda: kc.cand_minis.launches,
                "K9": lambda: kc.span_sparse.launches,
                "K10": lambda: kc.similarity.launches,
                "K11": lambda: kc.compose.launches}

    def measure(unit, kernel, fn, plain, work, iters=20, plain_iters=3,
                flush=False, old=True, library=None, per=1, old_fn=None):
        """Time one unit of work; ``per`` divides every time into the
        time per launch or row the unit is made of.  ``old_fn`` (``fn`` by
        default) is what the parent's kernels run in their turns.  A
        ``kernel`` of None times all the device work of each turn."""
        old_run = with_lib(parent, old_fn or fn)
        turns = ([old_run, fn, fn, old_run] if parent is not None and old
                 else [fn, fn])
        dev_ms = [timer(f, iters, names.get(kernel), flush,
                        counters.get(kernel)) for f in turns]
        rec = {"unit": unit, "per": per,
               "device_ms": [t / per for t, _ in dev_ms],
               "launches_per_unit": dev_ms[1][1],
               "ms": cuda_ms(fn, iters) / per,
               "plain_ms": cuda_ms(plain, plain_iters) / per,
               "plain_device_ms": timer(plain, plain_iters, None,
                                        flush)[0] / per,
               "bytes": work["bytes"] / per, "ops": work["ops"] / per,
               "bound_ms": work["bound_ms"] / per,
               "bound_by": work["bound_by"], "old": len(turns) == 4}
        new_ms = float(np.mean(rec["device_ms"][1:3] if rec["old"]
                               else rec["device_ms"]))
        rec["new_device_ms"] = new_ms
        rec["share"] = rec["bound_ms"] / new_ms
        if rec["old"]:
            old_ms = float(np.mean([rec["device_ms"][0],
                                    rec["device_ms"][3]]))
            rec["old_device_ms"] = old_ms
            rec["old_share"] = rec["bound_ms"] / old_ms
        if library is not None:
            rec["library_ms"] = cuda_ms(library, iters) / per
            rec["library_device_ms"] = timer(library, iters, None,
                                             flush)[0] / per
        print(f"timing: {unit}: {json.dumps(rec)} {tag}", flush=True)
        return rec

    bb = dev.blk_bits
    what_id = arr.term_dict.get_term_id("what")
    h_what, p_what = scoring.term_planes(dev, what_id)
    t_what = measure(
        '"what" tf fill, one K1 launch (kind none), L2 flushed before '
        'each', "K1",
        lambda: kc.score_term(h_what, p_what, dev.doc_lens, 0.0, 1.0,
                              kind="none", out=k1_pools[2][0], **kwr),
        lambda: kc.score_term_plain(h_what, p_what, dev.doc_lens, 0.0, 1.0,
                                    kind="none", **kwr),
        rl.k1_work(h_what.numel(), n, "none"), flush=True)
    t_rare = measure(
        f"tf fill of one rare term, {len(rare_planes)} single-row K1 launches "
        f"into {len(rare_planes)} tf rows, per launch", "K1",
        k1_single(rare_planes, k1_pools[2]),
        k1_rows_fill(kc.score_term_rows_plain, k1_rows, k1_pools[1]),
        rl.k1_rows_work(k1_rows[1], n), per=len(rare_planes))
    t_rows = measure(
        f"tf fill of one rare term, one multi-row K1 launch filling "
        f"{len(rare_planes)} tf rows, per row", "K1",
        k1_rows_fill(kc.score_term_rows, k1_rows, k1_pools[0]),
        k1_rows_fill(kc.score_term_rows_plain, k1_rows, k1_pools[1]),
        rl.k1_rows_work(k1_rows[1], n),
        old=hasattr(parent, "sa_score_term_rows"), per=len(rare_planes))

    # K2, per unit of several launches: the long-document batch, the 1M
    # sparse term group and its uniform control.  The library call is one
    # index_add_ per launch on the in-range prefix of its keys (found
    # here, untimed), as K2's plain version adds them
    def k2_unit(unit, calls):
        prefix = [(f[:m], v[:m], n_out) for f, v, n_out in calls
                  for m in [int((f < n_out).sum().item())]]

        def batch_of(fn):
            return lambda: [fn(f, v, num_docs=m) for f, v, m in calls]

        return measure(
            f"{unit}, {len(calls)} K2 launches", "K2",
            batch_of(kc.segment_sum), batch_of(kc.segment_sum_plain),
            rl.total(rl.k2_flat_work(f, n_out) for f, _, n_out in calls),
            library=lambda: [torch.zeros(n_out, device=f.device).index_add_(
                0, f, v) for f, v, n_out in prefix])

    t_k2 = k2_unit("long-document batch", k2_calls)
    t_k2s = k2_unit("1M sparse term group (bench.TERM_QUERIES, each "
                    "bucket's pad run on its last slot)", sparse_k2)
    t_k2c = k2_unit("uniform control of the 1M sparse term group (as many "
                    "keys and slots, no run over 32)", control_k2)
    t_k2w = k2_unit(f"the keys of the largest windowed-phrase step "
                    f"({big_k2[0].numel()} keys, {big_k2[2]} slots)",
                    [big_k2])

    # K7: the largest single step of the windowed phrases, and the
    # launches of one long-document mix call.  No one PyTorch call
    # computes a step, so there is no library time
    def k7_run(calls, plain=False):
        """The recorded calls through K7's wrapper as it stands when the
        function runs (the parent's turns swap it), or its plain
        version."""
        if plain:
            return lambda: [kc.merge_step_plain(*a, **{
                k: v for k, v in kw.items() if k != "need_cont"})
                for a, kw in calls]
        return lambda: [kc.merge_step(*a, **kw) for a, kw in calls]

    def k7_queries(a, kw):
        """(base words, other words, need_cont, same_term) per query."""
        Q = len(a[4])
        return zip(np.asarray(a[4]).tolist(), np.asarray(a[6]).tolist(),
                   kc.per_query(kw.get("need_cont", True), Q, "need_cont"),
                   kc.per_query(kw["same_term"], Q, "same_term"))

    def k7_work(calls):
        """The bound of the calls: the total of their queries' k7_work
        (a merged launch's is its groups' total)."""
        return rl.total(rl.k7_work([b], [o], bool(nc), bool(st))
                        for a, kw in calls
                        for b, o, nc, st in k7_queries(a, kw))

    def k7_words(calls):
        return (int(sum(b for a, kw in calls for b, _, _, _ in
                        k7_queries(a, kw))),
                int(sum(o for a, kw in calls for _, o, _, st in
                        k7_queries(a, kw) if not st)))

    has_k7 = (hasattr(parent, "sa_merge_step")
              or hasattr(parent, "sa_merge_join"))
    t_k7 = measure(
        "largest step of the windowed phrases, one K7 launch: %d base "
        "words against %d (sides %s, window blocks %s-%s)" % (
            *k7_words([k7_big]),
            kc.per_query(k7_big[1]["cont_side"], len(k7_big[0][4]), "side"),
            k7_big[1]["min_blk"], k7_big[1]["max_blk"]), "K7",
        k7_run([k7_big]), k7_run([k7_big], plain=True), k7_work([k7_big]),
        old=has_k7)
    t_k7b = measure(
        "one long-document mix call, %d K7 launches over %d phrase "
        "queries, each over the call's phrase groups (the parent's turns: "
        "%d launches, group by group): %d base words against %d" % (
            len(k7_batch), sum(1 for q in set(map(tuple, (
                q for q in lmix if not isinstance(q, str))))),
            len(k7_groups), *k7_words(k7_batch)), "K7",
        k7_run(k7_batch), k7_run(k7_batch, plain=True), k7_work(k7_batch),
        old=has_k7, old_fn=k7_run(k7_groups))
    t_k7g = measure(
        "the same call group by group, %d K7 launches" % len(k7_groups),
        "K7", k7_run(k7_groups), k7_run(k7_groups, plain=True),
        k7_work(k7_groups), old=has_k7)

    def k4_fill(fn):
        return lambda: fn(dev.hdrs, dev.pays, *k4_rows, k4_pools[0])

    t_k4 = measure(
        f"one K4 launch filling the mixed batch's {len(ph_tids)} plane "
        "rows", "K4", k4_fill(kc.plane_fill), k4_fill(kc.plane_fill_plain),
        rl.k4_work(k4_rows[1], NS), iters=10)

    # K5: every group launch of the first mixed batch, per batch, its bound
    # counting each plane row distinct across the batch once (the launches
    # fetch a shared plane once each); then the serving mix's launch (its
    # planes made resident first)
    def k5_batch(fn):
        return lambda: [fn(dev.plane_pool, s, pk, pt, **kw5)
                        for s, pk, pt in k5_specs]

    t_k5 = measure(
        f"first mixed batch, {len(k5_specs)} K5 group launches", "K5",
        k5_batch(kc.phrase_chain), k5_batch(kc.phrase_chain_plain),
        rl.k5_batch_work([(s, pk) for s, pk, _ in k5_specs], n, 1 << bb),
        iters=10)
    k5_planes = (len(np.unique(np.concatenate([s.ravel()
                                                for s, _, _ in k5_specs]))),
                 rl.k5_plane_reads([(s, pk) for s, pk, _ in k5_specs]))
    k5_each = [((len(s), len(pt), len(pk)), rl.k5_work(s, pk, n, 1 << bb),
                timer(lambda s=s, pk=pk, pt=pt: kc.phrase_chain(
                    dev.plane_pool, s, pk, pt, **kw5), 10, names["K5"],
                    counter=counters["K5"]))
               for s, pk, pt in k5_specs]
    slots_serve = serve_slots()
    t_serve = measure(
        f"serving mix's rare phrases as one chain launch on full planes, "
        f"{len(serve_tids)} two-term phrases", "K5",
        lambda: kc.phrase_chain(dev.plane_pool, slots_serve, serve_plan,
                                serve_pattern, **kw5),
        lambda: kc.phrase_chain_plain(dev.plane_pool, slots_serve,
                                      serve_plan, serve_pattern, **kw5),
        rl.k5_work(slots_serve, serve_plan, n, 1 << bb), iters=10)
    if parent is not None:
        check(torch.equal(with_lib(parent, lambda: kc.phrase_chain(
            dev.plane_pool, slots_serve, serve_plan, serve_pattern,
            **kw5))(), serve_want),
              "the parent's K5 returns the same freqs on the serving launch")

    # K3: the top-k launches of the two calls of one mixed request (every
    # group's score block, k = 10) and the [150, 1M] block with planted
    # ties.  The library time is torch.topk(x, k, sorted=True): the
    # nearest PyTorch call, the same values but not the smallest-index
    # order of ties, so no equivalent (the plain composition around it,
    # which synchronises the host twice a call, is the plain time)
    def k3_run(fn, calls):
        return lambda: [fn(x, k) for x, k in calls]

    def k3_unit(unit, calls):
        rows = sum(x.shape[0] for x, _ in calls)
        return measure(
            f"{unit}: {len(calls)} K3 launches, {rows} rows of {n}, k = "
            f"{sorted({k for _, k in calls})}", "K3",
            k3_run(kc.topk, calls), k3_run(kc.topk_plain, calls),
            rl.total(rl.k3_work(x.shape[0], n, k) for x, k in calls),
            iters=10, library=lambda: [torch.topk(x, k, sorted=True)
                                       for x, k in calls])

    t_k3 = k3_unit("the top-k launches of one mixed request, its "
                   "phrase-tf cache emptied first", k3_calls)
    t_k3s = k3_unit("the top-k launches of the same request's second call",
                    k3_calls2)
    t_k3t = k3_unit(f"a [150, {n}] block with ties planted across tile "
                    "edges", [(ties, TOP_K)])
    # the K3 merge of the sharded path (3c): the shards' candidates of one
    # sharded serving-mix call, [Q, S * k]
    mx_, mk_ = merge_calls[0]
    t_k3m = measure(
        f"the K3 merge of one sharded serving-mix call: [{mx_.shape[0]}, "
        f"{mx_.shape[1]}] candidates of {S} shards, k = {mk_}", "K3",
        lambda: kc.topk(mx_, mk_), lambda: kc.topk_plain(mx_, mk_),
        rl.k3_work(mx_.shape[0], mx_.shape[1], mk_), iters=20,
        library=lambda: torch.topk(mx_, mk_, sorted=True))

    # K3+K10: the fused ranking pass over one terms wave as the batch
    # driver ranks it: the tf-pool rows, by slot, of 99 terms of the main
    # path's term batch, made resident first, BM25, k = 10 (the idfs
    # seeded).  It is
    # timed by all the device work of a call, so that the parent's turns
    # (and, beside them, this tree's kernels) run the route it replaced:
    # the rows gathered, K10 into the gathered block, then K3.  No single
    # PyTorch call ranks a similarity; the yardstick is that route as
    # torch ops (the gather, torch_similarity, torch.topk)
    rng_w = np.random.default_rng(22)
    wave_tids = list(dict.fromkeys(arr.term_dict.get_term_id(t)
                                   for t in queries))[:99]
    dense.ensure_tfs(dev, wave_tids)
    wave_slots = torch.as_tensor(dense.tf_slots_of(dev.maps, wave_tids),
                                 device=dev.device)
    wave_idfs = torch.as_tensor(rng_w.uniform(
        0.5, 12.0, len(wave_slots)).astype(np.float32), device=dev.device)
    wave = ("bm25", dev.tf_pool, wave_slots, dev.doc_lens, wave_idfs, avgdl,
            1.2, 0.75, TOP_K)

    def wave_replaced(sim, rank):
        def run():
            rows = dev.tf_pool.index_select(0, wave_slots)
            sim("bm25", rows, dev.doc_lens, wave_idfs, avgdl, 1.2, 0.75,
                out=rows)
            return rank(rows, TOP_K)
        return run

    def kernels_replaced():
        return wave_replaced(kc.similarity, kc.topk)()

    def same_rank(got, want):
        return (torch.equal(got[1].long(), want[1].long()) and torch.equal(
            got[0].view(torch.int32), want[0].view(torch.int32)))

    wave_want = kc.rank_rows_plain(*wave)
    check(same_rank(kc.rank_rows(*wave), wave_want)
          and same_rank(kernels_replaced(), wave_want)
          and (parent is None
               or same_rank(with_lib(parent, kernels_replaced)(), wave_want)),
          f"the fused pass on a terms wave ({len(wave_slots)} tf-pool rows "
          "by slot) equals rank_rows_plain and the gather, K10 and K3 it "
          "replaced" + (", the parent's kernels too" if parent is not None
                        else "") + ", bit for bit")
    del wave_want
    t_rank = measure(
        f"one terms wave: {len(wave_slots)} tf-pool rows of {n} by slot, "
        f"k = {TOP_K}, one fused launch (the parent's turns: the gather, "
        "K10 and K3 it replaced)", None,
        lambda: kc.rank_rows(*wave), lambda: kc.rank_rows_plain(*wave),
        rl.rank_work(len(wave_slots), n, TOP_K), iters=20,
        old_fn=kernels_replaced,
        library=wave_replaced(torch_similarity,
                              lambda x, k: torch.topk(x, k, sorted=True)))
    t_rank["replaced_device_ms"] = timer(kernels_replaced, 20)[0]
    print(f"timing: the route the fused pass replaced on this tree's "
          f"kernels, the same wave: {t_rank['replaced_device_ms']} ms {tag}",
          flush=True)

    def device_ops(fn):
        """Device operations (kernels, copies, memsets) one call enqueues,
        by the profiler's event count; the most of three tries, since the
        profiler has been seen to drop events."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        seen = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            seen.append(sum(1 for e in prof.events()
                            if e.device_type == DeviceType.CUDA))
        return max(seen)

    k3_ops = {"new": [device_ops(lambda x=x, k=k: kc.topk(x, k))
                      for x, k in k3_calls]}
    if parent is not None:
        k3_ops["parent"] = [device_ops(with_lib(
            parent, lambda x=x, k=k: kc.topk(x, k))) for x, k in k3_calls]
    check(max(k3_ops["new"]) <= 2,
          f"a K3 call at k = {TOP_K} is at most two device operations "
          f"(the mixed request's {len(k3_calls)} launches: "
          f"{k3_ops['new']}; parent: {k3_ops.get('parent')})")
    k3_each = [(x.shape[0], rl.k3_work(x.shape[0], n, k)["bound_ms"],
                timer(lambda x=x, k=k: kc.topk(x, k), 10, names["K3"],
                      counter=counters["K3"])[0]) for x, k in k3_calls]

    # K6: the window launches of one mixed request none of whose slop
    # phrases is cached yet, as the first one ran them (its planes made
    # resident first), and the widest repeated-term query
    def k6_slots():
        """The recorded launches with their queries' planes resident and
        the slot arrays they have now."""
        out = []
        for spec in k6_specs:
            dense.ensure_planes(dev, [t for ts in spec[0] for t in ts])
            out.append((np.stack([dense.plane_slots_of(dev.maps, ts)
                                  for ts in spec[0]]), *spec[1:]))
        return out

    # the groups of a request, as (term ids per query, w, mults)
    k6_specs = {}
    for q in dict.fromkeys(map(tuple, slop_queries(7))):
        uniq, _, fkey = batch._slop_structure(
            dev, [arr.term_dict.get_term_id(t) for t in q], SLOP)
        k6_specs.setdefault(fkey[3:], []).append(uniq)
    k6_specs = [(qs, w, mults) for (w, mults), qs in k6_specs.items()]
    check({(w, mults) for _, w, mults in k6_specs}
          >= {(a[2], tuple(a[3])) for a, _ in k6_groups},
          f"a mixed request's {sum(len(qs) for qs, _, _ in k6_specs)} "
          f"distinct slop queries form {len(k6_specs)} K6 groups when none "
          "is cached yet: (queries, w, multiplicities) "
          f"{[(len(qs), w, m) for qs, w, m in k6_specs]}")
    k6_now = k6_slots()

    def k6_run(fn):
        return lambda: [fn(dev.plane_pool, sl, w, mults, **kw6)
                        for sl, w, mults in k6_now]

    t_k6 = measure(
        f"the window launches of one mixed request: {len(k6_now)} K6 "
        f"launches, {sum(len(sl) for sl, _, _ in k6_now)} slop-{SLOP} "
        "queries", "K6", k6_run(kc.span_window),
        k6_run(kc.span_window_plain),
        rl.k6_batch_work(k6_now, n, 1 << bb), iters=10, old=False)
    k6_planes = len(np.unique(np.concatenate([sl.ravel()
                                              for sl, _, _ in k6_now])))
    k6_each = [((len(sl), w, mults), rl.k6_work(sl, w, mults, n, 1 << bb),
                timer(lambda sl=sl, w=w, mults=mults: kc.span_window(
                    dev.plane_pool, sl, w, mults, **kw6), 10, names["K6"],
                    counter=counters["K6"])[0])
               for sl, w, mults in k6_now]
    dense.ensure_planes(dev, wide_uniq)
    wide_now = (dev.plane_pool, [dense.plane_slots_of(dev.maps, wide_uniq)],
                wide_key[3], wide_key[4])
    t_k6w = measure(
        f"{wide_q} at slop {wide_slop}: one K6 launch, w = {wide_key[3]}, "
        f"multiplicities {wide_key[4]}", "K6",
        lambda: kc.span_window(*wide_now, **kw6),
        lambda: kc.span_window_plain(*wide_now, **kw6),
        rl.k6_work(wide_now[1], wide_key[3], wide_key[4], n, 1 << bb),
        iters=10, old=False)

    # K9: the windowed launch with the most anchor words, and the launches
    # of one long-document request.  No one PyTorch call computes it.  The
    # bound counts, of each term's list, the words inside the anchor's
    # header range, and of the anchor's words those that keep a position
    # once the block window is applied
    def k9_run(fn, calls, **more):
        return lambda: [fn(*a, **kw, **more) for a, kw in calls]

    def k9_work(calls):
        works = []
        for a, kw in calls:
            hd, pa, _, _, w, _ = a
            offs, ns = anchor_first(a, kw)
            C = -(-w // 18)
            lo_b, hi_b = ((0, (1 << 18) - 1) if kw.get("min_blk") is None
                          else (kw["min_blk"], kw["max_blk"]))
            term_ns, live = [], 0
            for o_row, n_row in zip(offs, ns):
                ah = hd[o_row[0]: o_row[0] + n_row[0]].cpu().numpy()
                ap = pa[o_row[0]: o_row[0] + n_row[0]].cpu().numpy()
                blk = ah & ((1 << kw["blk_bits"]) - 1)
                live += int(((ap != 0) & (blk >= lo_b) & (blk <= hi_b)).sum())
                row = [len(ah)]
                for o, m in zip(o_row[1:], n_row[1:]):
                    th = hd[o: o + m].cpu().numpy()
                    row.append(int(np.searchsorted(th, ah[-1] + C, "right")
                                   - np.searchsorted(th, ah[0] - C))
                               if len(ah) else 0)
                term_ns.append(row)
            works.append(rl.k9_work(
                term_ns, 0, w, live=live,
                mults=np.asarray(a[5])[anchor_first_cols(a, kw)]))
        return rl.total(works), live

    def k9_words(calls):
        return (int(sum(anchor_first(*c)[1][:, 0].sum() for c in calls)),
                int(sum(anchor_first(*c)[1][:, 1:].sum() for c in calls)))

    big_work, big_live = k9_work([k9_big])
    t_k9 = measure(
        "largest windowed slop launch, one K9 launch: %d anchor words (%d "
        "with a position in blocks %s-%s) against %d, w = %d, "
        "multiplicities %s" % (
            k9_words([k9_big])[0], big_live, k9_big[1]["min_blk"],
            k9_big[1]["max_blk"], k9_words([k9_big])[1], k9_big[0][4],
            tuple(int(m) for m in k9_big[0][5])), "K9",
        k9_run(kc.span_sparse, [k9_big]),
        k9_run(kc.span_sparse_plain, [k9_big]), big_work,
        old=hasattr(parent, "sa_span_sparse"))
    t_k9b = measure(
        "one long-document request, %d batched K9 launches over %d slop "
        "queries: %d anchor words against %d" % (
            len(k9_batch), sum(len(a[2]) for a, _ in k9_batch),
            *k9_words(k9_batch)), "K9",
        k9_run(kc.span_sparse, k9_batch),
        k9_run(kc.span_sparse_plain, k9_batch), k9_work(k9_batch)[0],
        old=hasattr(parent, "sa_span_sparse"))
    # the same launches on the kernel's walked path (one start at a time),
    # which they would take at w > 18 or a multiplicity above 2: the word
    # path's gain, within this run
    check(all(a[4] <= kc.SPAN_MAX_WINDOW and max(a[5]) <= 2
              for a, _ in [k9_big] + k9_batch),
          "the timed K9 launches take the kernel's 64-bit word path")
    t_k9w = measure(
        "largest windowed slop launch on the walked path, one K9 launch",
        "K9", k9_run(kc._span_sparse, [k9_big], walked=True),
        k9_run(kc.span_sparse_plain, [k9_big]), big_work, old=False)
    t_k9bw = measure(
        "one long-document request on the walked path, %d batched K9 "
        "launches" % len(k9_batch), "K9",
        k9_run(kc._span_sparse, k9_batch, walked=True),
        k9_run(kc.span_sparse_plain, k9_batch), k9_work(k9_batch)[0],
        old=False)
    big9_k2 = k9_k2[next(i for i, c in enumerate(k9_calls) if c is k9_big)]
    t_k2s9 = k2_unit(f"the keys of the largest windowed slop launch "
                     f"({big9_k2[0].numel()} keys, {big9_k2[2]} slots)",
                     [big9_k2])

    # K8a: the serving mix's largest cterm launch (its rare terms' slices,
    # compacted, tf summed).  The library call: one
    # torch.unique_consecutive of the launch's keys, each query's in a
    # range of its own (built here, untimed)
    k8a_a, k8a_kw = max((c for c in sm_k8a if c[1].get("with_tf", True)),
                        key=lambda c: int(np.sum(c[0][3])))
    k8a_keys = torch.cat([
        (k8a_a[0][o: o + m] >> bb).long() + q * n
        for q, (o, m) in enumerate(zip(np.asarray(k8a_a[2]).tolist(),
                                       np.asarray(k8a_a[3]).tolist()))])
    t_k8a = measure(
        "the serving mix's largest cterm launch, one K8a launch: %d rare "
        "terms, %d posting words, Kc = %d" % (
            len(k8a_a[2]), int(np.sum(k8a_a[3])), k8a_a[4]), "K8a",
        lambda: kc.cand_rows(*k8a_a, **k8a_kw),
        lambda: kc.cand_rows_plain(k8a_a[0], k8a_a[1], np.asarray(k8a_a[2]),
                                   np.asarray(k8a_a[3]), k8a_a[4], **k8a_kw),
        rl.k8a_work(k8a_a[3], k8a_a[4], k8a_kw.get("with_tf", True)),
        iters=20, old=parent is not None,
        library=lambda: torch.unique_consecutive(k8a_keys,
                                                 return_inverse=True))
    # K8b: the forced cphrase launch with a stopword co-term ("the" pooled,
    # "w1000" of its own slice), whole and its pooled half alone.  The
    # library times: the torch composition that builds both minis (the
    # pooled one by a pool[slot, flat] gather, the other by zeros,
    # searchsorted and an index_put_ whose misses land on a spare slot),
    # and that gather alone for the pooled half, each with its index
    # arithmetic (clip, shift, arange) inside the timed call
    (k8b_rows, k8b_slots, k8b_offs, k8b_ns), k8b_kw = next(
        c for c in pooled if (np.asarray(c[0][1])[:, 0] >= 0).all())
    k8b_slots = np.asarray(k8b_slots)
    k8b_kc = k8b_rows.shape[-1]
    k8b_pool = k8b_kw["pool"]
    check(k8b_slots.shape == (1, 2) and k8b_slots[0, 0] >= 0
          and k8b_slots[0, 1] < 0, "the K8b unit is one query, one pooled "
          f"mini and one of its own slice (slots {k8b_slots.tolist()})")
    k8b_rq = k8b_rows.reshape(-1, k8b_kc)[0].contiguous()
    k8b_slot = int(k8b_slots[0, 0])
    mini_off, mini_n = (int(np.asarray(k8b_offs)[0][1]),
                        int(np.asarray(k8b_ns)[0][1]))
    S = 1 << bb

    def k8b_gather():
        spread = torch.arange(S, device=dev.device)
        flat = (k8b_rq.clamp(0, n - 1).long()[:, None] * S
                + spread).reshape(-1)
        return k8b_pool[k8b_slot, flat]

    def k8b_torch():
        h = k8b_kw["hdrs"][mini_off: mini_off + mini_n]
        keys = h >> bb
        ci = torch.searchsorted(k8b_rq, keys).clamp(max=k8b_kc - 1)
        at = torch.where(k8b_rq[ci] == keys, ci.long() * S + (h & (S - 1)),
                         k8b_kc * S)
        own = torch.zeros(k8b_kc * S + 1, dtype=torch.int32,
                          device=dev.device).index_put_(
            (at,), k8b_kw["pays"][mini_off: mini_off + mini_n])
        return torch.stack([k8b_gather(), own[:k8b_kc * S]])

    half = ([[k8b_slot]], [[0]], [[0]])
    check(torch.equal(k8b_torch(), kc.cand_minis(
        k8b_rows, k8b_slots, k8b_offs, k8b_ns, **k8b_kw)) and torch.equal(
            k8b_gather()[None], kc.cand_minis(k8b_rq, *half, **k8b_kw)),
          "the torch composition of the K8b unit, and the gather of its "
          "pooled half, equal K8b")
    t_k8b = measure(
        "the forced cphrase [\"the\", \"w1000\"], one K8b launch: one "
        "pooled mini and one of its own slice (%d words), Kc = %d, %d slots "
        "each" % (mini_n, k8b_kc, k8b_kc << bb), "K8b",
        lambda: kc.cand_minis(k8b_rows, k8b_slots, k8b_offs, k8b_ns,
                              **k8b_kw),
        lambda: kc.minis_for_rows_plain(k8b_rows, k8b_slots, k8b_offs,
                                        k8b_ns, **k8b_kw),
        rl.k8b_work(k8b_kc, bb, 1, [mini_n], 1),
        iters=20, old=hasattr(parent, "sa_cand_minis"), library=k8b_torch)
    t_k8bp = measure(
        "the same launch's pooled half alone, one K8b launch: one pooled "
        "mini, Kc = %d, %d slots" % (k8b_kc, k8b_kc << bb), "K8b",
        lambda: kc.cand_minis(k8b_rq, *half, **k8b_kw),
        lambda: kc.minis_for_rows_plain(k8b_rq, np.asarray(half[0]),
                                        *half[1:], **k8b_kw),
        rl.k8b_work(k8b_kc, bb, 1, [], 1),
        iters=20, old=hasattr(parent, "sa_cand_minis"), library=k8b_gather)

    # K10: the similarity launches of one serving-mix call on the port's
    # routing, their inputs kept (a launch may overwrite its input) and
    # run again into buffers of their own.  No single PyTorch call computes
    # the similarity; the yardstick is the torch composition K10 replaced
    # (torch_similarity), over the same launches
    k10_calls, k10_orig = [], kc.similarity

    def k10_capture(kind, tfs, doc_lens, idf, avgdl, k1, b, out=None):
        k10_calls.append((kind, tfs.clone(), doc_lens,
                          idf.clone() if torch.is_tensor(idf) else idf,
                          avgdl, k1, b))
        return k10_orig(kind, tfs, doc_lens, idf, avgdl, k1, b, out=out)

    k10_capture.launches = 0
    kc.similarity = k10_capture
    # the route the fused ranking pass replaced, as for K3's units above
    fuses, dense.fuses = dense.fuses, never_fused
    try:
        arr.score_batch(serving_queries(12345), top_k=TOP_K)
    finally:
        kc.similarity = k10_orig
        kc.similarity.launches += k10_capture.launches
        dense.fuses = fuses
    k10_out = [torch.empty_like(c[1]) for c in k10_calls]

    def k10_plain(kind, tfs, doc_lens, idf, avgdl, k1, b, out=None):
        t2 = tfs.reshape(1, -1) if tfs.dim() == 1 else tfs
        i = idf.reshape(-1, 1) if torch.is_tensor(idf) else idf
        got = kc.similarity_plain(kind, t2, doc_lens.reshape(
            -1, t2.shape[1]), i, avgdl, k1, b).reshape(tfs.shape)
        return got if out is None else out.copy_(got)

    def k10_run(fn):
        return lambda: [fn(*c, out=o) for c, o in zip(k10_calls, k10_out)]

    def k10_rows(t):
        return (t.shape[0] if t.dim() == 2 else 1), t.shape[-1]

    k10_run(kc.similarity)()
    k10_got = [o.clone() for o in k10_out]
    k10_run(k10_plain)()
    check(len(k10_calls) > 0
          and all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                  for g, w in zip(k10_got, k10_out)),
          f"K10 equals similarity_plain bit for bit on the {len(k10_calls)} "
          "similarity launches of a serving-mix call")
    k10_elems = sum(c[1].numel() for c in k10_calls)
    t_k10 = measure(
        "the similarity launches of one serving-mix call: %d K10 launches, "
        "%d rows of %d docs" % (len(k10_calls), k10_elems // n, n), "K10",
        k10_run(kc.similarity), k10_run(k10_plain),
        rl.total(rl.k10_work(*k10_rows(c[1]), c[0],
                             c[2].numel() == c[1].numel() > n)
                 for c in k10_calls),
        iters=20, old=False, library=k10_run(torch_similarity))
    del k10_out, k10_got

    # K11: the composition launches of one edismax call (bench.py's
    # configuration, its first query) and of one edismax_batch of
    # bench.py's queries, their stacks kept and composed again into
    # buffers of their own.  No single PyTorch call computes the
    # composition; the yardstick is the torch composition K11 replaced
    # (torch_compose), over the same launches
    def k11_capture_of(call):
        calls, orig = [], kc.compose

        def capture(stacks, boosts, tie, msm, *, term_centric, chain=True,
                    out=None):
            calls.append((list(stacks), list(boosts), tie, msm,
                          term_centric, chain))
            return orig(stacks, boosts, tie, msm, term_centric=term_centric,
                        chain=chain, out=out)

        capture.launches = 0
        kc.compose = capture
        try:
            call()
        finally:
            kc.compose = orig
            kc.compose.launches += capture.launches
        outs = [torch.empty(c[0][0].shape[1], device=dev.device)
                for c in calls]

        def run(fn):
            return lambda: [fn(st, bo, ti, ms, term_centric=tc, chain=ch,
                               out=o)
                            for (st, bo, ti, ms, tc, ch), o in zip(calls,
                                                                   outs)]

        run(kc.compose)()
        got = [o.clone() for o in outs]
        run(kc.compose_plain)()
        check(len(calls) > 0 and all(
            torch.equal(g.view(torch.int32), w.view(torch.int32))
            for g, w in zip(got, outs)),
              f"K11 equals compose_plain bit for bit on the {len(calls)} "
              "composition launches of the call")
        work = rl.total(rl.k11_work([s.shape[0] for s in c[0]],
                                    c[0][0].shape[1]) for c in calls)
        return calls, run, work

    k11_calls, k11_run, k11_w = k11_capture_of(
        lambda: edismax(df, q=ED_QUERIES[0], top_k=TOP_K, **ED_KW))
    t_k11 = measure(
        "the composition of one edismax(%r) call: %d K11 launch, stacks "
        "of %s terms of %d docs" % (
            ED_QUERIES[0], len(k11_calls),
            [s.shape[0] for s in k11_calls[0][0]], n), "K11",
        k11_run(kc.compose), k11_run(kc.compose_plain), k11_w,
        iters=20, old=hasattr(parent, "sa_compose"),
        library=k11_run(torch_compose))
    k11b_calls, k11b_run, k11b_w = k11_capture_of(
        lambda: edismax_batch(df, ED_QUERIES, top_k=TOP_K, **ED_KW))
    t_k11b = measure(
        "the compositions of one edismax_batch of bench.py's %d queries: "
        "%d K11 launches over row views of the shared stacks" % (
            len(ED_QUERIES), len(k11b_calls)), "K11",
        k11b_run(kc.compose), k11b_run(kc.compose_plain), k11b_w,
        iters=20, old=hasattr(parent, "sa_compose"),
        library=k11b_run(torch_compose))
    del k11_calls, k11b_calls

    phase_done("kernels: timing")

    # one block=False serving call under the profiler: nothing may make the
    # host wait for the device between the call and collect(), the packed
    # result crosses in one copy, and its kernels by device time say where
    # a call's time goes.  Last, so that no qps window above ran in a
    # process the profiler had attached to.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaStreamWaitEvent")

    def profile_call(request, slops):
        for attempt in range(4):
            arr.score_batch(request(attempt), top_k=TOP_K, slop=slops)
            torch.cuda.synchronize()
            k10_at = kc.similarity.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with record_function("sa_enqueue"):
                    collect = arr.score_batch(request(10 + attempt),
                                              top_k=TOP_K, slop=slops,
                                              block=False)
                enqueue_ms = (time.perf_counter() - t0) * 1e3
                with record_function("sa_collect"):
                    collect()
                call_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
            k10_launched = kc.similarity.launches - k10_at
            events = list(prof.events())
            enq = [e for e in events if e.name == "sa_enqueue"]
            launches = [e for e in events if e.name == "cudaLaunchKernel"]
            k10_seen = sum(1 for e in events
                           if e.device_type == DeviceType.CUDA
                           and "similarity_kernel" in e.name)
            if enq and launches and k10_seen == k10_launched:
                break
            print("profiler: no launch events seen; profiling again",
                  flush=True)
        else:
            raise AssertionError("the profiler saw no kernel launch, or "
                                 "not every K10 launch")
        end = enq[0].time_range.end
        waits = [e.name for e in events if e.name in SYNCS[:3]
                 and e.time_range.start < end]
        d2h = [e for e in events if e.device_type == DeviceType.CUDA
               and "Memcpy DtoH" in e.name]
        # the two ranges above show as device-side annotations: not work
        dev_us = [(e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key not in ("sa_enqueue", "sa_collect")]
        dev_us.sort(key=lambda e: -e[1])
        return {"enqueue_ms": enqueue_ms, "call_ms": call_ms,
                "waits_before_collect": waits, "d2h_copies": len(d2h),
                "kernel_launches": len(launches),
                "k10_launches": k10_launched, "k10_events": k10_seen,
                "device_ms": sum(e[1] for e in dev_us) / 1e3,
                "top": [(k[:60], us / 1e3, c) for k, us, c in dev_us[:12]]}

    def profile_edismax(frame, q, **kw):
        """One edismax call under the profiler: host ms of the call, its
        device ms by kernel."""
        for attempt in range(4):
            edismax(frame, q=q, top_k=TOP_K, **ED_KW, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                edismax(frame, q=q, top_k=TOP_K, **ED_KW, **kw)
                call_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
            dev_us = [(e.key, e.self_device_time_total, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            if dev_us:
                break
            print("profiler: no device events seen; profiling again",
                  flush=True)
        else:
            raise AssertionError("the profiler saw no device event")
        dev_us.sort(key=lambda e: -e[1])
        return {"call_ms": call_ms,
                "kernel_launches": sum(c for _, _, c in dev_us),
                "device_ms": sum(e[1] for e in dev_us) / 1e3,
                "top": [(k[:60], us / 1e3, c) for k, us, c in dev_us[:12]]}

    k8a_before = kc.cand_rows.launches
    with engine(True):
        prof_mix = profile_call(lambda i: serving_queries(7000 + i),
                                [0] * mix_n)
    k8a_profiled = kc.cand_rows.launches - k8a_before
    check(k8a_profiled >= 2,
          f"the profiled serving mix calls ran their rare terms as cterm "
          f"groups ({k8a_profiled} K8a launches over the warm and the "
          "profiled calls)")
    with engine(True):
        prof_mixs = profile_call(lambda i: mixed_request(8000 + i)[0], ss)
    # the same requests on the port's default routing
    fused_before = kc.rank_rows.launches
    prof_mix_off = profile_call(lambda i: serving_queries(7500 + i),
                                [0] * mix_n)
    prof_mixs_off = profile_call(lambda i: mixed_request(8500 + i)[0], ss)
    fused_off = kc.rank_rows.launches - fused_before
    k10_seen = [(p["k10_launches"], p["k10_events"])
                for p in (prof_mix, prof_mixs, prof_mix_off, prof_mixs_off)]
    # on the candidate engine's routing its finish runs K10; on the port's,
    # every ranked group is the fused pass and no K10 runs
    check(all(a == e for a, e in k10_seen) and k10_seen[0][0] > 0
          and k10_seen[1][0] > 0 and fused_off > 0,
          "every profiled serving and mixed call ran as many K10 launches as "
          "the profiler's K10 events (on, off: "
          f"{k10_seen}); on the port's routing they ranked by the fused "
          f"pass ({fused_off} launches)")
    k9_before = kc.span_sparse.launches
    prof_k9 = profile_call(
        lambda i: mixed_request(9000 + i)[0] + [q for q, _ in k9_extra], k9s)
    # by the wrapper's counter: the profiler may drop device events
    k9_profiled = kc.span_sparse.launches - k9_before
    check(k9_profiled >= 2 * len(k9_extra)
          and k9_profiled % len(k9_extra) == 0,
          f"every call of the profiled request with slop phrases outside "
          f"the dense window launched {len(k9_extra)} K9 kernels")
    for name, p in (("serving mix", prof_mix),
                    ("mixed request with slop", prof_mixs),
                    ("mixed request with K6 and K9 slop phrases", prof_k9)):
        check(not p["waits_before_collect"] and p["d2h_copies"] == 1,
              f"a block=False {name} call enqueues {p['kernel_launches']} "
              f"kernels in {p['enqueue_ms']:.3f} ms with no host "
              "synchronisation before collect(), and its result crosses in "
              "one device-to-host copy")
    prof_ed = [(name, profile_edismax(frame, ED_QUERIES[0], **kw))
               for name, frame, kw in (
                   ("1M docs", df, {}),
                   ("1M docs, ps=2, ps2=1", df, ED_SLOP),
                   ("long-document frame, ps=2", ldf, {"ps": SLOP}))]
    # 3e's threads under the profiler (here, after the qps windows and the
    # kernel timing, as every profiled run): its kernel events against the
    # wrappers' counts (a K3 launch enqueues one, two or nine kernels)
    thr_counter = {"K1": lambda: (kc.score_term.launches
                                  + kc.score_term_rows.launches),
                   "K2": lambda: kc.segment_sum.launches,
                   "K3": lambda: kc.topk.kernels,
                   "K4": lambda: kc.plane_fill.launches,
                   "K5": lambda: kc.phrase_chain.launches,
                   "K6": lambda: kc.span_window.launches,
                   "K7": lambda: kc.merge_step.launches,
                   "K8a": lambda: (kc.cand_rows.launches
                                   * kc.CAND_ROWS_KERNELS_PER_LAUNCH),
                   "K8b": lambda: kc.cand_minis.launches,
                   "K9": lambda: kc.span_sparse.launches,
                   "K10": lambda: kc.similarity.launches,
                   "K11": lambda: kc.compose.launches}
    for attempt in range(4):
        before = {k: f() for k, f in thr_counter.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_got = run_threads(T_MAX, thread_item, True)
            torch.cuda.synchronize()
        thr_launched = {k: f() - before[k] for k, f in thr_counter.items()}
        dev_names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        thr_seen = {k: sum(1 for nm in dev_names
                           if any(sub in nm for sub in KERNEL_NAMES[k]))
                    for k in thr_counter}
        if thr_seen == thr_launched:
            break
        print(f"profiler: saw {thr_seen} of {thr_launched}; profiling "
              "again", flush=True)
    check(thr_seen == thr_launched and thr_launched["K3"] > 0
          and same_items(prof_got[0], thr_ref[0]),
          f"a profiled run of {T_MAX} threads, each on its own stream: the "
          f"profiler's kernel events per kernel {thr_seen} equal the "
          f"wrappers' counts {thr_launched}")

    thread_evidence.append(
        ("concurrent queries: profiled run's kernel events; wrapper counts",
         f"{thr_seen}; {thr_launched}"))
    phase_done("serving call profile")

    # observability: hbm_report of the body index after serving, and
    # trace() around one block=False serving call, whose Chrome trace must
    # name the hand-written kernels the profile of such a call showed
    from searcharray_tpu_torch.utils import profiling

    hbm = profiling.hbm_report(arr)
    check(hbm["index.total"] >= hbm["index.hdrs"] + hbm["index.pays"]
          and hbm["pool.plane_pool"] > 0 and hbm["pool.tf_pool"] > 0
          and hbm["pool.tf_pool.slots_used"] > 0
          and hbm.get("device.bytes_in_use", -1) >= hbm["index.total"],
          f"hbm_report of the body index: {hbm}")
    trace_dir = tempfile.mkdtemp(prefix="sa_trace_")
    atexit.register(shutil.rmtree, trace_dir, True)
    with profiling.trace(trace_dir):
        arr.score_batch(serving_queries(9900), top_k=TOP_K, block=False)()
        torch.cuda.synchronize()
    (trace_file,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace_file)) as f:
        traced = {e.get("name", "") for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"}

    def k_labels(kernel_names):
        return sorted({k for k, subs in names.items()
                       if any(sub in name for sub in subs
                              for name in kernel_names)})

    traced_k = k_labels(traced)
    profiled_k = k_labels([key for key, _, _ in prof_mix_off["top"]])
    check(set(profiled_k) <= set(traced_k) and "K3+K10" in traced_k,
          f"trace() wrote {trace_file} ({os.path.getsize(os.path.join(trace_dir, trace_file))} "
          f"bytes), naming {traced_k}; the profiled serving call showed "
          f"{profiled_k}")
    phase_done("observability")

    evidence = [
        ("corpus generation s", corpus_s),
        ("host build s (SearchArray.index)", build_s),
        ("upload s (posting planes)", upload_s),
        ("warm s (tf pool prefill)", warm_s),
        ("p50 score('what') ms", score_ms),
        ("p50 topk('star', k=10) ms", topk_ms),
        *((f"score_batch qps {name}, {WINDOWS} windows of {calls} calls "
           f"(median; windows; K1 launches per call)",
           f"{float(np.median(rates))}; {rates}; {fills}")
          for name, calls, rates, fills in (
              (f"hot blocking ({len(queries)} terms, top_k=10)",
               HOT_CALLS, qps_hot, fills_hot),
              (f"hot pipelined ({len(queries)} terms, top_k=10)",
               HOT_CALLS, qps_pipe, fills_pipe),
              ("cold blocking (200 fresh rare terms, top_k=10)",
               COLD_CALLS, qps_cold, fills_cold),
              (f"serving mix blocking (bench.serving_queries, {mix_n} "
               "queries, half phrases, top_k=10)", MIX_CALLS, qps_mix,
               fills_mix),
              (f"serving mix pipelined (bench.serving_queries, {mix_n} "
               "queries, half phrases, top_k=10)", MIX_CALLS, qps_mixp,
               fills_mixp),
              (f"mixed request blocking (bench.serving_queries + "
               f"bench.slop_queries, {mixs_n} queries, 24 of them slop-"
               f"{SLOP} phrases, top_k=10)", MIX_CALLS, qps_mixs,
               fills_mixs),
              (f"mixed request pipelined (bench.serving_queries + "
               f"bench.slop_queries, {mixs_n} queries, 24 of them slop-"
               f"{SLOP} phrases, top_k=10)", MIX_CALLS, qps_mixsp,
               fills_mixsp))),
        ("serving mix K4 and K5 launches per call", k45_per_call),
        ("mixed request K3 and K6 launches per call", k36_per_call),
        (f"p50 score(phrase, slop={SLOP}) ms for {slop_shapes[0]} and "
         f"{slop_shapes[2]} (cached phrase-tf rows)", slop_ms),
        (f"p50 termfreqs({wide_q}, slop={wide_slop}) ms (a cached "
         "phrase-tf row)", tf_wide_ms),
        *((f"one block=False {name} call under the profiler: enqueue ms; "
           "call ms; device ms; kernel launches; host waits before "
           "collect(); device-to-host copies",
           f"{p['enqueue_ms']}; {p['call_ms']}; {p['device_ms']}; "
           f"{p['kernel_launches']}; {p['waits_before_collect']}; "
           f"{p['d2h_copies']}")
          for name, p in (("serving mix, the JAX package's thresholds "
                           "(candidate engine on)", prof_mix),
                          ("mixed request with slop, the JAX package's "
                           "thresholds", prof_mixs),
                          ("serving mix, the port's default routing "
                           "(candidate engine off at 1M)", prof_mix_off),
                          ("mixed request with slop, the port's default "
                           "routing", prof_mixs_off),
                          ("mixed request with K6 and K9 slop phrases",
                           prof_k9))),
        *((f"one {name} call, device ms by kernel (name, ms, launches), "
           "the 12 largest", p["top"])
          for name, p in (("serving mix", prof_mix),
                          ("mixed request with slop", prof_mixs),
                          ("mixed request with K6 and K9 slop phrases",
                           prof_k9))),
        *((f"edismax(top_k=10), {name}: p50 and p95 ms per call over "
           f"{ED_CALLS} passes of bench.py's {len(ED_QUERIES)} queries; "
           f"edismax_batch qps, {WINDOWS} windows of {ED_CALLS} calls "
           "(median; windows)",
           f"{lat}; {float(np.median(rates))}; {rates}")
          for name, lat, rates in ed_stats),
        *((f"one edismax({ED_QUERIES[0]!r}, top_k=10) call under the "
           f"profiler, {name}: host ms; device ms; kernel launches; device "
           "ms by kernel (name, ms, launches), the 12 largest",
           f"{p['call_ms']}; {p['device_ms']}; {p['kernel_launches']}; "
           f"{p['top']}") for name, p in prof_ed),
        ("edismax phase kernel launches on the main path", ed_launches),
        ("candidate engine on the main path: group kinds of the serving "
         "mix and topk of a rare term on the port's default routing; the "
         "mixed request with slop there; the serving mix and topk at the "
         "JAX package's thresholds; the forced phase",
         [kinds_default, kinds_mixs, kinds_mix, kinds_topk, kinds_forced]),
        ("K8a and K8b launches on the main path (default routing; JAX "
         "thresholds; forced; all) and K8b launches of edismax's first pass "
         "at 1M (pruned at the JAX threshold)",
         [k8_default, k8_jax, k8_forced,
          (launches["cand_rows"], launches["cand_minis"]), ed_k8b]),
        ("edismax at 1M, first pass: docs matched where the phases were "
         "pruned to them (None: the mask path)", ed_pruned),
        ("candidate engine and phase pruning on/off in turns, each from an "
         "empty phrase-tf cache (serving mix qps, mixed request with slop "
         "qps, kernel launches per call, edismax p50 ms)", onoff),
        ("candidate engine and phase pruning on/off: medians of the turns",
         onoff_medians),
        (f"long-document request with slop score_batch qps ({len(lsq)} "
         f"queries, {len(slop_queries(0))} of them slop-{SLOP} phrases, "
         f"top_k=10), {WINDOWS} windows of {LMIX_CALLS} calls (median; "
         "windows)", f"{float(np.median(qps_lsmix))}; {qps_lsmix}"),
        ("K9 launches on the main path (windowed shapes; wide, repeated "
         "and the mixed request; long-document requests, two calls; "
         "edismax on the long-document frame)",
         [k9_windows, k9_1m - k9_windows, k9_long, k9_ed]),
        ("K3 per launch of one mixed request (rows; bound ms; device ms)",
         k3_each),
        ("K3 device operations per call of one mixed request (profiler "
         "events; new, parent)", k3_ops),
        ("K6 per window launch of one mixed request ((queries, w, "
         "multiplicities); bound ms, by; device ms)",
         [(shape, w["bound_ms"], w["bound_by"], ms)
          for shape, w, ms in k6_each]),
        ("K6 distinct plane rows of one mixed request's window launches",
         f"{k6_planes} of {4 * n * (1 << bb)} bytes each"),
        *((f"{name}{'' if name.endswith('ms') else ' score_batch qps'}, "
           f"one window a turn "
           f"({'parent, new, new, parent, twice' if parent else 'new'})",
           turns)
          for name, turns in e2e.items()),
        (f"p50 score({ph3}) ms (a cached phrase-tf row)", score_ph_ms),
        (f"p50 termfreqs({ph4}) ms (a cached phrase-tf row)", tf_ph_ms),
        (f"p50 score(phrase, {WIN_SCORE}) ms for {phrases[0]} and "
         f"{phrases[3]} (the sparse chain: K7 and K2 per step)", win_ph_ms),
        (f"long-document serving mix score_batch qps ({len(lmix)} queries, "
         f"half phrases, top_k=10), {WINDOWS} windows of {LMIX_CALLS} calls "
         "(median; windows)",
         f"{float(np.median(qps_lmix))}; {qps_lmix}"),
        ("K7 launches on the main path (windowed phrases; 40-term phrase; "
         "long-document mix, two calls) and the steps of the mix's longest "
         "chain half", [k7_windows, k7_long, k7_lmix, lmix_steps]),
        *((f"{rec['unit']}: device ms "
           f"({'old, new, new, old' if rec['old'] else 'new, new'}); bound "
           "ms; share of the bound (new, old)",
           f"{rec['device_ms']}; {rec['bound_ms']}; {rec['share']}, "
           f"{rec.get('old_share')}")
          for rec in (t_what, t_rare, t_rows, t_k2, t_k2s, t_k2c, t_k2w, t_k4,
                      t_k5, t_serve, t_k7, t_k7b, t_k7g, t_k3, t_k3s, t_k3t,
                      t_k6,
                      t_k6w, t_k9, t_k9b, t_k9w, t_k9bw, t_k2s9, t_k8a,
                      t_k8b, t_k8bp, t_k10)),
        ("K10 on the main path: launches, similarity calls held to "
         "similarity_plain bit for bit, (kind, shape, per-element lengths) "
         "seen, max abs err",
         f"{launches['similarity']}; {k10_rec.calls}; "
         f"{len(k10_rec.shapes)}; {k10_rec.err}"),
        ("K10 unit: device ms; the torch composition it replaced, device "
         "ms", f"{t_k10['new_device_ms']}; {t_k10['library_device_ms']}"),
        ("K2 1M sparse term group over its uniform control, device ms "
         "(new; old)",
         f"{t_k2s['new_device_ms'] / t_k2c['new_device_ms']}; "
         f"{t_k2s['old_device_ms'] / t_k2c['old_device_ms'] if t_k2s['old'] else None}"),
        ("K5 plane rows of the first mixed batch (distinct across the "
         "batch, which the bound counts; fetched, each launch's distinct "
         "rows summed over its launches)",
         f"{k5_planes[0]}; {k5_planes[1]} of "
         f"{4 * n * (1 << bb)} bytes each"),
        ("K5 per group launch of the first mixed batch (queries, terms, "
         "plan halves; bound ms; device ms)",
         [(shape, w["bound_ms"], ms) for shape, w, (ms, _) in k5_each]),
        *slice_evidence,
        *sharded_evidence,
        *warm_evidence,
        *thread_evidence,
        ("K3 merge of the sharded path: device ms; bound ms; torch.topk "
         "device ms", f"{t_k3m['new_device_ms']}; {t_k3m['bound_ms']}; "
         f"{t_k3m['library_device_ms']}"),
        ("edismax checks: the largest relative difference of a score "
         "from the oracle's (rtol 1e-6 allowed)", ED_REL_ERR[0]),
        ("plane pool bytes", dev.plane_pool.numel() * 4),
        ("max memory allocated bytes (main path)", peak_bytes),
        ("wall s per phase", phases),
        ("wall s in main()", marks[-1] - marks[0]),
    ]
    for name, value in evidence:
        print(f"evidence: {name} = {value} {tag}", flush=True)
    def entry(name, source, replaces, n_launches, err, rec):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n_launches,
               "max_abs_err": err, "unit": rec["unit"], "ms": rec["ms"],
               "device_ms": rec["new_device_ms"],
               "plain_ms": rec["plain_ms"],
               "plain_device_ms": rec["plain_device_ms"],
               "bytes": rec["bytes"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"], "share_of_bound": rec["share"],
               "library_ms": rec.get("library_ms"),
               "library_device_ms": rec.get("library_device_ms")}
        if rec["old"]:
            out["parent_device_ms"] = rec["old_device_ms"]
        return out

    def unit_of(rec):
        keys = ("unit", "new_device_ms", "old_device_ms", "bound_ms",
                "share", "library_device_ms")
        return {k: rec[k] for k in keys if k in rec}

    csrc = "searcharray_tpu_torch/csrc/"
    k1_tpu = "searcharray_tpu/ops/pallas/score.py:86"
    # each kernel's largest difference over phase 5's checks and every
    # launch of the sharded and warm-up paths (PlainCheck)
    k1_err, k1r_err, k2_err, k3_err, k4_err, k5_err, k6_err, k7_err, \
        k9_err = (max(e, sh_check.err[h], w_check.err[h], t_check.err[h])
                  for e, h in (
            (k1_err, "K1"), (k1r_err, "K1 rows"), (k2_err, "K2"),
            (k3_err, "K3"), (k4_err, "K4"), (k5_err, "K5"), (k6_err, "K6"),
            (k7_err, "K7"), (k9_err, "K9")))
    print(json.dumps({"kernels": [
        entry("score_term (K1)", csrc + "score_term.cu", k1_tpu,
              launches["score_term"], k1_err, t_what),
        entry("score_term_rows (K1, multi-row tf fill)",
              csrc + "score_term.cu", k1_tpu, launches["score_term_rows"],
              k1r_err, t_rows),
        {**entry("segment_sum (K2)", csrc + "segment_sum.cu",
                 "searcharray_tpu/ops/pallas/score.py:196",
                 launches["segment_sum"], k2_err, t_k2),
         "more_units": [unit_of(t_k2s), unit_of(t_k2c), unit_of(t_k2w),
                        unit_of(t_k2s9)]},
        {**entry("topk (K3)", csrc + "topk.cu",
                 "searcharray_tpu/ops/kernels.py:101", launches["topk"],
                 k3_err, t_k3),
         "more_units": [unit_of(t_k3s), unit_of(t_k3t), unit_of(t_k3m)]},
        entry("plane_fill (K4)", csrc + "plane_fill.cu",
              "searcharray_tpu/search/dense.py:222", launches["plane_fill"],
              k4_err, t_k4),
        entry("phrase_chain (K5)", csrc + "phrase_chain.cu",
              "searcharray_tpu/search/dense.py:558",
              launches["phrase_chain"], k5_err, t_k5),
        {**entry("span_window (K6)", csrc + "span_window.cu",
                 "searcharray_tpu/search/dense.py:625",
                 launches["span_window"], k6_err, t_k6),
         "more_units": [unit_of(t_k6w)]},
        {**entry("merge_step (K7)", csrc + "merge_step.cu",
                 "searcharray_tpu/search/phrase.py:123",
                 launches["merge_step"], k7_err, t_k7),
         "more_units": [unit_of(t_k7b), unit_of(t_k7g)]},
        {**entry("span_sparse (K9)", csrc + "span_sparse.cu",
                 "searcharray_tpu/search/spans.py:54",
                 launches["span_sparse"], k9_err, t_k9),
         "more_units": [unit_of(t_k9b), unit_of(t_k9w), unit_of(t_k9bw)]},
        # the largest difference over every main-path launch (K8Recorder)
        # and every sharded- and warm-up-path launch (PlainCheck)
        entry("cand_rows (K8a)", csrc + "cand_rows.cu",
              "searcharray_tpu/search/candidates.py:201",
              launches["cand_rows"],
              max(rec.err["K8a"], sh_check.err["K8a"], w_check.err["K8a"],
                  t_check.err["K8a"]),
              t_k8a),
        {**entry("cand_minis (K8b)", csrc + "cand_minis.cu",
                 "searcharray_tpu/search/candidates.py:258",
                 launches["cand_minis"],
                 max(rec.err["K8b"], sh_check.err["K8b"],
                     w_check.err["K8b"], t_check.err["K8b"]), t_k8b),
         "more_units": [unit_of(t_k8bp)]},
        # the largest difference over every launch of the counted paths
        # (K10Recorder); no single PyTorch call computes the similarity:
        # the torch composition K10 replaced is its yardstick
        {**entry("similarity (K10)", csrc + "similarity.cu",
                 "searcharray_tpu/search/scoring.py:29",
                 launches["similarity"],
                 max(k10_rec.err, k10_slice.err, k10_sh.err,
                     k10_warm.err, k10_thr.err), t_k10),
         "library_ms": None, "library_device_ms": None,
         "torch_composition_ms": t_k10["library_ms"],
         "torch_composition_device_ms": t_k10["library_device_ms"]},
        # the largest difference over every launch of the main path
        # (K8Recorder) and of the sharded, warm-up and thread paths
        # (PlainCheck); no single PyTorch call ranks a similarity: the torch
        # composition of the route it replaced is its yardstick, and that
        # route on this tree's kernels (gather, K10, K3) stands beside it
        {**entry("rank_rows (K3+K10)", csrc + "topk.cu",
                 "searcharray_tpu/search/scoring.py:29 with "
                 "searcharray_tpu/ops/kernels.py:101",
                 launches["rank_rows"],
                 max(rec.err["K3+K10"], sh_check.err["K3+K10"],
                     w_check.err["K3+K10"], t_check.err["K3+K10"]), t_rank),
         "library_ms": None, "library_device_ms": None,
         "torch_composition_ms": t_rank["library_ms"],
         "torch_composition_device_ms": t_rank["library_device_ms"],
         "replaced_device_ms": t_rank["replaced_device_ms"]},
        # the largest difference over every launch of the counted paths
        # (K11Recorder); no single PyTorch call composes: the torch
        # composition K11 replaced is its yardstick
        {**entry("compose (K11)", csrc + "compose.cu",
                 "searcharray_tpu/solr.py:110", launches["compose"],
                 max(k11_rec.err, k11_slice.err, k11_sh.err,
                     k11_warm.err, k11_thr.err), t_k11),
         "library_ms": None, "library_device_ms": None,
         "torch_composition_ms": t_k11["library_ms"],
         "torch_composition_device_ms": t_k11["library_device_ms"],
         "more_units": [{**{k: v for k, v in unit_of(t_k11b).items()
                            if k != "library_device_ms"},
                         "torch_composition_device_ms":
                         t_k11b.get("library_device_ms")}]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
