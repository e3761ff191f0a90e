"""Device-resident index: the posting planes and scoring metadata as torch
tensors on an explicit device.

The CSR posting store is uploaded once as two parallel 32-bit planes:
``hdrs`` (doc << blk_bits | block) and ``pays`` (the 18-bit position
bitmap).  Both are int32: the payload fits in 18 bits and every header is
below ``PAD_HDR32 < 2^31 - 16``, so signed shifts are exact (torch has no
shifts on uint32).  Term lookup stays on the host (vocab dict ->
offset/length).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from searcharray_tpu_torch.index.builder import (
    BuiltIndex,
    DocTermMatrix,
    TermPostings,
)
from searcharray_tpu_torch.index.vocab import Vocabulary
from searcharray_tpu_torch.ops import encoding as enc
from searcharray_tpu_torch.ops.kernels import (
    PAD_HDR32,
    blk_bits_for,
    bucket_of,
    compress_planes,
    expand_bucket_of,
)
from searcharray_tpu_torch.utils import profiling


def derive_attach_arrays(built: BuiltIndex,
                         blk_bits: Optional[int] = None) -> dict:
    """The host-side arrays a DeviceIndex uploads: the tail-padded hdr32 /
    pay32 planes, in the JAX package's layout, so the port attaches the
    JAX package's arrays too.  The JAX package also derives a per-term
    block-word max, which bounds its Pallas grid; K1 binary-searches each
    block's word range instead, so DeviceIndex neither derives nor reads
    it (``index/store.py`` computes it for the stores the JAX package
    loads).  ``blk_bits`` is derived from the longest doc unless given (a
    shard takes its partition's)."""
    max_len = int(built.postings.lengths.max()) if built.postings.num_terms else 0
    max_bucket = max(bucket_of(max(1, max_len)),
                     expand_bucket_of(max(1, max_len)))
    if blk_bits is None:
        max_doc_len = float(built.doc_lens.max()) if len(built.doc_lens) else 1
        blk_bits = blk_bits_for(int(max_doc_len))
    hdr, pay = compress_planes(built.postings.data, blk_bits)
    pad_h = np.full(max_bucket, PAD_HDR32, dtype=np.int32)
    pad_p = np.zeros(max_bucket, dtype=np.uint32)
    return {
        "hdr32": np.concatenate([hdr, pad_h]),
        "pay32": np.concatenate([pay, pad_p]),
        "blk_bits": blk_bits,
        "max_bucket": max_bucket,
    }


def canonical_device(device) -> torch.device:
    """``device`` with its index: "cuda" names the current card, so that
    the index's tensors and every later host-to-device copy for it land on
    one card whatever the current device is then."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


UPLOAD_CHUNK = 1 << 24   # elements a pinned staging copy moves (64 MB)


def upload_i32(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host 32-bit array (int32, or uint32 read as int32) as an int32
    tensor on ``device``.  A store's read-only memmap is read chunk by
    chunk: on a card each chunk goes through one pinned staging buffer, on
    the CPU into a tensor of its own (a read-only array cannot back a
    tensor)."""
    arr = np.asarray(arr)
    if arr.dtype != np.int32:
        arr = arr.view(np.int32)
    if device.type != "cuda":
        if arr.flags.writeable:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        return torch.from_numpy(np.array(arr)).to(device)
    out = torch.empty(len(arr), dtype=torch.int32, device=device)
    stage = torch.empty(min(len(arr), UPLOAD_CHUNK),
                        dtype=torch.int32).pin_memory()
    for lo in range(0, len(arr), UPLOAD_CHUNK):
        m = min(UPLOAD_CHUNK, len(arr) - lo)
        stage[:m].numpy()[:] = arr[lo: lo + m]
        # blocking: the next chunk reuses the staging buffer
        out[lo: lo + m].copy_(stage[:m])
    return out


class SlotMaps:
    """The host side of the plane and tf pools (``search/dense.py``): key
    -> slot maps in LRU order, their free lists and capacities (set when
    a pool starts, 0 until then), and the phrase-tf cache's state
    (``phrase_hits`` counts encounters per (tids, slop) signature;
    ``phrase_recipes`` holds a promoted signature's (terms, fill key)).
    ``corpus_size``, ``blk_bits`` and ``pool_share`` size the pools: the
    largest doc count and device share of the indexes that fill them.  A
    DeviceIndex owns one; the shards of a ``ShardedIndex`` that serve one
    query part share one, so a key lands in the same pool row on every
    shard and one plan of a batch holds for all of them.

    The maps are also what concurrent queries contend for: a plan
    reserves rows that its run fills and reads later, so one thread at a
    time holds them (``held``) from its reservation to its last launch.
    ``holds`` and ``hold_seconds`` count the outermost holds and their
    time on the host clock."""

    def __init__(self, corpus_size: int, blk_bits: int, pool_share: int):
        self.corpus_size = int(corpus_size)
        self.blk_bits = int(blk_bits)
        self.pool_share = int(pool_share)
        self.plane_slot: "OrderedDict[int, int]" = OrderedDict()
        self.plane_free: list = []
        self.plane_cap = 0
        self.tf_slot: "OrderedDict[object, int]" = OrderedDict()
        self.tf_free: list = []
        self.tf_cap = 0
        self.phrase_hits: dict = {}
        self.phrase_recipes: dict = {}
        # re-entrant: edismax's phases, warm-up and the facade nest calls
        self.lock = threading.RLock()
        self._depth = 0
        self._since = 0.0
        self._done: dict = {}   # device -> the last holder's CUDA event
        self.holds = 0
        self.hold_seconds = 0.0

    @contextlib.contextmanager
    def held(self, devices: Iterable[torch.device]):
        """Hold the maps, and order the pools of ``devices`` across
        streams: on entry the caller's current stream on each card waits
        for the event the previous holder recorded on its own stream; on
        exit the caller's stream records that event.  So a fill that
        evicts a row runs after every earlier reader of the row, and a
        read after the fill that wrote it, whatever stream each thread
        launches on.  On the CPU the lock alone orders the work.  Hold it
        over host planning and enqueues only, never over a wait on the
        device.

        Where spans are recorded (``utils/profiling.py``), an outermost
        hold's wait for the lock is a ``batch.lock_wait`` span, and the
        stream ordering on entry and on exit a ``batch.order`` span
        each."""
        cards = [d for d in devices if d.type == "cuda"]
        asked = time.perf_counter_ns() if profiling.active() else 0
        with self.lock:
            self._depth += 1
            if self._depth == 1:
                self._since = time.perf_counter()
                if asked:
                    profiling.mark("batch.lock_wait", asked,
                                   time.perf_counter_ns())
            try:
                if cards:
                    with profiling.span("batch.order"):
                        for d in cards:
                            ev = self._done.get(d)
                            if ev is not None:
                                torch.cuda.current_stream(d).wait_event(ev)
                yield self
            finally:
                if cards:
                    with profiling.span("batch.order"):
                        for d in cards:
                            ev = self._done.get(d)
                            if ev is None:
                                ev = self._done[d] = torch.cuda.Event()
                            ev.record(torch.cuda.current_stream(d))
                self._depth -= 1
                if self._depth == 0:
                    self.holds += 1
                    self.hold_seconds += time.perf_counter() - self._since


class DeviceIndex:
    """Device copy of a built index on ``device`` (immutable postings, plus
    the lazily allocated plane and tf pools and their host-side slot
    maps).

    One shard of a doc-axis partition (``parallel/sharded.py``) is a
    DeviceIndex too: its ``built`` holds the shard's re-based postings and
    doc lengths beside the corpus's vocabulary, ``doc_freqs`` and
    ``avg_doc_length``; ``stats_docs`` is the corpus's doc count, which
    every idf reads (``corpus_size`` stays the shard's own: pools, planes,
    key strides, routing); ``blk_bits`` is the partition's, never derived
    from the shard's own longest doc; ``stats_lengths`` is the corpus's
    per-term posting words, which choose a slop phrase's anchor; and
    ``pool_share`` shards on one device divide the pools' byte budgets
    between them."""

    def __init__(self, built: BuiltIndex, device, *,
                 blk_bits: Optional[int] = None,
                 stats_docs: Optional[int] = None,
                 stats_lengths: Optional[np.ndarray] = None,
                 pool_share: int = 1):
        self.built = built
        self.device = canonical_device(device)
        self.postings = built.postings          # host CSR (numpy, uint64)
        self.doc_term = built.doc_term
        self.vocab: Vocabulary = built.vocab
        self.doc_lens_np = built.doc_lens
        self.avg_doc_length = built.avg_doc_length
        self.corpus_size = int(len(built.doc_lens))
        self.stats_docs = (self.corpus_size if stats_docs is None
                           else int(stats_docs))
        self.pool_share = max(1, int(pool_share))
        self.doc_freqs = built.doc_freqs  # host int64[V], precomputed
        # per-term posting words of the corpus (a slop phrase's anchor is
        # its term with the fewest)
        self.stats_lengths = (built.postings.lengths if stats_lengths is None
                              else stats_lengths)
        # kind -> float64 [V], each term's part of a query's idf on
        # ``doc_freqs`` and ``stats_docs`` (host memory, built the first
        # time an idf reads it: ``search/scoring.py:idf_table``)
        self.idf_tables: dict = {}

        max_len = int(built.postings.lengths.max()) if built.postings.num_terms else 0
        # tail padding covers the largest bucket-sized slice taken at any
        # term's offset
        self.max_bucket = max(bucket_of(max(1, max_len)),
                              expand_bucket_of(max(1, max_len)))
        max_doc_len = float(built.doc_lens.max()) if len(built.doc_lens) else 1
        self._max_doc_len = max_doc_len
        self.blk_bits = (blk_bits_for(int(max_doc_len)) if blk_bits is None
                         else int(blk_bits))

        der = (self._usable_derived(built)
               or derive_attach_arrays(built, blk_bits=self.blk_bits))
        self.hdrs = upload_i32(der["hdr32"], self.device)
        self.pays = upload_i32(der["pay32"], self.device)
        # a copy: a store's doc lengths may be a read-only memmap
        self.doc_lens = torch.as_tensor(
            np.array(built.doc_lens, dtype=np.float32), device=self.device)
        # Device pools (search/dense.py), each allocated on first use:
        # plane_pool int32[C, N << blk_bits] (one term payload plane per
        # slot) and tf_pool f32[Ct, N]; their slot maps and the phrase-tf
        # cache (tf_slot keys may also be (tids, slop) phrase signatures)
        # are ``maps``, shared by the shards of one query part.
        self.plane_pool: Optional[torch.Tensor] = None
        self.tf_pool: Optional[torch.Tensor] = None
        self.maps = SlotMaps(self.corpus_size, self.blk_bits,
                             self.pool_share)

    def _usable_derived(self, built: BuiltIndex):
        """Precomputed attach arrays, or None if absent or stale (layout
        constants must match what this code would derive; keys the port
        does not read are ignored).  Past the W posting words a plane holds
        only its pad (PAD_HDR32 headers, zero payloads), at least
        ``max_bucket`` of it: a store's is exactly that, a shard store's
        row runs on to the partition's widest shard.  Every entry past W
        is read: a longer tail of pad is cut, anything else is stale."""
        der = built.derived
        if (not der or der.get("blk_bits") != self.blk_bits
                or der.get("max_bucket", self.max_bucket) != self.max_bucket):
            return None
        W = len(built.postings.data)
        hdr, pay = der["hdr32"], der["pay32"]
        if (len(hdr) != len(pay) or len(hdr) < W + self.max_bucket
                or not (np.all(hdr[W:] == PAD_HDR32)
                        and np.all(pay[W:] == 0))):
            return None
        end = W + self.max_bucket
        return {**der, "hdr32": hdr[:end], "pay32": pay[:end],
                "max_bucket": self.max_bucket}

    def held(self):
        """Hold this index's slot maps on its device (``SlotMaps.held``)."""
        return self.maps.held((self.device,))

    def term_span(self, term_id: int) -> Tuple[int, int, int]:
        """(offset, length, bucket) for a term's posting slice."""
        o = int(self.postings.offsets[term_id])
        n = int(self.postings.lengths[term_id])
        return o, n, bucket_of(max(1, n))

    def refresh(self, built: BuiltIndex) -> None:
        """Re-upload after a host-side mutation, on the same device; the
        pools and the phrase-tf cache start empty."""
        self.__init__(built, self.device)


def _doc_term_from_postings(postings: TermPostings,
                            num_docs: int) -> DocTermMatrix:
    """Doc -> term CSR derived from the term-major postings."""
    tid = np.repeat(np.arange(postings.num_terms, dtype=np.int64),
                    postings.lengths)
    docs = enc.keys_of(postings.data).astype(np.int64)
    order = np.lexsort((tid, docs))
    docs, tid = docs[order], tid[order]
    keep = np.ones(len(docs), dtype=bool)
    keep[1:] = (docs[1:] != docs[:-1]) | (tid[1:] != tid[:-1])
    rows = np.zeros(num_docs + 1, dtype=np.int64)
    np.add.at(rows, docs[keep] + 1, 1)
    return DocTermMatrix(tid[keep].astype(np.uint32), np.cumsum(rows))


def from_numpy_state(arrays: dict, device) -> DeviceIndex:
    """Build the port's BuiltIndex and DeviceIndex from numpy arrays and
    Python lists only -- e.g. an index built by the JAX package, so both
    packages score the same postings.

    ``arrays`` holds ``data`` (uint64 posting words), ``offsets``,
    ``lengths``, ``doc_lens``, ``doc_freqs``, ``avg_doc_length`` and
    ``terms`` (vocabulary in id order); optionally ``doc_term_cols`` /
    ``doc_term_rows`` (derived from the postings when absent) and
    ``derived`` (the dict of :func:`derive_attach_arrays`).  The built
    index is ``DeviceIndex.built``."""
    postings = TermPostings(
        np.ascontiguousarray(arrays["data"], dtype=np.uint64),
        np.asarray(arrays["offsets"], dtype=np.int64),
        np.asarray(arrays["lengths"], dtype=np.int64))
    doc_lens = np.asarray(arrays["doc_lens"], dtype=np.float32)
    vocab = Vocabulary()
    terms: Sequence = arrays["terms"]
    for t in terms:
        vocab.add_term(t)
    if len(vocab) != len(terms):
        raise ValueError("vocabulary terms are not unique")
    if "doc_term_cols" in arrays:
        doc_term = DocTermMatrix(np.asarray(arrays["doc_term_cols"]),
                                 np.asarray(arrays["doc_term_rows"]))
    else:
        doc_term = _doc_term_from_postings(postings, len(doc_lens))
    built = BuiltIndex(
        postings=postings, doc_term=doc_term, vocab=vocab, doc_lens=doc_lens,
        avg_doc_length=float(arrays["avg_doc_length"]),
        doc_freqs=np.asarray(arrays["doc_freqs"], dtype=np.int64),
        derived=arrays.get("derived"))
    return DeviceIndex(built, device)
