"""Index construction: tokenized docs -> CSR posting store + doc/term matrix.

Pipeline (one batch):
  tokenizer (pluggable Python callable, per reference README contract)
    -> flat (term_id, doc_id, posn) columns            [pandas factorize, C speed]
    -> stable sort by term id (doc/posn order kept)    [replaces indexing.py:102-115]
    -> segmented bitwise-OR pack into posting words    [replaces roaringish.py:93-142]

Batches are packed independently and repacked into one contiguous
term-major buffer at the end (vectorised segment gather, no per-term loop) —
this replaces the reference's ArrayDict.concat
(`searcharray/phrase/memmap_arrays.py:55`).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import logging

import numpy as np
import pandas as pd

from searcharray_tpu_torch.ops import encoding as enc
from searcharray_tpu_torch.index.vocab import Vocabulary

# INFO-level build progress, reference parity (indexing.py:14-20,86-87):
# long builds must not be silent.  Handlers/levels are left to the host
# application; `SEARCHARRAY_TPU_LOG=1` installs a stderr handler.
logger = logging.getLogger("searcharray_tpu_torch.index")
import os as _os

if _os.environ.get("SEARCHARRAY_TPU_LOG") == "1":  # pragma: no cover
    logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)


def ws_tokenizer(string):
    """Default whitespace tokenizer (parity: postings.py:206-211)."""
    if pd.isna(string):
        return []
    if not isinstance(string, str):
        raise ValueError("Expected a string")
    return string.split()


# Tokenizers carrying a native spec run in the C++ runtime during batch
# indexing (native/indexer.cpp); spec = (lowercase, strip_punct).
ws_tokenizer._native_spec = (False, False)


def std_tokenizer(string):
    """Lowercasing, punctuation-stripping tokenizer (native-accelerated)."""
    if pd.isna(string):
        return []
    import re

    return re.sub(r"[!-/:-@\[-`{-~]", " ", string).lower().split()


std_tokenizer._native_spec = (True, True)


def _concat_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Indices [s0..s0+l0) ++ [s1..s1+l1) ++ ... without a Python loop."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    rep = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return np.arange(total, dtype=np.int64) + rep


class TermPostings:
    """CSR store: one contiguous uint64 posting buffer + per-term slices."""

    def __init__(self, data: np.ndarray, offsets: np.ndarray, lengths: np.ndarray):
        self.data = data            # uint64[W]
        self.offsets = offsets      # int64[V]
        self.lengths = lengths      # int64[V]

    @classmethod
    def empty(cls) -> "TermPostings":
        return cls(
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.int64),
        )

    def term_slice(self, term_id: int) -> np.ndarray:
        if term_id >= len(self.offsets):
            return np.empty(0, dtype=np.uint64)
        o, l = self.offsets[term_id], self.lengths[term_id]
        return self.data[o : o + l]

    def ensure_terms(self, num_terms: int) -> None:
        if num_terms > len(self.offsets):
            pad = num_terms - len(self.offsets)
            self.offsets = np.concatenate(
                [self.offsets, np.zeros(pad, dtype=np.int64)]
            )
            self.lengths = np.concatenate(
                [self.lengths, np.zeros(pad, dtype=np.int64)]
            )

    @property
    def num_terms(self) -> int:
        return len(self.offsets)

    @property
    def nbytes(self) -> int:
        return self.data.nbytes + self.offsets.nbytes + self.lengths.nbytes

    # Memmapped buffers pickle as just their path and re-open on load
    # (parity: memmap_arrays.py:197-208).
    def __getstate__(self):
        state = {
            "offsets": self.offsets,
            "lengths": self.lengths,
            "mmap_path": getattr(self, "mmap_path", None),
        }
        if state["mmap_path"] is None:
            state["data"] = np.asarray(self.data)
        return state

    def __setstate__(self, state):
        self.offsets = state["offsets"]
        self.lengths = state["lengths"]
        path = state.get("mmap_path")
        if path is not None:
            self.data = np.memmap(path, dtype=np.uint64, mode="r")
            self.mmap_path = path
        else:
            self.data = state["data"]


class DocTermMatrix:
    """CSR binary matrix of which terms appear in which doc (row-major).

    Functional analog of the reference's SparseMatSet
    (`searcharray/utils/mat_set.py:43`).
    """

    def __init__(self, cols: np.ndarray, rows: np.ndarray):
        self.cols = cols.astype(np.uint32, copy=False)   # term ids
        self.rows = rows.astype(np.int64, copy=False)    # offsets, len N+1
        assert self.rows[-1] == len(self.cols)

    @classmethod
    def empty(cls) -> "DocTermMatrix":
        return cls(np.empty(0, dtype=np.uint32), np.zeros(1, dtype=np.int64))

    def row_terms(self, row: int) -> np.ndarray:
        return self.cols[self.rows[row] : self.rows[row + 1]]

    def gather_rows(self, row_idx: np.ndarray) -> "DocTermMatrix":
        row_idx = np.asarray(row_idx)
        starts = self.rows[:-1][row_idx]
        lens = (self.rows[1:] - self.rows[:-1])[row_idx]
        cols = self.cols[_concat_ranges(starts, lens)]
        rows = np.concatenate([[0], np.cumsum(lens)])
        return DocTermMatrix(cols, rows)

    def num_terms_per_row(self) -> np.ndarray:
        return np.diff(self.rows)

    def append(self, other: "DocTermMatrix") -> "DocTermMatrix":
        return DocTermMatrix(
            np.concatenate([self.cols, other.cols]),
            np.concatenate([self.rows, self.rows[-1] + other.rows[1:]]),
        )

    def __len__(self) -> int:
        return len(self.rows) - 1

    @property
    def nbytes(self) -> int:
        return self.cols.nbytes + self.rows.nbytes


@dataclass
class _BatchResult:
    term_ids: np.ndarray      # sorted unique term ids present, int64[T]
    words: np.ndarray         # uint64, term-major
    bounds: np.ndarray        # int64[T+1] into words
    doc_lens: np.ndarray      # float32 per doc in batch
    dt_cols: np.ndarray       # doc->term CSR cols
    dt_rows: np.ndarray       # doc->term CSR rows


def _tokenize_docs_python(docs, tokenizer, vocab, truncate):
    token_lists = [tokenizer(d) for d in docs]
    lens = np.fromiter((len(t) for t in token_lists), dtype=np.int64,
                       count=len(token_lists))
    if np.any(lens > enc.MAX_POSN):
        if not truncate:
            raise ValueError(f"Document length exceeds maximum of {enc.MAX_POSN}")
        token_lists = [t[: enc.MAX_POSN] for t in token_lists]
        lens = np.minimum(lens, enc.MAX_POSN)
    flat: List = []
    for t in token_lists:
        flat.extend(t)
    if not flat:
        return np.empty(0, dtype=np.int64), lens
    local_ids, uniques = pd.factorize(np.asarray(flat, dtype=object))
    global_of_local = vocab.add_batch(uniques)
    return global_of_local[local_ids], lens


def _tokenize_docs_native(docs, spec, tokenizer, vocab, truncate):
    """C++ tokenizer path (native/indexer.cpp) for spec'd tokenizers.

    The native tokenizer is byte-oriented: its whitespace/case rules are
    exact only for ASCII.  Non-ASCII docs (unicode whitespace like \\xa0,
    accented case folding) are routed through the Python ``tokenizer`` and
    stitched back in doc order, so results never depend on whether the
    native library loaded.
    """
    from searcharray_tpu_torch.index import native as native_mod

    if not native_mod.native_available():
        return None
    lowercase, strip_punct = spec
    clean = [d if isinstance(d, str) and d == d else "" for d in docs]
    na_idx = [i for i, d in enumerate(clean) if not d.isascii()]
    if not na_idx:
        res = native_mod.tokenize_corpus(
            clean, lowercase=lowercase, strip_punct=strip_punct,
            max_posn=enc.MAX_POSN if truncate else 0,
        )
        if res is None:
            return None
        local_ids, lens32, local_vocab = res
        lens = lens32.astype(np.int64)
        if not truncate and np.any(lens > enc.MAX_POSN):
            raise ValueError(
                f"Document length exceeds maximum of {enc.MAX_POSN}")
        if len(local_ids) == 0:
            return np.empty(0, dtype=np.int64), lens
        global_of_local = vocab.add_batch(local_vocab)
        return global_of_local[local_ids], lens

    # Mixed batch: native for the ASCII docs, Python for the rest.
    a_idx = np.asarray(
        [i for i, d in enumerate(clean) if d.isascii()], dtype=np.int64)
    na_idx = np.asarray(na_idx, dtype=np.int64)
    res = _tokenize_docs_native(
        [clean[i] for i in a_idx], spec, tokenizer, vocab, truncate)
    if res is None:
        return None
    ids_a, lens_a = res
    ids_b, lens_b = _tokenize_docs_python(
        [clean[i] for i in na_idx], tokenizer, vocab, truncate)
    lens = np.zeros(len(clean), dtype=np.int64)
    lens[a_idx] = lens_a
    lens[na_idx] = lens_b
    out = np.empty(int(lens.sum()), dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    out[_concat_ranges(starts[a_idx], lens_a)] = ids_a
    out[_concat_ranges(starts[na_idx], lens_b)] = ids_b
    return out, lens


def _tokenize_batch(
    docs: List,
    tokenizer: Callable,
    vocab: Vocabulary,
    start_doc: int,
    truncate: bool,
) -> _BatchResult:
    spec = getattr(tokenizer, "_native_spec", None)
    result = None
    if spec is not None:
        try:
            result = _tokenize_docs_native(docs, spec, tokenizer, vocab,
                                           truncate)
        except UnicodeDecodeError:
            result = None
    if result is None:
        result = _tokenize_docs_python(docs, tokenizer, vocab, truncate)
    term_ids, lens = result
    total = len(term_ids)
    doc_lens = lens.astype(np.float32)

    if total == 0:
        return _BatchResult(
            term_ids=np.empty(0, dtype=np.int64),
            words=np.empty(0, dtype=np.uint64),
            bounds=np.zeros(1, dtype=np.int64),
            doc_lens=doc_lens,
            dt_cols=np.empty(0, dtype=np.uint32),
            dt_rows=np.zeros(len(docs) + 1, dtype=np.int64),
        )

    # Fused O(n) native inversion + encode when the C++ runtime is up
    # (replaces the repeat/counting-sort/reduceat/lexsort numpy pipeline).
    from searcharray_tpu_torch.index import native as native_mod

    fused = native_mod.invert_encode(term_ids, lens, start_doc, len(vocab))
    if fused is not None:
        words, present, bounds, dt_cols, dt_rows = fused
        return _BatchResult(
            term_ids=present.astype(np.int64),
            words=words,
            bounds=bounds,
            doc_lens=doc_lens,
            dt_cols=dt_cols,
            dt_rows=dt_rows,
        )

    doc_ids = np.repeat(
        np.arange(start_doc, start_doc + len(docs), dtype=np.int64), lens
    )
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    posns = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)

    # Term-major inversion; doc/posn order within a term is preserved.
    # O(n + V) native counting sort when available, else stable argsort.
    order = native_mod.sort_by_term(term_ids, len(vocab))
    if order is None:
        order = np.argsort(term_ids, kind="stable")
    s_terms = term_ids[order]
    s_docs = doc_ids[order]
    s_posns = posns[order]

    term_starts = np.concatenate(
        [[0], np.flatnonzero(s_terms[1:] != s_terms[:-1]) + 1]
    ).astype(np.int64)
    words, bounds = enc.encode_flat(s_docs, s_posns, term_starts)
    present_terms = s_terms[term_starts]

    # doc -> unique terms CSR (doc-major).  Pairs are doc-major already in
    # (doc_ids, term_ids); unique consecutive after sorting term within doc.
    pair_order = np.lexsort((term_ids, doc_ids))
    p_docs = doc_ids[pair_order] - start_doc
    p_terms = term_ids[pair_order]
    keep = np.ones(total, dtype=bool)
    keep[1:] = (p_docs[1:] != p_docs[:-1]) | (p_terms[1:] != p_terms[:-1])
    u_docs = p_docs[keep]
    u_terms = p_terms[keep].astype(np.uint32)
    dt_rows = np.zeros(len(docs) + 1, dtype=np.int64)
    np.add.at(dt_rows, u_docs + 1, 1)
    dt_rows = np.cumsum(dt_rows)

    return _BatchResult(
        term_ids=present_terms,
        words=words,
        bounds=bounds,
        doc_lens=doc_lens,
        dt_cols=u_terms,
        dt_rows=dt_rows,
    )


def _repack(batches: List[_BatchResult], num_terms: int) -> TermPostings:
    """Merge per-batch term-major buffers into one term-major CSR store."""
    if not batches:
        return TermPostings.empty()
    seg_terms: List[np.ndarray] = []
    seg_starts: List[np.ndarray] = []
    seg_lens: List[np.ndarray] = []
    for b in batches:
        seg_terms.append(b.term_ids)
        seg_starts.append(b.bounds[:-1])
        seg_lens.append(np.diff(b.bounds))
    terms = np.concatenate(seg_terms)
    starts = np.concatenate(seg_starts)
    lens = np.concatenate(seg_lens)

    # Order segments by (term, batch) — batch order is doc order, so each
    # term's words stay sorted by doc key.
    batch_ord = np.repeat(
        np.arange(len(batches)), [len(b.term_ids) for b in batches]
    )
    seg_order = np.lexsort((batch_ord, terms))

    from searcharray_tpu_torch.index import native as native_mod

    data = native_mod.copy_segments(
        [b.words for b in batches], batch_ord[seg_order],
        starts[seg_order], lens[seg_order])
    if data is None:
        # numpy fallback: index segments within one concatenated buffer
        batch_base = np.zeros(len(batches), dtype=np.int64)
        np.cumsum([len(b.words) for b in batches][:-1], out=batch_base[1:])
        all_words = np.concatenate([b.words for b in batches])
        g_starts = starts + batch_base[batch_ord]
        gather = _concat_ranges(g_starts[seg_order], lens[seg_order])
        data = all_words[gather]

    offsets = np.zeros(num_terms, dtype=np.int64)
    lengths = np.zeros(num_terms, dtype=np.int64)
    o_terms = terms[seg_order]
    o_lens = lens[seg_order]
    np.add.at(lengths, o_terms, o_lens)
    offsets[1:] = np.cumsum(lengths)[:-1]
    return TermPostings(data, offsets, lengths)


def compute_doc_freqs(postings: TermPostings) -> np.ndarray:
    """Per-term document frequency, one vectorised pass over the CSR buffer.

    Precomputing df at build time removes every per-query device->host
    docfreq sync (the reference computes+caches it lazily per term,
    `middle_out.py:521-528`)."""
    V = postings.num_terms
    W = len(postings.data)
    if W == 0:
        return np.zeros(V, dtype=np.int64)

    from searcharray_tpu_torch.index import native as native_mod

    dfs = native_mod.doc_freqs(postings.data, postings.offsets,
                               postings.lengths)
    if dfs is not None:
        return dfs
    keys = enc.keys_of(postings.data)
    newdoc = np.ones(W, dtype=bool)
    newdoc[1:] = keys[1:] != keys[:-1]
    newdoc[postings.offsets[postings.lengths > 0]] = True
    tid_of_word = np.repeat(np.arange(V, dtype=np.int64), postings.lengths)
    return np.bincount(tid_of_word[newdoc], minlength=V).astype(np.int64)


@dataclass
class BuiltIndex:
    postings: TermPostings
    doc_term: DocTermMatrix
    vocab: Vocabulary
    doc_lens: np.ndarray          # float32[N]
    avg_doc_length: float
    doc_freqs: Optional[np.ndarray] = None   # int64[V]
    # Precomputed device-attach arrays (index/device.py:
    # derive_attach_arrays, or a v3 store's, index/store.py): {"hdr32",
    # "pay32" (tail-padded), "blk_bits", "max_bucket"}; DeviceIndex
    # ignores the store's "block_word_max" and "doc_block".  Lets
    # DeviceIndex skip its multi-GB numpy derivation passes.
    derived: Optional[dict] = None

    def __post_init__(self):
        if self.doc_freqs is None:
            self.doc_freqs = compute_doc_freqs(self.postings)

    def __getstate__(self):
        # derived arrays are memmap-backed store artifacts: pickling would
        # copy gigabytes; they re-derive (or re-load) on the other side
        d = dict(self.__dict__)
        d["derived"] = None
        return d

    @property
    def corpus_size(self) -> int:
        return len(self.doc_lens)


def _batched(iterable: Iterable, batch_size: int):
    from itertools import islice

    it = iter(iterable)
    start = 0
    while True:
        batch = list(islice(it, batch_size))
        if not batch:
            return
        yield start, batch
        start += len(batch)


def build_index(
    array: Iterable,
    tokenizer: Callable = ws_tokenizer,
    truncate: bool = False,
    batch_size: int = 100_000,
    workers: int = 4,
) -> BuiltIndex:
    """Tokenize and index a corpus of strings.

    Thread workers overlap Python tokenisation (GIL released inside numpy /
    factorize) like the reference's pool (`indexing.py:253-280`).  The
    effective pool is capped at the host's core count: on a 1-core host
    extra threads only add contention (measured: workers=4 was 2.5x
    slower than workers=1 at 1M docs once the native repack landed).
    """
    import time as _time

    workers = min(workers or 1, _os.cpu_count() or 1)

    vocab = Vocabulary()
    results: List[_BatchResult] = []
    t0 = _time.perf_counter()
    done_docs = 0
    done_tokens = 0

    def _log_batch(res: _BatchResult) -> None:
        nonlocal done_docs, done_tokens
        done_docs += len(res.doc_lens)
        done_tokens += int(res.doc_lens.sum())
        dt = _time.perf_counter() - t0
        logger.info(
            "Indexed %d docs (%d tokens, %d terms, %.0f docs/s, %.1f MB "
            "postings this batch)", done_docs, done_tokens, len(vocab),
            done_docs / max(dt, 1e-9), res.words.nbytes / 1e6,
        )

    if workers and workers > 1:
        from concurrent.futures import as_completed

        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [
                pool.submit(_tokenize_batch, batch, tokenizer, vocab, start, truncate)
                for start, batch in _batched(array, batch_size)
            ]
            for f in as_completed(futures):
                _log_batch(f.result())
            results = [f.result() for f in futures]
    else:
        results = []
        for start, batch in _batched(array, batch_size):
            res = _tokenize_batch(batch, tokenizer, vocab, start, truncate)
            _log_batch(res)
            results.append(res)

    if not results:
        return BuiltIndex(
            postings=TermPostings.empty(),
            doc_term=DocTermMatrix.empty(),
            vocab=vocab,
            doc_lens=np.empty(0, dtype=np.float32),
            avg_doc_length=0.0,
        )

    postings = _repack(results, len(vocab))
    doc_lens = np.concatenate([b.doc_lens for b in results])
    dt_cols = np.concatenate([b.dt_cols for b in results])
    row_parts = [np.zeros(1, dtype=np.int64)]
    base = 0
    for b in results:
        row_parts.append(b.dt_rows[1:] + base)
        base += b.dt_rows[-1]
    dt_rows = np.concatenate(row_parts)
    doc_term = DocTermMatrix(dt_cols, dt_rows)

    avg_dl = float(np.mean(doc_lens)) if len(doc_lens) else 0.0
    return BuiltIndex(
        postings=postings,
        doc_term=doc_term,
        vocab=vocab,
        doc_lens=doc_lens,
        avg_doc_length=avg_dl,
    )


def merge_built(parts: List[BuiltIndex]) -> BuiltIndex:
    """Concatenate indexes along the doc axis, vectorised.

    Vocabularies are unioned (term ids of later parts remapped), doc keys
    of later parts are rebased, and per-term posting runs are re-gathered
    into one term-major CSR — no per-row Terms materialisation (the
    reference's concat path, `postings.py:547-549`, re-tokenizes rows).
    """
    if len(parts) == 1:
        return parts[0]
    vocab = parts[0].vocab.copy()
    batches: List[_BatchResult] = []
    doc_base = 0
    for part in parts:
        post = part.postings
        present = np.flatnonzero(post.lengths > 0)
        if len(part.vocab) == len(vocab) and part.vocab.compatible(vocab):
            tmap = None
            term_ids = present.astype(np.int64)
        else:
            tmap = vocab.add_batch(
                [part.vocab.get_term(i) for i in range(len(part.vocab))]
            )
            term_ids = tmap[present]
        words = post.data + (np.uint64(doc_base) << np.uint64(enc.KEY_SHIFT))
        bounds = np.concatenate(
            [post.offsets[present], [len(post.data)]]
        ).astype(np.int64)
        # term ids must be ascending within a batch for the repack's
        # segment sort; remapping preserves order only for compatible
        # vocabs, so sort the segments otherwise
        if tmap is not None and not np.all(np.diff(term_ids) > 0):
            order = np.argsort(term_ids, kind="stable")
            starts = bounds[:-1][order]
            lens = np.diff(bounds)[order]
            words = words[_concat_ranges(starts, lens)]
            term_ids = term_ids[order]
            bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        dt_cols = (
            part.doc_term.cols if tmap is None
            else tmap[part.doc_term.cols].astype(np.uint32)
        )
        batches.append(
            _BatchResult(
                term_ids=term_ids,
                words=words,
                bounds=bounds,
                doc_lens=part.doc_lens,
                dt_cols=dt_cols,
                dt_rows=part.doc_term.rows,
            )
        )
        doc_base += part.corpus_size

    postings = _repack(batches, len(vocab))
    doc_lens = np.concatenate([b.doc_lens for b in batches])
    dt_cols = np.concatenate([b.dt_cols for b in batches])
    row_parts = [np.zeros(1, dtype=np.int64)]
    base = 0
    for b in batches:
        row_parts.append(b.dt_rows[1:] + base)
        base += b.dt_rows[-1]
    doc_term = DocTermMatrix(dt_cols, np.concatenate(row_parts))
    avg_dl = float(np.mean(doc_lens)) if len(doc_lens) else 0.0
    return BuiltIndex(
        postings=postings,
        doc_term=doc_term,
        vocab=vocab,
        doc_lens=doc_lens,
        avg_doc_length=avg_dl,
    )


def replace_docs(built: BuiltIndex, doc_ids: np.ndarray, rows: List,
                 terms_cls) -> BuiltIndex:
    """Rebuild only the mutated docs: delta-index ``rows`` and splice them
    into ``built``'s CSR stores with vectorised passes (no per-row Terms
    materialisation of the untouched corpus).

    ``doc_ids[i]`` is the backing corpus row that ``rows[i]`` replaces; ids
    ``>= built.corpus_size`` append new docs (the de-aliased ``__setitem__``
    case).  Duplicate ids keep the LAST assignment, matching sequential
    in-place semantics.  The reference's ``__setitem__``
    (``searcharray/postings.py:360-425``) mutates its term matrix and
    position bit-arrays row by row; here the index is an immutable CSR, so
    mutation is a delta build + O(total words) splice instead of an
    O(corpus) decode and rebuild.  Host numpy only (the JAX package's
    ``index/builder.py:625``).
    """
    doc_ids = np.asarray(doc_ids, dtype=np.int64)
    if len(doc_ids) != len(rows):
        raise ValueError("doc_ids and rows must align")
    if len(doc_ids) == 0:
        return built
    # duplicates: keep the last assignment per doc
    _, last = np.unique(doc_ids[::-1], return_index=True)
    keep_i = np.sort(len(doc_ids) - 1 - last)
    doc_ids = doc_ids[keep_i]
    rows = [rows[i] for i in keep_i]

    mini = build_index_from_terms(np.asarray(rows, dtype=object), terms_cls)
    vocab = built.vocab.copy()
    tmap = vocab.add_batch(
        [mini.vocab.get_term(i) for i in range(len(mini.vocab))]
    ) if len(mini.vocab) else np.empty(0, np.int64)
    V2 = len(vocab)
    N = built.corpus_size
    N2 = max(N, int(doc_ids.max()) + 1)

    # --- postings: only terms touched by the mutation change; runs of
    # untouched terms copy wholesale as contiguous slices (a global
    # re-sort or permutation gather of the full buffer takes seconds at
    # 6M words; the run splice is a memcpy) ---
    old = built.postings
    old_data = np.asarray(old.data)
    dt = built.doc_term
    live = doc_ids[doc_ids < N]
    # replaced docs as a mask over the doc axis: one lookup a word (the
    # JAX package's np.isin sorts every affected slice)
    replaced = np.zeros(N, dtype=bool)
    replaced[live] = True
    aff = np.zeros(V2, dtype=bool)
    for d in live:
        aff[dt.row_terms(int(d)).astype(np.int64)] = True
    if len(tmap):
        aff[tmap] = True
    aff_t = np.flatnonzero(aff)
    # global tid -> mini tid (or -1)
    inv_t = np.full(V2, -1, dtype=np.int64)
    if len(tmap):
        inv_t[tmap] = np.arange(len(tmap), dtype=np.int64)
    low_mask = np.uint64((1 << enc.KEY_SHIFT) - 1)
    key_shift = np.uint64(enc.KEY_SHIFT)
    mp = mini.postings
    md = np.asarray(mp.data)
    merged: dict = {}
    for t in aff_t:
        t = int(t)
        if t < old.num_terms and old.lengths[t]:
            sl = old_data[old.offsets[t]: old.offsets[t] + old.lengths[t]]
            sl = sl[~replaced[enc.keys_of(sl).astype(np.int64)]]
        else:
            sl = np.empty(0, np.uint64)
        mt = inv_t[t]
        if mt >= 0 and mp.lengths[mt]:
            dw = md[mp.offsets[mt]: mp.offsets[mt] + mp.lengths[mt]]
            # remap the delta's local doc keys (0..m-1) to the real ids;
            # the low 36 bits (block | payload) pass through untouched
            real = doc_ids[enc.keys_of(dw).astype(np.int64)].astype(
                np.uint64)
            dw = (real << key_shift) | (dw & low_mask)
            # one word per (doc, block) and the replaced docs' words were
            # dropped above, so a plain sort restores (doc, block) order
            sl = np.sort(np.concatenate([sl, dw]))
        merged[t] = sl
    lengths2 = np.zeros(V2, dtype=np.int64)
    lengths2[: old.num_terms] = old.lengths
    for t, sl in merged.items():
        lengths2[t] = len(sl)
    offsets2 = np.zeros(V2, dtype=np.int64)
    np.cumsum(lengths2[:-1], out=offsets2[1:])
    data2 = np.empty(int(lengths2.sum()), dtype=np.uint64)
    prev = 0  # first untouched old term of the pending run
    for t in list(aff_t) + [old.num_terms]:
        t = int(t)
        if t > prev and prev < old.num_terms:  # copy the untouched run
            lo = old.offsets[prev]
            hi = (old.offsets[t] if t < old.num_terms
                  else lo + int(old.lengths[prev: t].sum()))
            data2[offsets2[prev]: offsets2[prev] + (hi - lo)] = \
                old_data[lo:hi]
        if t < old.num_terms or t in merged:
            if t in merged:
                data2[offsets2[t]: offsets2[t] + lengths2[t]] = merged[t]
        prev = t + 1
    postings2 = TermPostings(data2, offsets2, lengths2)

    # --- doc_term: same run splice along the doc axis ---
    old_lens = np.diff(dt.rows)
    lens2 = np.zeros(N2, dtype=np.int64)
    lens2[:N] = old_lens
    mini_lens = np.diff(mini.doc_term.rows)
    lens2[doc_ids] = mini_lens
    rows2 = np.concatenate([[0], np.cumsum(lens2)]).astype(np.int64)
    cols2 = np.empty(int(rows2[-1]), dtype=np.uint32)
    mini_cols_g = tmap[mini.doc_term.cols.astype(np.int64)].astype(
        np.uint32) if len(mini.doc_term.cols) else mini.doc_term.cols
    order_d = np.argsort(doc_ids, kind="stable")
    prev = 0
    for j in order_d:
        d = int(doc_ids[j])
        if d > prev and prev < N:  # copy the untouched doc run
            lo, hi = dt.rows[prev], dt.rows[min(d, N)]
            cols2[rows2[prev]: rows2[prev] + (hi - lo)] = dt.cols[lo:hi]
        mr = mini.doc_term.rows
        cols2[rows2[d]: rows2[d + 1]] = mini_cols_g[mr[j]: mr[j + 1]]
        prev = d + 1
    if prev < N:
        lo, hi = dt.rows[prev], dt.rows[N]
        cols2[rows2[prev]: rows2[prev] + (hi - lo)] = dt.cols[lo:hi]
    doc_term2 = DocTermMatrix(cols2, rows2)

    doc_lens2 = np.zeros(N2, dtype=np.float32)
    doc_lens2[:N] = built.doc_lens
    doc_lens2[doc_ids] = mini.doc_lens
    avg_dl = float(np.mean(doc_lens2)) if N2 else 0.0
    return BuiltIndex(
        postings=postings2,
        doc_term=doc_term2,
        vocab=vocab,
        doc_lens=doc_lens2,
        avg_doc_length=avg_dl,
    )


def build_index_from_terms(rows: Iterable, terms_cls) -> BuiltIndex:
    """Build from already-tokenised Terms/dict rows (parity: indexing.py:298)."""
    vocab = Vocabulary()
    dt_cols: List[int] = []
    dt_rows = [0]
    doc_lens: List[float] = []
    tri_terms: List[np.ndarray] = []
    tri_docs: List[np.ndarray] = []
    tri_posns: List[np.ndarray] = []

    for doc_id, row in enumerate(rows):
        if isinstance(row, dict):
            row = terms_cls(row, doc_len=len(row))
        elif not isinstance(row, terms_cls):
            raise TypeError("Expected a Terms or a dict")
        doc_lens.append(row.doc_len)
        for token, _tf in row.terms():
            tid = vocab.add_term(token)
            dt_cols.append(tid)
            posns = row.positions(token) if row.posns is not None else None
            if posns is not None and len(posns) > 0:
                p = np.asarray(posns, dtype=np.int64)
                tri_terms.append(np.full(len(p), tid, dtype=np.int64))
                tri_docs.append(np.full(len(p), doc_id, dtype=np.int64))
                tri_posns.append(p)
        dt_rows.append(len(dt_cols))

    num_docs = len(doc_lens)
    if tri_terms:
        t = np.concatenate(tri_terms)
        d = np.concatenate(tri_docs)
        p = np.concatenate(tri_posns)
        order = np.lexsort((p, d, t))
        t, d, p = t[order], d[order], p[order]
        term_starts = np.concatenate(
            [[0], np.flatnonzero(t[1:] != t[:-1]) + 1]
        ).astype(np.int64)
        words, bounds = enc.encode_flat(d, p, term_starts)
        present = t[term_starts]
        offsets = np.zeros(len(vocab), dtype=np.int64)
        lengths = np.zeros(len(vocab), dtype=np.int64)
        lengths[present] = np.diff(bounds)
        # words already grouped by term in term-id order
        offsets[present] = bounds[:-1]
        postings = TermPostings(words, offsets, lengths)
    else:
        postings = TermPostings(
            np.empty(0, dtype=np.uint64),
            np.zeros(len(vocab), dtype=np.int64),
            np.zeros(len(vocab), dtype=np.int64),
        )

    doc_lens_arr = np.asarray(doc_lens, dtype=np.float32)
    avg_dl = float(np.mean(doc_lens_arr)) if num_docs else 0.0
    return BuiltIndex(
        postings=postings,
        doc_term=DocTermMatrix(
            np.asarray(dt_cols, dtype=np.uint32),
            np.asarray(dt_rows, dtype=np.int64),
        ),
        vocab=vocab,
        doc_lens=doc_lens_arr,
        avg_doc_length=avg_dl,
    )
