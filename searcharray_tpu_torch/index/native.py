"""ctypes binding for the native (C++) index-build runtime.

The same runtime as the JAX package's (`native/indexer.cpp`), compiled on
first use with g++ into ``build/searcharray_tpu_torch/`` beside the
package, keyed by a hash of the source.  Falls back to the numpy builder
path if no compiler is present; that fallback is host code and hides no
device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
# Repo layout first; pip-installed packages carry the source as package
# data (_native_src/, copied there by setup.py's build_py hook).
_SRC_CANDIDATES = (
    os.path.join(_REPO_ROOT, "native", "indexer.cpp"),
    os.path.join(_PKG_DIR, "_native_src", "indexer.cpp"),
)
_SRC = next((p for p in _SRC_CANDIDATES if os.path.exists(p)),
            _SRC_CANDIDATES[0])
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "searcharray_tpu_torch")

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def _so_path() -> str:
    """Shared-object path keyed on a hash of the source, so a stale or
    foreign .so is never loaded (it is compiled with -march=native and
    never committed)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsearcharray_native-{digest}.so")


def _build_so(so: str) -> bool:
    """Compile into a temp file and rename it into place, so concurrent
    first users (test workers) never load a half-written library."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError:
        return False
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        os.unlink(tmp)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_SRC):
            _lib_failed = True
            return None
        so = _so_path()
        if not os.path.exists(so) and not _build_so(so):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _lib_failed = True
            return None
        lib.sa_tokenize_corpus.restype = ctypes.c_void_p
        lib.sa_tokenize_corpus.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        for name in ("sa_corpus_num_tokens", "sa_corpus_num_terms",
                     "sa_corpus_vocab_bytes"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.sa_corpus_export.restype = None
        lib.sa_corpus_export.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64),
        ]
        lib.sa_corpus_free.restype = None
        lib.sa_corpus_free.argtypes = [ctypes.c_void_p]
        lib.sa_sort_by_term.restype = None
        lib.sa_sort_by_term.argtypes = [
            np.ctypeslib.ndpointer(np.int32),
            ctypes.c_int64,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64),
        ]
        lib.sa_invert_encode.restype = None
        lib.sa_invert_encode.argtypes = [
            np.ctypeslib.ndpointer(np.int32),   # term_ids
            ctypes.c_int64,                     # n
            np.ctypeslib.ndpointer(np.int32),   # doc_lens
            ctypes.c_int64,                     # n_docs
            ctypes.c_int64,                     # start_doc
            ctypes.c_int32,                     # num_terms
            np.ctypeslib.ndpointer(np.uint64),  # words_out
            np.ctypeslib.ndpointer(np.int32),   # present_out
            np.ctypeslib.ndpointer(np.int64),   # bounds_out
            np.ctypeslib.ndpointer(np.uint32),  # dt_cols_out
            np.ctypeslib.ndpointer(np.int64),   # dt_rows_out
            np.ctypeslib.ndpointer(np.int64),   # sizes_out
        ]
        lib.sa_copy_segments.restype = None
        lib.sa_copy_segments.argtypes = [
            np.ctypeslib.ndpointer(np.int64),   # bufs (addresses)
            np.ctypeslib.ndpointer(np.int32),   # seg_buf
            np.ctypeslib.ndpointer(np.int64),   # starts
            np.ctypeslib.ndpointer(np.int64),   # lens
            ctypes.c_int64,                     # n_segs
            np.ctypeslib.ndpointer(np.uint64),  # out
        ]
        lib.sa_compress_planes.restype = ctypes.c_int64
        lib.sa_compress_planes.argtypes = [
            np.ctypeslib.ndpointer(np.uint64),  # words
            ctypes.c_int64,                     # n
            ctypes.c_int32,                     # blk_bits
            np.ctypeslib.ndpointer(np.int32),   # hdr_out
            np.ctypeslib.ndpointer(np.uint32),  # pay_out
        ]
        lib.sa_block_max.restype = None
        lib.sa_block_max.argtypes = [
            np.ctypeslib.ndpointer(np.uint64),  # words
            np.ctypeslib.ndpointer(np.int64),   # offsets
            np.ctypeslib.ndpointer(np.int64),   # lengths
            ctypes.c_int64,                     # num_terms
            ctypes.c_int32,                     # doc_block
            np.ctypeslib.ndpointer(np.int64),   # out
        ]
        lib.sa_doc_freqs.restype = None
        lib.sa_doc_freqs.argtypes = [
            np.ctypeslib.ndpointer(np.uint64),  # words
            np.ctypeslib.ndpointer(np.int64),   # offsets
            np.ctypeslib.ndpointer(np.int64),   # lengths
            ctypes.c_int64,                     # num_terms
            np.ctypeslib.ndpointer(np.int64),   # df_out
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def tokenize_corpus(
    docs: List[str],
    lowercase: bool = False,
    strip_punct: bool = False,
    max_posn: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray, List[str]]]:
    """Tokenize docs natively -> (term_ids int32, doc_lens int32, vocab).

    Term ids are first-occurrence ordered (TermDict parity).  Returns None
    when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    encoded = [d.encode("utf-8") if isinstance(d, str) else b"" for d in docs]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    buf = b"".join(encoded)
    handle = lib.sa_tokenize_corpus(
        buf,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(encoded),
        1 if lowercase else 0,
        1 if strip_punct else 0,
        max_posn,
    )
    try:
        n_tok = lib.sa_corpus_num_tokens(handle)
        n_terms = lib.sa_corpus_num_terms(handle)
        n_vbytes = lib.sa_corpus_vocab_bytes(handle)
        term_ids = np.empty(n_tok, dtype=np.int32)
        doc_lens = np.empty(len(encoded), dtype=np.int32)
        vocab_chars = ctypes.create_string_buffer(max(1, n_vbytes))
        vocab_offsets = np.empty(n_terms + 1, dtype=np.int64)
        lib.sa_corpus_export(handle, term_ids, doc_lens, vocab_chars,
                             vocab_offsets)
    finally:
        lib.sa_corpus_free(handle)
    raw = vocab_chars.raw[:n_vbytes]
    vocab = [
        raw[vocab_offsets[i]: vocab_offsets[i + 1]].decode("utf-8")
        for i in range(n_terms)
    ]
    return term_ids, doc_lens, vocab


def sort_by_term(term_ids: np.ndarray, num_terms: int) -> Optional[np.ndarray]:
    """Stable grouping permutation by term id, O(n + V) counting sort."""
    lib = get_lib()
    if lib is None:
        return None
    term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
    perm = np.empty(len(term_ids), dtype=np.int64)
    lib.sa_sort_by_term(term_ids, len(term_ids), num_terms, perm)
    return perm


def invert_encode(term_ids: np.ndarray, doc_lens: np.ndarray,
                  start_doc: int, num_terms: int):
    """Fused inversion + roaringish encode for one batch (C++, O(n)).

    Returns (words u64[W], present int32[P], bounds int64[P+1],
    dt_cols u32[PAIRS], dt_rows int64[D+1]) or None without the library.
    The GIL is released during the call, so worker threads overlap.
    """
    lib = get_lib()
    if lib is None:
        return None
    term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
    doc_lens = np.ascontiguousarray(doc_lens, dtype=np.int32)
    n = len(term_ids)
    words = np.empty(n, dtype=np.uint64)
    present = np.empty(min(n, num_terms), dtype=np.int32)
    bounds = np.empty(min(n, num_terms) + 1, dtype=np.int64)
    dt_cols = np.empty(n, dtype=np.uint32)
    dt_rows = np.empty(len(doc_lens) + 1, dtype=np.int64)
    sizes = np.zeros(3, dtype=np.int64)
    lib.sa_invert_encode(term_ids, n, doc_lens, len(doc_lens),
                         int(start_doc), num_terms, words, present, bounds,
                         dt_cols, dt_rows, sizes)
    w, p, pairs = int(sizes[0]), int(sizes[1]), int(sizes[2])
    return (words[:w].copy(), present[:p].copy(), bounds[: p + 1].copy(),
            dt_cols[:pairs].copy(), dt_rows)


def copy_segments(buffers: List[np.ndarray], seg_buf: np.ndarray,
                  starts: np.ndarray, lens: np.ndarray) -> Optional[np.ndarray]:
    """Gather word segments from per-batch buffers into one contiguous
    uint64 buffer (memcpy per segment, no giant index arrays).

    ``seg_buf[s]`` names the source buffer; ``starts/lens`` are word
    ranges within it.  Returns None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    buffers = [np.ascontiguousarray(b, dtype=np.uint64) for b in buffers]
    addrs = np.asarray([b.ctypes.data for b in buffers], dtype=np.int64)
    seg_buf = np.ascontiguousarray(seg_buf, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(int(lens.sum()), dtype=np.uint64)
    lib.sa_copy_segments(addrs, seg_buf, starts, lens, len(starts), out)
    return out


def compress_planes(words: np.ndarray, blk_bits: int):
    """One-pass u64 words -> (hdr32, pay32, max_hdr), or None."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    hdr = np.empty(len(words), dtype=np.int32)
    pay = np.empty(len(words), dtype=np.uint32)
    max_hdr = lib.sa_compress_planes(words, len(words), int(blk_bits),
                                     hdr, pay)
    return hdr, pay, int(max_hdr)


def block_max(words: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              doc_block: int) -> Optional[np.ndarray]:
    """Per-term max words in any doc_block-sized doc range, one C++ pass."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty(len(offsets), dtype=np.int64)
    lib.sa_block_max(words, offsets, lengths, len(offsets),
                     int(doc_block), out)
    return out


def doc_freqs(words: np.ndarray, offsets: np.ndarray,
              lengths: np.ndarray) -> Optional[np.ndarray]:
    """Per-term docfreq: one C++ pass counting doc-key changes per slice."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty(len(offsets), dtype=np.int64)
    lib.sa_doc_freqs(words, offsets, lengths, len(offsets), out)
    return out
