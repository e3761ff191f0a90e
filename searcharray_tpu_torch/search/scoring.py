"""Single-term stats, idf, and one term's scores on its posting slice.

Every term tf vector is produced by K1 (ops/cuda/score.py:score_term):
on a CUDA index the hand-written kernel, on a CPU index its plain
version -- the tensor's device decides, nothing else.  Docfreqs are
precomputed on the host at build (builder.compute_doc_freqs), so idf needs
no device sync: every idf the program uses is read from a per-term table
(``idf_table``), bit-equal to ``host_idf``'s definition.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from searcharray_tpu_torch.index.device import DeviceIndex
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kernels_cuda
from searcharray_tpu_torch.ops.encoding import LSB_BITS
from searcharray_tpu_torch.ops.kernels import apply_similarity_device


# ---------------------------------------------------------------------------
# similarity fusion
# ---------------------------------------------------------------------------
def host_idf(kind, dfs, num_docs, avgdl) -> np.float32:
    """Query-level idf scalar, float64 accumulate then float32 narrow
    (parity: similarity.py:19-21 + bm25.pyx C-float cast).  The definition
    that ``table_idf`` / ``table_idfs`` are held to; the program reads its
    idfs from those."""
    dfs64 = np.asarray(dfs, dtype=np.float64)
    if kind in ("bm25", "bm25_legacy"):
        return np.float32(np.sum(np.log1p((num_docs - dfs64 + 0.5) / (dfs64 + 0.5))))
    if kind == "classic":
        sum_dfs = np.sum(dfs64, axis=0)
        return np.float32(np.log((num_docs + 1) / (sum_dfs + 1)) + 1.0)
    return np.float32(0.0)


def idf_terms(kind, doc_freqs, num_docs) -> np.ndarray:
    """float64 [V]: each term's part of ``host_idf``'s sum, by the same
    float64 operations on every term at once: ``log1p((N - df + 0.5) /
    (df + 0.5))`` for bm25 and bm25_legacy, ``df`` for classic, 0 for a
    kind without an idf.  ``table_idf`` and ``table_idfs`` read a query's
    idf from it, bit-equal to ``host_idf``'s."""
    dfs64 = np.asarray(doc_freqs, dtype=np.float64)
    if kind in ("bm25", "bm25_legacy"):
        return np.log1p((num_docs - dfs64 + 0.5) / (dfs64 + 0.5))
    if kind == "classic":
        return dfs64
    return np.zeros(len(dfs64))


def table_idf(kind, parts: np.ndarray, num_docs) -> np.float32:
    """``host_idf`` of one query from its terms' ``idf_terms`` entries in
    query order: the same sum, the same narrowing."""
    if kind in ("bm25", "bm25_legacy"):
        return np.float32(parts.sum())
    if kind == "classic":
        return np.float32(np.log((num_docs + 1) / (parts.sum() + 1)) + 1.0)
    return np.float32(0.0)


def idf_table(index: DeviceIndex, kind: str) -> np.ndarray:
    """``idf_terms`` of ``index``'s ``doc_freqs`` and ``stats_docs`` (the
    corpus's), built once per kind and kept on the index."""
    got = index.idf_tables.get(kind)
    if got is None:
        got = index.idf_tables[kind] = idf_terms(kind, index.doc_freqs,
                                                 index.stats_docs)
    return got


def query_idf(index: DeviceIndex, kind: str, term_ids) -> np.float32:
    """One query's idf from ``index``'s per-term table (``table_idf``)."""
    return table_idf(kind, idf_table(index, kind)[list(term_ids)],
                     index.stats_docs)


def table_idfs(kind, parts: np.ndarray, num_docs) -> np.ndarray:
    """float32 [Q]: ``host_idf`` of Q single-term queries from their
    terms' ``idf_terms`` entries, all at once."""
    if kind in ("bm25", "bm25_legacy"):
        return parts.astype(np.float32)
    if kind == "classic":
        return (np.log((num_docs + 1) / (parts + 1)) + 1.0).astype(np.float32)
    return np.zeros(len(parts), np.float32)


# ---------------------------------------------------------------------------
# term stats
# ---------------------------------------------------------------------------
def _window_blocks(min_posn, max_posn) -> Tuple[int, int]:
    """Validate and convert a position window to block bounds.

    Parity with the reference's multiple-of-18 contract
    (`roaringish.py:267-282`).
    """
    if min_posn is None and max_posn is None:
        return 0, (1 << 18) - 1
    if min_posn is not None and min_posn % LSB_BITS != 0:
        raise ValueError(f"min_posn must be a multiple of {LSB_BITS}")
    if max_posn is not None and max_posn % LSB_BITS != LSB_BITS - 1:
        raise ValueError(f"max_posn must be a multiple of {LSB_BITS} - 1")
    lo = 0 if min_posn is None else min_posn // LSB_BITS
    hi = (1 << 18) - 1 if max_posn is None else max_posn // LSB_BITS
    return lo, hi


def docfreq(index: DeviceIndex, term_id: int) -> int:
    """Number of documents containing the term (host table lookup)."""
    return int(index.doc_freqs[term_id])


def termfreqs_dense(index: DeviceIndex, term_id: int,
                    min_posn: Optional[int] = None,
                    max_posn: Optional[int] = None) -> torch.Tensor:
    """Dense float32 term freqs over the whole corpus."""
    return score_term_dense(index, term_id, kind="none",
                            min_posn=min_posn, max_posn=max_posn)


def term_planes(index: DeviceIndex, term_id: int, min_posn=None,
                max_posn=None):
    """One term's exact (hdr32, pay32) slice, payloads masked to the
    position window when one is given (take_term_planes)."""
    off, n, _ = index.term_span(term_id)
    windowed = min_posn is not None or max_posn is not None
    min_blk, max_blk = (_window_blocks(min_posn, max_posn) if windowed
                        else (None, None))
    return K.take_term_planes(index.hdrs, index.pays, off, n, min_blk,
                              max_blk, bucket=n, blk_bits=index.blk_bits)


def score_term_dense(index: DeviceIndex, term_id: int, kind: str = "bm25",
                     k1: float = 1.2, b: float = 0.75,
                     min_posn: Optional[int] = None,
                     max_posn: Optional[int] = None,
                     idf: Optional[float] = None) -> torch.Tensor:
    """Dense f32[N] scores of one term on its posting slice, inside the
    position window when one is given: K1's exact tf (kind ``none``),
    then K10, the batch driver's tf row and similarity.  Takes no pool
    slot and no lock."""
    h, p = term_planes(index, term_id, min_posn, max_posn)
    tf = kernels_cuda.score_term(h, p, index.doc_lens, 0.0, 1.0,
                                 num_docs=index.corpus_size,
                                 blk_bits=index.blk_bits, kind="none")
    if idf is None:
        idf = query_idf(index, kind, [term_id])
    avgdl = np.float32(max(index.avg_doc_length, 1e-38))
    return apply_similarity_device(kind, tf, index.doc_lens, np.float32(idf),
                                   avgdl, k1, b, out=tf)
