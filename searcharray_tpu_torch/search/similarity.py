"""Similarity functions (BM25 family) — float32, Lucene-parity formulas.

Protocol identical to the reference (`searcharray/similarity.py:8`):
``sim(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs) -> scores``.

Implementations are dtype-polymorphic: they accept numpy arrays or torch
tensors and compute with the caller's array library, so the scoring path
can stay on the device while user-supplied numpy similarities still work.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch


class Similarity(Protocol):
    def __call__(self, term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        ...


def _xp(arr):
    return torch if isinstance(arr, torch.Tensor) else np


def _f32(arr):
    """``arr`` as float32 in its own array library."""
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.float32)
    return arr.astype(np.float32)


def compute_idf(num_docs, dfs):
    """Lucene-9 idf: sum over query terms of ln(1 + (N - df + .5)/(df + .5)).

    Computed in float64 then narrowed, matching the reference's numpy-sum
    then C-float cast (`similarity.py:19-21`, `bm25.pyx:28-41`).
    """
    dfs64 = np.asarray(dfs, dtype=np.float64)
    return np.float32(np.sum(np.log1p((num_docs - dfs64 + 0.5) / (dfs64 + 0.5))))


def bm25_similarity(k1: float = 1.2, b: float = 0.75) -> Similarity:
    """BM25 as in Lucene 9 (LUCENE-8563 form, no (k1+1) numerator)."""

    def bm25(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        xp = _xp(term_freqs)
        if avg_doc_lens == 0:
            return xp.zeros_like(term_freqs)
        idf = compute_idf(num_docs, np.asarray(doc_freqs))
        tf = _f32(term_freqs)
        dl = _f32(doc_lens)
        avg = np.float32(avg_doc_lens)
        k1f = np.float32(k1)
        bf = np.float32(b)
        denom = tf + k1f * ((np.float32(1.0) - bf) + bf * (dl / avg))
        return (tf / denom) * idf

    bm25._fused = ("bm25", k1, b)
    return bm25


def bm25_legacy_similarity(k1: float = 1.2, b: float = 0.75) -> Similarity:
    """Pre-LUCENE-8563 BM25 with (k1 + 1) in the numerator."""

    def bm25(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        xp = _xp(term_freqs)
        if avg_doc_lens == 0:
            return xp.zeros_like(term_freqs)
        idf = compute_idf(num_docs, np.asarray(doc_freqs))
        tf = _f32(term_freqs)
        dl = _f32(doc_lens)
        num = tf * np.float32(k1 + 1.0)
        denom = tf + np.float32(k1) * (
            np.float32(1.0 - b) + np.float32(b) * (dl / np.float32(avg_doc_lens))
        )
        return idf * (num / denom)

    bm25._fused = ("bm25_legacy", k1, b)
    return bm25


def bm25_impact(k1: float = 1.2, b: float = 0.75) -> Similarity:
    """The tf-saturation part of BM25 only (for impact indexes / BM25F)."""

    def bm25(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        xp = _xp(term_freqs)
        if avg_doc_lens == 0:
            return xp.zeros_like(term_freqs)
        tf = _f32(term_freqs)
        dl = _f32(doc_lens)
        return tf / (
            tf
            + np.float32(k1)
            * (np.float32(1.0 - b) + np.float32(b) * (dl / np.float32(avg_doc_lens)))
        )

    bm25._fused = ("bm25_impact", k1, b)
    return bm25


def classic_similarity() -> Similarity:
    """Classic Lucene TF-IDF."""

    def classic(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        xp = _xp(term_freqs)
        sum_dfs = np.sum(np.asarray(doc_freqs, dtype=np.float64), axis=0)
        idf = np.float32(np.log((num_docs + 1) / (sum_dfs + 1)) + 1.0)
        length_norm = np.float32(1.0) / xp.sqrt(_f32(doc_lens))
        tf = xp.sqrt(_f32(term_freqs))
        return idf * tf * length_norm

    classic._fused = ("classic", 1.2, 0.75)
    return classic


default_bm25 = bm25_similarity()
