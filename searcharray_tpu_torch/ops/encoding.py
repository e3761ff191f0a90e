"""Roaringish position encoding — the on-disk / in-HBM postings word format.

Each posting word is a ``uint64``::

    |  28 bits  |   18 bits    |      18 bits       |
    |  doc key  | posn block # | position bitmap    |
      (bits 36..63) (bits 18..35)   (bits 0..17)

Bit ``i`` of the bitmap means position ``block * 18 + i`` is occupied.
Words for one term are strictly sorted by (key, block) and each
(key, block) appears at most once.

This is the same wire format as the reference's roaringish encoding
(`searcharray/roaringish/roaringish.py:30-45,93-142`), kept
for exact parity of observable semantics (MAX_POSN = 2**18 - 1, position
windows in multiples of 18).  The *algorithms* over it are redesigned for
TPU: fixed-shape vector kernels instead of galloping pointer chases.

Host-side (numpy) encode/decode lives here; device kernels are in
``searcharray_tpu_torch.ops.kernels``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

KEY_BITS = 28
MSB_BITS = 18
LSB_BITS = 18

KEY_SHIFT = 64 - KEY_BITS          # 36
MSB_SHIFT = LSB_BITS               # 18

KEY_MASK = np.uint64(0xFFFFFFF000000000)
MSB_MASK = np.uint64(0x0000000FFFFC0000)
LSB_MASK = np.uint64(0x000000000003FFFF)
HEADER_MASK = np.uint64(KEY_MASK | MSB_MASK)

# The reference caps positions at 2**18 - 1 (`roaringish.py:86-91`,
# `middle_out.py:41`); keep the identical cap.
MAX_POSN = (1 << 18) - 1

_U64 = np.uint64
_1 = np.uint64(1)

# A padding word that never equals a real posting word and contributes
# nothing: max header, zero payload bitmap.
PAD_WORD = np.uint64(0xFFFFFFFFFFFC0000)


def pack_header(keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Combine doc keys and position blocks into the 46-bit header (<<18)."""
    return (keys.astype(np.uint64) << _U64(KEY_SHIFT)) | (
        blocks.astype(np.uint64) << _U64(MSB_SHIFT)
    )


def keys_of(words: np.ndarray) -> np.ndarray:
    return words >> _U64(KEY_SHIFT)


def blocks_of(words: np.ndarray) -> np.ndarray:
    return (words & MSB_MASK) >> _U64(MSB_SHIFT)


def payload_of(words: np.ndarray) -> np.ndarray:
    return words & LSB_MASK


def header_of(words: np.ndarray) -> np.ndarray:
    return words & ~LSB_MASK


def encode_flat(
    keys: np.ndarray,
    posns: np.ndarray,
    term_starts: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Pack (doc key, position) pairs into sorted posting words.

    ``keys``/``posns`` must be ordered by (term, key, posn) where term
    grouping is given by ``term_starts`` (sorted start indices including 0).
    Returns the packed word array and, when ``term_starts`` is given, the
    output-space boundaries of each term's words (length ``len(term_starts)+1``).

    Vectorised segmented bitwise-OR — one pass, no per-token Python.
    """
    n = len(posns)
    if n == 0:
        empty = np.empty(0, dtype=np.uint64)
        if term_starts is None:
            return empty, None
        return empty, np.zeros(len(term_starts) + 1, dtype=np.int64)

    posns = posns.astype(np.uint64, copy=False)
    if np.any(posns > MAX_POSN):
        raise ValueError(f"Positions must be less than {MAX_POSN + 1}")

    hdr = pack_header(keys, posns // _U64(LSB_BITS))
    bits = _1 << (posns % _U64(LSB_BITS))
    full = hdr | bits

    change = np.flatnonzero(hdr[1:] != hdr[:-1]) + 1
    if term_starts is not None:
        # union of two sorted index sets in O(n) (np.union1d re-sorts and
        # was the hottest line of the 1M-doc build profile)
        starts = np.asarray(term_starts, dtype=np.int64)
        flags = np.zeros(n, dtype=bool)
        flags[change] = True
        s = starts[(starts > 0) & (starts < n)]
        flags[s] = True
        cuts = np.concatenate([[0], np.flatnonzero(flags)])
    else:
        cuts = np.concatenate([[0], change])
    cuts = cuts.astype(np.int64)

    words = np.bitwise_or.reduceat(full.view(np.int64), cuts).view(np.uint64)

    if term_starts is None:
        return words, None
    out_bounds = np.searchsorted(cuts, starts, side="left")
    out_bounds = np.concatenate([out_bounds, [len(words)]]).astype(np.int64)
    return words, out_bounds


def decode_words(words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack posting words back to (doc keys, positions), sorted.

    Inverse of :func:`encode_flat` for one term; used for the ``positions()``
    API and round-trip tests (parity: `roaringish.py:144-166`).
    """
    if len(words) == 0:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64)
    payload = payload_of(words)
    counts = popcount64(payload).astype(np.int64)
    total = int(counts.sum())
    word_idx = np.repeat(np.arange(len(words)), counts)
    # Rank of each emitted bit within its word.
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(total) - offsets[word_idx]
    # k-th set bit of each payload, via cumulative bit expansion.
    bit_matrix = (payload[word_idx, None] >> np.arange(LSB_BITS, dtype=np.uint64)) & _1
    cum = np.cumsum(bit_matrix, axis=1)
    bitpos = np.argmax(cum == (rank + 1)[:, None], axis=1).astype(np.uint64)
    posns = blocks_of(words)[word_idx] * _U64(LSB_BITS) + bitpos
    return keys_of(words)[word_idx], posns


_POP16 = np.array([bin(i).count("1") for i in range(1 << 16)], dtype=np.uint8)


def popcount64(arr: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint64 array (host-side, table-driven)."""
    if hasattr(np, "bitwise_count"):  # numpy >= 2.0
        return np.bitwise_count(arr).astype(np.uint64)
    v = arr.view(np.uint16).reshape(len(arr), 4)
    return _POP16[v].sum(axis=1).astype(np.uint64)

