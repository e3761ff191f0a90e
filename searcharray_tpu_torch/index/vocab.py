"""Term vocabulary: string <-> dense integer id, insertion-ordered.

Parity with the reference's TermDict (`searcharray/term_dict.py`):
sequential ids in first-seen order, ``compatible`` prefix check used by the
pandas facade's ``__eq__``.  Batch paths use pandas ``factorize`` so the
per-token cost is C-speed, not a Python dict probe per token.
"""
from __future__ import annotations

import sys
import threading
from typing import Iterable, List

import numpy as np


class TermMissingError(KeyError):
    pass


class Vocabulary:
    __slots__ = ("_to_id", "_terms", "_lock")

    def __init__(self) -> None:
        self._to_id: dict = {}
        self._terms: List[str] = []
        self._lock = threading.Lock()

    def add_term(self, term) -> int:
        tid = self._to_id.get(term)
        if tid is None:
            tid = len(self._terms)
            self._to_id[term] = tid
            self._terms.append(term)
        return tid

    def add_batch(self, uniques: Iterable) -> np.ndarray:
        """Map a batch of *unique* terms to global ids, adding new ones.

        Thread-safe (unlike the reference's GIL-reliant shared TermDict,
        `indexing.py:253-262`): concurrent batch tokenizers lock only on
        their batch's unique terms.
        """
        with self._lock:
            return np.fromiter(
                (self.add_term(t) for t in uniques), dtype=np.int64
            )

    def get_term_id(self, term) -> int:
        try:
            return self._to_id[term]
        except KeyError:
            raise TermMissingError(
                f"Term {term} not present in dictionary. Reindex to add."
            )

    def get_term(self, term_id: int):
        try:
            return self._terms[term_id]
        except IndexError:
            raise TermMissingError(
                f"Term at {term_id} not present in dictionary. Reindex to add."
            )

    def compatible(self, other: "Vocabulary") -> bool:
        n = min(len(self._terms), len(other._terms))
        return self._terms[:n] == other._terms[:n]

    def copy(self) -> "Vocabulary":
        new = Vocabulary()
        new._to_id = dict(self._to_id)
        new._terms = list(self._terms)
        return new

    def __len__(self) -> int:
        return len(self._terms)

    def __contains__(self, term) -> bool:
        return term in self._to_id

    def __repr__(self) -> str:
        return f"Vocabulary({len(self)} terms)"

    def __getstate__(self):
        return {"terms": self._terms}

    def __setstate__(self, state):
        self._terms = state["terms"]
        self._to_id = {t: i for i, t in enumerate(self._terms)}
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return sys.getsizeof(self._to_id) + sys.getsizeof(self._terms)
