"""The synthetic MS MARCO-style corpus, generated from the seed on the card.

The distribution of ``bench.py:build_corpus``: a vocabulary of a few head
words then ``<prefix>0 .. <prefix>{tail_size - 1}``, token ids drawn by
Zipf's law with the configured exponent over that whole vocabulary,
passage lengths uniform over [min_len, max_len] whitespace tokens.  It is
drawn in a few large calls of a ``torch.Generator`` on the device and
turned into whitespace-joined strings without a Python loop over docs.

One ``Corpus`` holds what both sides are handed: the strings the system
indexes and the token ids (with the passage lengths) the reference
indexes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch


def seed_of(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for one stream of a run's seed."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def vocabulary(spec: dict) -> List[str]:
    return list(spec["head"]) + [f"{spec['tail_prefix']}{i}"
                                 for i in range(spec["tail_size"])]


def zipf_cdf(spec: dict) -> np.ndarray:
    """float64 cumulative probabilities of the vocabulary's ranks."""
    n = len(spec["head"]) + spec["tail_size"]
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** spec["zipf_exponent"]
    return np.cumsum(p / p.sum())


@dataclass
class Field:
    """One text field: its strings and its token ids cut by ``lens``."""
    texts: List[str]
    tokens: np.ndarray
    lens: np.ndarray


@dataclass
class Corpus:
    words: List[str]
    vocab: Dict[str, int]
    fields: Dict[str, Field]


def _texts(tokens: torch.Tensor, lens: torch.Tensor,
           words: List[str]) -> List[str]:
    """Whitespace-joined strings of each doc's tokens: every word's bytes
    and a space gathered as fixed-width rows, the padding dropped, each
    doc's last space turned into a newline, one split."""
    width = max(len(w) for w in words) + 1
    table = np.zeros((len(words), width), dtype=np.uint8)
    for i, w in enumerate(words):
        table[i, : len(w)] = np.frombuffer(w.encode("ascii"), np.uint8)
        table[i, len(w)] = ord(" ")
    dev = tokens.device
    rows = torch.from_numpy(table).to(dev)[tokens.long()]
    nbytes = torch.tensor([len(w) + 1 for w in words], dtype=torch.int64,
                          device=dev)[tokens.long()]
    if int(lens.min()) < 1:
        raise ValueError("every doc needs at least one token")
    flat = rows[rows != 0]
    last = torch.cumsum(nbytes, 0)[torch.cumsum(lens, 0) - 1] - 1
    flat[last] = ord("\n")
    return flat.cpu().numpy().tobytes().decode("ascii").split("\n")[:-1]


def generate(spec: dict, n_docs: int, fields: dict, seed: int,
             device) -> Corpus:
    """The corpus of ``spec`` (head, tail_prefix, tail_size,
    zipf_exponent, min_len, max_len) over ``n_docs`` passages, with the
    fields ``fields`` maps to ``{"from": "passage"}`` (the passage) or
    ``{"from": "passage", "first_tokens": n}`` (its first n tokens)."""
    words = vocabulary(spec)
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 0))
    lens = torch.randint(spec["min_len"], spec["max_len"] + 1, (n_docs,),
                         generator=g, device=device, dtype=torch.int64)
    total = int(lens.sum())
    cdf = torch.from_numpy(zipf_cdf(spec)).to(device)
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    tokens = torch.searchsorted(cdf, u, right=True).clamp_(max=len(words) - 1)
    del u
    tokens = tokens.to(torch.int32)
    out: Dict[str, Field] = {}
    for name, how in fields.items():
        if how.get("from") != "passage":
            raise ValueError(f"field {name}: unknown source {how!r}")
        first = how.get("first_tokens")
        if first is None:
            f_tok, f_len = tokens, lens
        else:
            f_len = torch.clamp(lens, max=int(first))
            starts = torch.cumsum(lens, 0) - lens
            at = starts[:, None] + torch.arange(int(first), device=device)
            keep = torch.arange(int(first), device=device)[None, :] < f_len[:, None]
            f_tok = tokens[at[keep]]
        out[name] = Field(_texts(f_tok, f_len, words), f_tok.cpu().numpy(),
                          f_len.cpu().numpy())
    return Corpus(words, {w: i for i, w in enumerate(words)}, out)
