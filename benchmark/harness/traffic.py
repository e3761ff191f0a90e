"""The one traffic generator: turns a traffic file into a seeded stream of
calls for each client.

A traffic file (``benchmark/traffic/<name>.json``) is data only:

* ``call``: ``"batch"`` (one ``score_batch`` of many queries, each a word
  or a list of words, with a slop each) or ``"single"`` (one free-text
  query string);
* ``clients``: closed-loop client threads, each waiting for its reply
  before it sends again;
* ``top_k``: the ranked results a call asks for;
* ``draws``: named word draws that ``$<name>`` placeholders take:
  ``{"kind": "uniform", "prefix": "w", "lo": 0, "hi": 29000}`` (a word
  ``w<i>``, i uniform over [lo, hi)) or ``{"kind": "corpus_zipf"}`` (a
  word of the configuration's vocabulary, drawn by the corpus's own
  Zipf law); the words drawn for one query are distinct;
* for ``batch``: ``batch``, a list of parts ``{"repeat": r, "slop": s,
  "queries": [...]}``, each part's queries sent r times over with fresh
  draws;
* ``distinct`` (optional, false): no query appears twice in one call (a
  query that repeats an earlier one is drawn again);
* for ``single``: ``shapes``, query templates; each client cycles
  through them, every cycle in an order drawn from the seed, so every
  seed sends the same shapes as often.

Client c's calls in a stream come in order from one generator of (seed,
stream, c), so a seed gives the same calls however many are sent, and the
warm-up (stream 1) draws apart from the window (stream 0).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np

from benchmark.harness.corpus import seed_of, vocabulary, zipf_cdf

WINDOW, WARMUP = 0, 1
Query = Union[str, List[str]]


@dataclass
class Call:
    """One client request: ``queries`` with a ``slops`` each (batch), or
    the query string ``q`` (single)."""
    top_k: int
    queries: List[Query] = field(default_factory=list)
    slops: List[int] = field(default_factory=list)
    q: Optional[str] = None

    @property
    def n_queries(self) -> int:
        return 1 if self.q is not None else len(self.queries)


class Traffic:
    def __init__(self, spec: dict, corpus_spec: dict):
        self.spec = spec
        self.kind = spec["call"]
        if self.kind not in ("batch", "single"):
            raise ValueError(f"unknown call kind {self.kind!r}")
        self.clients = int(spec.get("clients", 1))
        self.top_k = int(spec["top_k"])
        self.draws = spec.get("draws", {})
        self.distinct = bool(spec.get("distinct", False))
        self._words = vocabulary(corpus_spec)
        self._cdf = zipf_cdf(corpus_spec)
        for name, d in self.draws.items():
            if d["kind"] not in ("uniform", "corpus_zipf"):
                raise ValueError(f"draw {name}: unknown kind {d['kind']!r}")
        # a batch call's queries as templates, with their slops
        self._templates, self._single, self._slops = [], [], []
        for part in spec.get("batch", []):
            for _ in range(int(part.get("repeat", 1))):
                for q in part["queries"]:
                    self._templates.append([q] if isinstance(q, str)
                                           else list(q))
                    self._single.append(isinstance(q, str))
                    self._slops.append(int(part.get("slop", 0)))

    def _draw(self, rng: np.random.Generator, name: str, n: int) -> list:
        """``n`` words of the draw ``name``, in one vectorised call."""
        d = self.draws[name]
        if d["kind"] == "uniform":
            return [f"{d['prefix']}{i}"
                    for i in rng.integers(d["lo"], d["hi"], size=n).tolist()]
        ids = np.minimum(np.searchsorted(self._cdf, rng.random(n),
                                         side="right"), len(self._words) - 1)
        return [self._words[i] for i in ids.tolist()]

    def _queries(self, rng, templates: List[List[str]]) -> List[List[str]]:
        """Fill every ``$<draw>`` of a call's queries; the words drawn for
        one query are distinct (a repeat is drawn again), and with
        ``distinct`` so are the call's queries."""
        holes = [[(j, w[1:]) for j, w in enumerate(words) if w[0] == "$"]
                 for words in templates]
        need: dict = {}
        for hs in holes:
            for _, name in hs:
                need[name] = need.get(name, 0) + 1
        pools = {k: iter(self._draw(rng, k, n)) for k, n in need.items()}
        spare: dict = {}

        def redraw(name: str) -> str:
            # a query that repeats draws again, from batches of 64 words
            pick = next(spare.get(name, iter(())), None)
            if pick is None:
                spare[name] = iter(self._draw(rng, name, 64))
                pick = next(spare[name])
            return pick

        out, seen = [], set()
        for words, hs in zip(templates, holes):
            got = list(words)
            for j, name in hs:
                pick = next(pools[name])
                while pick in got:
                    pick = self._draw(rng, name, 1)[0]
                got[j] = pick
            if self.distinct:
                if tuple(got) in seen and not hs:
                    raise ValueError(f"query {got} repeats and draws nothing")
                while tuple(got) in seen:
                    j, name = hs[-1]
                    pick = redraw(name)
                    if pick not in got:
                        got[j] = pick
                seen.add(tuple(got))
            out.append(got)
        return out

    def stream(self, seed: int, stream: int, client: int) -> "Stream":
        return Stream(self, seed, stream, client)

    def _next(self, rng, i: int, state: dict) -> Call:
        if self.kind == "single":
            shapes = self.spec["shapes"]
            if i % len(shapes) == 0:
                state["order"] = rng.permutation(len(shapes))
            words = self._queries(rng, [shapes[state["order"][i % len(shapes)]]
                                        .split()])[0]
            return Call(self.top_k, q=" ".join(words))
        queries: List[Query] = [w[0] if one else w for w, one in zip(
            self._queries(rng, self._templates), self._single)]
        return Call(self.top_k, queries, list(self._slops))


class Stream:
    """The calls of one client in one stream, drawn in order from one
    generator and kept: ``stream[i]`` is call i."""

    def __init__(self, traffic: Traffic, seed: int, stream: int,
                 client: int):
        self.traffic = traffic
        self.rng = np.random.default_rng(seed_of(seed, 1, stream, client))
        self.state: dict = {}
        self.calls: List[Call] = []
        self.sealed = False     # set once the window's calls are drawn
        self.late = 0           # calls drawn after that

    def __getitem__(self, i: int) -> Call:
        while len(self.calls) <= i:
            self.late += self.sealed
            self.calls.append(self.traffic._next(self.rng, len(self.calls),
                                                 self.state))
        return self.calls[i]

    def take(self, n: int) -> List[Call]:
        return [self[i] for i in range(n)]
