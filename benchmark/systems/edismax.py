"""Solr edismax over two fields: each call is one
``searcharray_tpu_torch.edismax(frame, q, ..., top_k=k)`` of the port over
a frame of the configuration's fields; the reference composes the same
query itself."""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, List

import numpy as np

from benchmark.harness.record import FIELD_CALL
from benchmark.reference.index import RefIndex
from benchmark.reference.search import (Scores, dense_query, edismax, exact,
                                        parse_boosts)


def _fields(search: dict) -> List[str]:
    out: List[str] = []
    for key in ("qf", "pf", "pf2"):
        for f in parse_boosts(search.get(key, [])):
            if f not in out:
                out.append(f)
    return out


class System:
    def __init__(self, config: dict, corpus, device: str, setup):
        import pandas as pd
        from searcharray_tpu_torch import SearchArray, bm25_similarity

        sim = config["similarity"]
        self.sim = bm25_similarity(k1=sim["k1"], b=sim["b"])
        self.search = config["search"]
        arrays = {}
        for f in _fields(self.search):
            with setup.span("build"):
                arrays[f] = SearchArray.index(corpus.fields[f].texts,
                                              device=device, autowarm=False)
            with setup.span("attach"):
                arrays[f].warm()
                arrays[f].warm_serving()
        self.arrays = arrays
        self.frame = pd.DataFrame(arrays)

    def run(self, call) -> List[tuple]:
        from searcharray_tpu_torch import edismax as port_edismax

        s = self.search
        (scores, idx), _ = port_edismax(
            self.frame, q=call.q, qf=s["qf"], mm=s["mm"], tie=s["tie"],
            pf=s.get("pf"), pf2=s.get("pf2"), similarity=self.sim,
            top_k=call.top_k)
        return [(scores, idx)]

    def maps(self) -> list:
        return [a.dev.maps for a in self.arrays.values()]

    @contextlib.contextmanager
    def traced(self, spans: list):
        """Record a span around every ``score_batch_device`` call the
        composer makes (its per-field batches)."""
        from searcharray_tpu_torch import SearchArray

        inner = SearchArray.score_batch_device

        def timed(arr, *args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return inner(arr, *args, **kwargs)
            finally:
                spans.append((FIELD_CALL, t0, time.perf_counter_ns()))

        SearchArray.score_batch_device = timed
        try:
            yield
        finally:
            SearchArray.score_batch_device = inner


class Reference:
    def __init__(self, config: dict, corpus, cache: int = 96):
        self.search = config["search"]
        self.k1 = config["similarity"]["k1"]
        self.b = config["similarity"]["b"]
        self._indexes = {f: RefIndex(corpus.fields[f].tokens,
                                     corpus.fields[f].lens, corpus.vocab)
                         for f in _fields(self.search)}
        self._memo: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._cache = cache

    def indexes(self) -> Dict[str, RefIndex]:
        return self._indexes

    def answers(self, call, rnd=exact) -> List[Scores]:
        def dense(field, words):
            key = (field, tuple(words), rnd.__name__)
            got = self._memo.get(key)
            if got is None:
                got = dense_query(self._indexes[field], words, 0, self.k1,
                                  self.b, rnd)
                self._memo[key] = got
                if len(self._memo) > self._cache:
                    self._memo.popitem(last=False)
            else:
                self._memo.move_to_end(key)
            return got

        s = self.search
        return [edismax(self._indexes, call.q, qf=s["qf"], mm=s["mm"],
                        tie=s["tie"], pf=s.get("pf", ()),
                        pf2=s.get("pf2", ()), k1=self.k1, b=self.b, rnd=rnd,
                        dense=dense)]

    def needs(self, call) -> Dict[str, Dict[str, bool]]:
        """Per field, each distinct word the call reads there, True where
        a pf or pf2 phrase needs its positions."""
        words = call.q.split()
        out: Dict[str, Dict[str, bool]] = {}
        for f in parse_boosts(self.search["qf"]):
            out.setdefault(f, {}).update({w: False for w in words})
        for key in ("pf", "pf2"):
            if len(words) < 2:
                continue
            for f in parse_boosts(self.search.get(key, [])):
                out.setdefault(f, {}).update({w: True for w in words})
        return out
