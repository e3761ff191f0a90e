"""Passage retrieval on one field: each call is one blocking
``SearchArray.score_batch(queries, slop=..., top_k=k)`` of the port, the
reference ranks each query itself."""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, List

from benchmark.reference.index import RefIndex
from benchmark.reference.search import Scores, exact, score_query


class System:
    """The port's index of the configuration's field, built and warmed as
    a deployment starts: ``SearchArray.index``, then the device attach,
    the pool warm-up and ``warm_serving``."""

    def __init__(self, config: dict, corpus, device: str, setup):
        from searcharray_tpu_torch import SearchArray, bm25_similarity

        sim = config["similarity"]
        self.sim = bm25_similarity(k1=sim["k1"], b=sim["b"])
        texts = corpus.fields[config["search"]["field"]].texts
        with setup.span("build"):
            self.arr = SearchArray.index(texts, device=device, autowarm=False)
        with setup.span("attach"):
            self.arr.warm()           # the device attach, the tf pool
            self.arr.warm_serving()

    def run(self, call) -> List[tuple]:
        scores, idx = self.arr.score_batch(call.queries, similarity=self.sim,
                                           slop=call.slops, top_k=call.top_k)
        return list(zip(scores, idx))

    def maps(self) -> list:
        return [self.arr.dev.maps]

    @contextlib.contextmanager
    def traced(self, spans: list):
        yield


class Reference:
    def __init__(self, config: dict, corpus, cache: int = 4096):
        self.field = config["search"]["field"]
        f = corpus.fields[self.field]
        self.index = RefIndex(f.tokens, f.lens, corpus.vocab)
        self.k1 = config["similarity"]["k1"]
        self.b = config["similarity"]["b"]
        self._memo: "OrderedDict[tuple, Scores]" = OrderedDict()
        self._cache = cache

    def indexes(self) -> Dict[str, RefIndex]:
        return {self.field: self.index}

    def answers(self, call, rnd=exact) -> List[Scores]:
        out = []
        for q, slop in zip(call.queries, call.slops):
            words = (q,) if isinstance(q, str) else tuple(q)
            key = (words, slop if len(words) > 1 else 0, rnd.__name__)
            got = self._memo.get(key)
            if got is None:
                got = score_query(self.index, q, key[1], self.k1, self.b, rnd)
                self._memo[key] = got
                if len(self._memo) > self._cache:
                    self._memo.popitem(last=False)
            out.append(got)
        return out

    def needs(self, call) -> Dict[str, Dict[str, bool]]:
        """Per field, each distinct word the call reads, True where a
        phrase or slop query needs its positions."""
        words: Dict[str, bool] = {}
        for q in call.queries:
            if isinstance(q, str):
                words.setdefault(q, False)
            else:
                for w in q:
                    words[w] = words.get(w, False) or len(q) > 1
        return {self.field: words}
