"""The multi-chain driver of the sparse exact-phrase chain
(``search/phrase.py:sparse_chains_freqs``): the sparse phrase groups of a
call stepped together, one K7 launch and one K2 launch per step index
over every chain (and both halves of a split chain), a row of the K2 key
space per (query, half).

On a corpus that is not dense-eligible (``DENSE_TERM_BYTES_LIMIT = 0`` on
both packages' ``dense`` modules) ``score_batch`` over phrase groups of
different plans -- two- to five-term phrases, repeated terms, a 40-term
chain split at a rare term in its middle -- equals the JAX facade, and a
call launches K7 and K2 as often as its longest chain half has steps."""
import numpy as np
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import similarity as jsim
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.search import batch, dense, phrase
from test_torch_phrase import make_docs


def corpus():
    """make_docs with one document holding a 40-term run whose middle
    term is rare (the chain splits there)."""
    docs = make_docs(n=600, seed=21)
    run = " ".join(docs[:4]).split()[:39]
    docs[9] = " ".join(run[:20] + ["zrare"] + run[20:])
    docs[10] = docs[9] + " red fox"
    return docs, (run[:20] + ["zrare"] + run[20:])[:40]


@pytest.fixture()
def sparse_pair(monkeypatch):
    monkeypatch.setattr(jdense, "DENSE_TERM_BYTES_LIMIT", 0)
    monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
    docs, long = corpus()
    jarr = JSearchArray.index(docs)
    tarr = SearchArray.index(docs, device="cpu")
    assert not dense.dense_eligible(tarr.dev)
    return jarr, tarr, long


def queries(long):
    return [["red", "fox"], ["the", "dog"], ["w1", "the", "red"],
            ["the", "the", "red"], ["red", "fox", "the", "dog"],
            ["red", "fox", "red", "fox"], ["w2", "w3", "the", "w4", "dog"],
            ["the", "the"], long, ["fox", "w9", "nope"]]


def chain_rows(tarr, qs):
    """Per resolved phrase of ``qs``: its plan halves' step counts."""
    dev = tarr.dev
    out = []
    for q in qs:
        if isinstance(q, str):
            continue
        tids = tarr._resolve_tids(q)
        if min(tids) < 0 or min(dev.term_span(t)[1] for t in tids) == 0:
            continue
        plan, _ = phrase.chain_key(dev, tids)
        out.append([len(ix) - 1 for _, ix in plan])
    return out


@pytest.mark.parametrize("sim", ["bm25_similarity", "classic_similarity"])
def test_score_batch_over_groups_of_different_plans_matches_jax(sparse_pair,
                                                                sim):
    jarr, tarr, long = sparse_pair
    qs = queries(long)
    assert [19, 19] in chain_rows(tarr, qs)   # the long chain is split
    ws, wi = jarr.score_batch(qs, similarity=getattr(jsim, sim)(), top_k=10)
    gs, gi = tarr.score_batch(qs, similarity=getattr(tsim, sim)(), top_k=10)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tarr.score_batch(qs, similarity=getattr(tsim, sim)()),
        jarr.score_batch(qs, similarity=getattr(jsim, sim)()),
        rtol=1e-6, atol=1e-7)
    assert tarr.score_batch([long], top_k=3)[1][0][0] in (9, 10)


def counting(monkeypatch):
    """Record (queries, directions, same-term flags) of every K7 call and
    the key space of every K2 call."""
    k7, k2 = [], []
    step, ssum = kc.merge_step, kc.segment_sum

    def merge_step(*a, **kw):
        Q = len(a[3])
        k7.append((Q, sorted(set(kc.per_query(kw["cont_side"], Q, "s"))),
                   sorted(set(map(bool, kc.per_query(kw["same_term"], Q,
                                                     "t"))))))
        return step(*a, **kw)

    def segment_sum(keys, counts, *, num_docs):
        k2.append(num_docs)
        return ssum(keys, counts, num_docs=num_docs)

    monkeypatch.setattr(kc, "merge_step", merge_step)
    monkeypatch.setattr(kc, "segment_sum", segment_sum)
    return k7, k2


def test_a_call_launches_once_per_step_index(sparse_pair, monkeypatch):
    """One K7 and one K2 launch per step of the longest chain half, the
    first over every (query, half) row, later ones over the rows still
    stepping; directions and same-term steps mixed in one launch."""
    _, tarr, long = sparse_pair
    qs = queries(long)
    steps = chain_rows(tarr, qs)
    k7, k2 = counting(monkeypatch)
    tarr.score_batch(qs, top_k=5)
    longest = max(max(s) for s in steps)
    assert len(k7) == longest == 19
    rows = [sum(1 for s in steps for n in s if n > j) for j in range(longest)]
    assert [q for q, _, _ in k7] == rows
    assert rows[0] == sum(len(s) for s in steps) > len(steps)
    assert k7[0][1] == ["lhs", "rhs"] and k7[0][2] == [False, True]
    npad = batch._npad(tarr.dev.corpus_size)
    assert k2 == [r * npad for r in rows]


def test_split_single_phrase_steps_both_halves_together(sparse_pair,
                                                        monkeypatch):
    """termfreqs of the split 40-term phrase: both halves share each
    step's launch (19 launches of two rows, not 38 of one)."""
    jarr, tarr, long = sparse_pair
    k7, _ = counting(monkeypatch)
    got = tarr.termfreqs(long)
    assert [q for q, _, _ in k7] == [2] * 19
    assert all(sides == ["lhs", "rhs"] for _, sides, _ in k7)
    np.testing.assert_array_equal(got, jarr.termfreqs(long))
    assert got[9] == 1 and got[10] == 1


def test_chains_of_one_call_in_runs_of_the_key_space(sparse_pair,
                                                     monkeypatch):
    """Specs whose rows would pass the flat key space go in separate
    runs of the driver; the scores do not change."""
    _, tarr, long = sparse_pair
    qs = queries(long)
    want = tarr.score_batch(qs)
    npad = batch._npad(tarr.dev.corpus_size)
    monkeypatch.setattr(batch, "_MAX_FLAT", 2 * npad)
    k7, _ = counting(monkeypatch)
    np.testing.assert_array_equal(tarr.score_batch(qs), want)
    assert max(q for q, _, _ in k7) <= 2
