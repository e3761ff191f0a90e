"""Port parity for the serving warm-up (``utils/warm.py``): the cases of
tests/test_warm_serving.py against the port, on the CPU."""
import numpy as np
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.parallel import sharded as tsh


def warm_corpus():
    """tests/test_warm_serving.py's corpus: two hot terms and 100 rare
    ones."""
    rng = np.random.default_rng(31)
    vocab = ["h1", "h2"] + [f"r{i}" for i in range(100)]
    probs = np.concatenate([[0.3, 0.25], np.full(100, 0.45 / 100)])
    return [" ".join(rng.choice(vocab, size=rng.integers(4, 40), p=probs))
            for _ in range(1200)]


QUERIES = ["h1", "r5", ["h1", "r5"], ["r5", "h1", "h2"]]
KNOBS = dict(batch_sizes=(1, 4), slops=(0, 1), phrase_lens=(2, 3))


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_warm_serving_counts_as_jax_and_preserves_scores():
    corpus = warm_corpus()
    jarr = JSearchArray.index(corpus, autowarm=False)
    tarr = SearchArray.index(corpus, device="cpu", autowarm=False)
    baseline = tarr.score_batch(QUERIES)
    ranked = tarr.score_batch(QUERIES, top_k=5, slop=[0, 0, 1, 0])
    n = tarr.warm_serving(**KNOBS)
    assert n > 0 and n == jarr.warm_serving(**KNOBS)
    np.testing.assert_array_equal(bits(tarr.score_batch(QUERIES)),
                                  bits(baseline))
    again = tarr.score_batch(QUERIES, top_k=5, slop=[0, 0, 1, 0])
    np.testing.assert_array_equal(bits(again[0]), bits(ranked[0]))
    np.testing.assert_array_equal(again[1], ranked[1])
    np.testing.assert_allclose(baseline, jarr.score_batch(QUERIES),
                               rtol=1e-6, atol=1e-6)
    # the warm queries left the pools holding rows
    assert tarr.dev.maps.tf_slot and tarr.dev.maps.plane_slot


def test_warm_serving_sharded_one_plan_per_batch():
    """On a mesh the warm-up runs through the sharded path: one plan per
    score_batch call, the same count, scores unchanged."""
    corpus = warm_corpus()[:400]
    mesh = tsh.default_mesh(devices=[torch.device("cpu")] * 8)
    arr = SearchArray.index(corpus, device="cpu", mesh=mesh, autowarm=False)
    single = SearchArray.index(corpus, device="cpu", autowarm=False)
    baseline = arr.score_batch(QUERIES)
    calls = []
    score_batch = arr.score_batch

    def spy(*a, **kw):
        calls.append(1)
        return score_batch(*a, **kw)

    arr.score_batch = spy
    plans = tsh.PLANS[0]
    n = arr.warm_serving(**KNOBS)
    assert n == single.warm_serving(**KNOBS) > 0
    assert tsh.PLANS[0] - plans == len(calls) > 0
    del arr.score_batch
    np.testing.assert_array_equal(bits(arr.score_batch(QUERIES)),
                                  bits(baseline))


def test_warm_serving_empty_index():
    assert SearchArray.index(["", ""], device="cpu").warm_serving() == 0
    assert JSearchArray.index(["", ""]).warm_serving() == 0
