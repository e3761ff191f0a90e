"""tests/test_pool_limits.py against the port on the CPU: a phrase with
more unique terms than the plane pool takes runs the sparse chain (no
"pool exhausted"), the pools start lazily per kind, and ``block=False``
with a custom similarity raises.  Each answer is also held to the JAX
package's on the same corpus and pool size."""
import numpy as np
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.search import dense as dense_mod


def small_pool_corpus():
    rng = np.random.default_rng(7)
    vocab = [f"t{i}" for i in range(30)]
    corpus = [
        " ".join(rng.choice(vocab, size=rng.integers(8, 40)))
        for _ in range(300)
    ]
    corpus.append(" ".join(f"t{i}" for i in range(12)) * 2)
    return corpus


@pytest.fixture()
def small_pool_docs(monkeypatch):
    monkeypatch.setattr(dense_mod, "PLANE_POOL_MAX_SLOTS", 4)
    monkeypatch.setattr(jdense, "PLANE_POOL_MAX_SLOTS", 4)
    corpus = small_pool_corpus()
    return (SearchArray.index(corpus, device="cpu"),
            JSearchArray.index(corpus))


def test_long_phrase_overflows_pool_single_query(small_pool_docs,
                                                 monkeypatch):
    arr, jarr = small_pool_docs
    assert dense_mod.plane_capacity(arr.dev) == 4
    phrase = [f"t{i}" for i in range(8)]  # 8 unique > capacity-1
    got = arr.score(phrase)  # must not raise "dense pool exhausted"
    assert got.shape == (len(arr),)
    with monkeypatch.context() as mp:
        mp.setattr(dense_mod, "DENSE_TERM_BYTES_LIMIT", 0)
        expect = arr.score(phrase)
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jarr.score(phrase), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(arr.termfreqs(phrase),
                                  jarr.termfreqs(phrase))


def test_long_phrase_overflows_pool_batch(small_pool_docs):
    arr, jarr = small_pool_docs
    queries = [
        [f"t{i}" for i in range(8)],   # overflows -> sparse group
        ["t0", "t1"],                  # fits -> dense group
        "t5",
    ]
    got = arr.score_batch(queries)
    for i, q in enumerate(queries):
        np.testing.assert_allclose(got[i], np.asarray(arr.score(q)),
                                   rtol=1e-6, atol=1e-6, err_msg=str(q))
    np.testing.assert_allclose(got, jarr.score_batch(queries), rtol=1e-6,
                               atol=1e-7)


def test_long_slop_phrase_overflows_pool(small_pool_docs):
    arr, jarr = small_pool_docs
    phrase = [f"t{i}" for i in range(6)]
    got = arr.score(phrase, slop=2)  # dense span path must decline
    assert got.shape == (len(arr),)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, jarr.score(phrase, slop=2), rtol=1e-6,
                               atol=1e-7)


def test_pools_allocate_lazily():
    rng = np.random.default_rng(3)
    corpus = [" ".join(rng.choice([f"x{i}" for i in range(20)], size=12))
              for _ in range(200)]
    arr = SearchArray.index(corpus, autowarm=False, device="cpu")
    assert arr.dev.plane_pool is None and arr.dev.tf_pool is None
    arr.score_batch(["x0", "x1"])  # term-only: only the tf pool
    assert arr.dev.tf_pool is not None
    assert arr.dev.plane_pool is None
    arr2 = SearchArray.index(corpus, autowarm=False, device="cpu")
    arr2.score_batch([["x0", "x1"]])  # phrase-only: only the plane pool
    assert arr2.dev.plane_pool is not None
    assert arr2.dev.tf_pool is None


def test_block_false_with_custom_similarity_raises():
    corpus = ["a b c", "b c d", "c d e"]
    arr = SearchArray.index(corpus, device="cpu")

    def custom(tfs, dfs, doc_lens, avg_dl, num_docs):
        return tfs.sum(axis=0) if tfs.ndim > 1 else tfs

    with pytest.raises(ValueError, match="block=False requires"):
        arr.score_batch(["a"], similarity=custom, top_k=2, block=False)
