"""Port parity: exact top-k with the smallest-index tie rule, against the
JAX package's topk_exact (its block path included)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu.ops.kernels import topk_exact as j_topk
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch.ops.kernels import topk_exact
from searcharray_tpu_torch.search import dense


def test_ties_go_to_the_smallest_index():
    vals, idx = topk_exact(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 2)
    assert idx.tolist() == [1, 2]
    assert vals.tolist() == [3.0, 3.0]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_all_equal_row(k):
    vals, idx = topk_exact(torch.zeros(2, 5), k)
    assert idx.tolist() == [list(range(k))] * 2
    assert vals.tolist() == [[0.0] * k] * 2


@pytest.mark.parametrize("n", [1000, 4 * 8192 + 1234])  # one-stage, block path
@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("levels", [3, 50, 0])  # heavy ties ... distinct
def test_matches_jax(n, k, levels):
    rng = np.random.default_rng(n + k + levels)
    if levels:
        x = rng.integers(0, levels, (3, n)).astype(np.float32) / 7
    else:
        x = rng.random((3, n)).astype(np.float32)
    want_v, want_i = j_topk(jnp.asarray(x), k)
    got_v, got_i = topk_exact(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # and against the definition: order by (-score, index)
    for r in range(3):
        order = np.lexsort((np.arange(n), -x[r]))[:k]
        np.testing.assert_array_equal(got_i[r].numpy(), order)


def test_one_dimensional_row_matches_jax():
    x = np.random.default_rng(1).integers(0, 4, 40000).astype(np.float32)
    want_v, want_i = j_topk(jnp.asarray(x), 10)
    got_v, got_i = topk_exact(torch.from_numpy(x), 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_pack_topk_matches_jax():
    x = np.random.default_rng(2).integers(0, 9, (4, 3000)).astype(np.float32)
    want = np.asarray(jdense.pack_topk(jnp.asarray(x), 10))
    got = dense.pack_topk(torch.from_numpy(x), 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
