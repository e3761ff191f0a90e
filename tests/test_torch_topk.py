"""Port parity: exact top-k with the smallest-index tie rule, against the
JAX package's topk_exact (its block path included)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu.ops.kernels import topk_exact as j_topk
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.ops.kernels import (
    topk_by_keys,
    topk_exact,
    topk_keys,
)
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


# ---------------------------------------------------------------------------
# the 64-bit key order the K3 kernel selects by, in plain PyTorch
# ---------------------------------------------------------------------------
def key_rows(name, rng, q=3, n=500):
    if name == "distinct":
        return rng.standard_normal((q, n)).astype(np.float32)
    if name == "ties":
        return (rng.integers(-2, 3, (q, n)) / 7).astype(np.float32)
    if name == "signed zeros":
        x = np.zeros((q, n), np.float32)
        x[rng.random((q, n)) < 0.5] = -0.0
        x[rng.random((q, n)) < 0.02] = 1.0
        x[rng.random((q, n)) < 0.02] = -1.0
        return x
    if name == "-inf":
        x = rng.standard_normal((q, n)).astype(np.float32)
        x[rng.random((q, n)) < 0.6] = -np.inf
        return x
    if name == "all -inf":
        return np.full((q, n), -np.inf, np.float32)
    if name == "fewer than k positive":
        x = np.zeros((q, n), np.float32)
        x[:, [7, 200, 3]] = [[2.0, 1.0, 2.0]] * q
        return x
    if name == "extremes":
        x = rng.standard_normal((q, n)).astype(np.float32)
        x[:, 5] = np.inf
        x[:, 9] = np.finfo(np.float32).tiny
        x[:, 11] = -np.finfo(np.float32).tiny
        x[:, 13] = np.float32(1e-45)   # a subnormal
        x[:, 17] = np.finfo(np.float32).max
        return x
    raise KeyError(name)


KEY_DATA = ["distinct", "ties", "signed zeros", "-inf", "all -inf",
            "fewer than k positive", "extremes"]


@pytest.mark.parametrize("k", [1, 10, 499, 500])
@pytest.mark.parametrize("data", KEY_DATA)
def test_key_order_is_the_tie_rule(data, k):
    x = torch.from_numpy(key_rows(data, np.random.default_rng(k)))
    want_v, want_i = topk_exact(x, k)
    got_v, got_i = topk_by_keys(x, k)
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    # bit for bit: a selected -0.0 comes back as -0.0
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  want_v.numpy().view(np.int32))


@pytest.mark.parametrize("data", KEY_DATA)
def test_keys_are_distinct_and_ordered_like_the_floats(data):
    x = key_rows(data, np.random.default_rng(1), q=1, n=300)[0]
    keys = topk_keys(torch.from_numpy(x)).numpy()
    assert len(np.unique(keys)) == len(keys)
    vkey = keys >> 32
    for i, j in np.random.default_rng(2).integers(0, 300, (400, 2)):
        assert (x[i] < x[j]) == (vkey[i] < vkey[j])
        assert (x[i] == x[j]) == (vkey[i] == vkey[j])
        if x[i] == x[j] and i < j:
            assert keys[i] > keys[j]  # the smaller index ranks first


def test_signed_zeros_tie():
    x = torch.tensor([-0.0, 0.0, -0.0, 0.0, -1.0])
    assert topk_by_keys(x, 3)[1].tolist() == [0, 1, 2]
    assert topk_exact(x, 3)[1].tolist() == [0, 1, 2]
    keys = topk_keys(x)
    assert (keys[:4] >> 32).unique().numel() == 1


@pytest.mark.parametrize("shape", [(40,), (3, 40), (2, 3, 40)])
def test_topk_wrapper_on_the_cpu_is_the_plain_version(shape):
    x = torch.from_numpy(np.random.default_rng(len(shape)).integers(
        0, 5, shape).astype(np.float32))
    before = kc.topk.launches
    vals, idx = kc.topk(x, 6)
    assert kc.topk.launches == before  # the CPU launches nothing
    want_v, want_i = kc.topk_plain(x, 6)
    assert idx.dtype == torch.int32 and vals.shape == shape[:-1] + (6,)
    np.testing.assert_array_equal(idx.numpy(), want_i.numpy())
    np.testing.assert_array_equal(vals.numpy(), want_v.numpy())


def test_topk_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((3, 10))
    for k in (0, 11, -1):
        with pytest.raises(ValueError, match="k must be"):
            kc.topk(x, k)
    with pytest.raises(ValueError, match="contiguous"):
        kc.topk(x.t(), 2)
    with pytest.raises(TypeError):
        kc.topk(x.to(torch.float64), 2)
    with pytest.raises(ValueError, match="2\\^31"):
        kc.topk(torch.empty((2**31,), dtype=torch.float32, device="meta"), 1)


def test_pack_topk_of_nothing_is_empty():
    got = dense.pack_topk(torch.zeros((2, 5)), 0)
    assert got.shape == (2, 0) and got.dtype == torch.int32
