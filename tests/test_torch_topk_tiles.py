"""K3's two-launch selection (csrc/topk.cu, k up to its one-pass cap) on
the CPU: each tile of a row selects its k largest 64-bit keys, and a merge
of the tiles' keys takes the row's k largest.

``tile_select`` follows ``topk_tile_kernel`` step by step (the first
bound from the warps' thread maxima, the least value's ties, else the
radix levels until at most ``short`` keys remain or one value is left;
the warps' tie scan over their runs of the tile; the candidates ranked
against each other) and ``merge`` follows ``topk_merge_kernel`` (the keys
at or above the tiles' best k-th key ranked, else rounds of
``merge_keys`` sorted, the best k kept).  At small tiles, tie-heavy rows put ties across tile
edges and k above a tile's length; the result must equal the port's
``topk_exact`` and the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from searcharray_tpu.ops.kernels import topk_exact as j_topk
from searcharray_tpu_torch.ops.kernels import topk_exact, topk_keys

SHIFT, BITS, BINS = (21, 10, 0), (11, 11, 10), 2048
MASK32 = np.uint64(0xFFFFFFFF)


def value_keys(x: np.ndarray) -> np.ndarray:
    """The kernel's value key: order-preserving u32, -0.0 as +0.0."""
    b = x.astype(np.float32).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000)).astype(
        np.uint32)


def find_digit(hist: np.ndarray, need: int):
    """The digit holding the need-th key from the top; the keys in higher
    digits and in it."""
    suffix = np.cumsum(hist[::-1])[::-1]
    d = int(np.nonzero(suffix >= need)[0].max())
    return d, int(suffix[d] - hist[d]), int(hist[d])


def radix_bound(keys, need, short):
    """The radix select over a tile's value keys: (bound, m, above, tie)
    as the kernel's levels leave them."""
    above, prefix = 0, 0
    for level in range(3):
        shift, bits = SHIFT[level], BITS[level]
        if level == 0:
            sel = keys
        else:
            up = shift + bits
            sel = keys[(keys >> up) == (prefix >> up)]
        hist = np.bincount((sel >> shift) & ((1 << bits) - 1),
                           minlength=BINS)
        digit, higher, inn = find_digit(hist, need - above)
        lower = prefix | (digit << shift)
        if above + higher + inn <= short:
            return lower, above + higher + inn, above, False
        above += higher
        if shift == 0:
            return lower, need, above, True
        prefix = lower


def tile_select(keys, lo, k, tile, short=256, threads=256, lanes=32,
                vec=True):
    """The k largest 64-bit keys of a tile of ``tile`` elements (fewer if
    ``keys``, its part of the row, is shorter), in descending order, as
    the kernel's pass 1 finds them with ``threads`` threads in warps of
    ``lanes``: element e is thread (e // 4 if vec else e) % threads's."""
    L = len(keys)
    need = min(L, k)
    warps = threads // lanes
    owner = (np.arange(L) // 4 if vec else np.arange(L)) % threads
    most = np.zeros(threads, np.uint32)
    np.maximum.at(most, owner, keys)
    least = int(keys.min())
    low = 0
    if need <= lanes:   # the warps' need-th largest thread maxima
        for w in range(warps):
            ms = np.sort(most[w * lanes:(w + 1) * lanes])[::-1]
            low = max(low, int(ms[need - 1]))
    above, m, tie, found = 0, 0, False, False
    if low != 0 and low != least:
        ge, gt = int((keys >= low).sum()), int((keys > low).sum())
        if ge <= short:
            bound, m, found = low, ge, True
        elif gt < need:
            bound, above, tie, found = low, gt, True, True
    elif low != 0:
        over = int((keys != least).sum())
        if over < need:
            bound, above, tie, found = least, over, True, True
    if not found:
        bound, m, above, tie = radix_bound(keys, need, short)
    if tie:
        pick = keys > bound
        quota, seg = need - above, -(-tile // warps)
        counts = [int((keys[w * seg:(w + 1) * seg] == bound).sum())
                  for w in range(warps)]
        for w in range(warps):
            seen = sum(counts[:w])
            for i in range(w * seg, min((w + 1) * seg, L)):
                if seen >= quota:
                    break
                if keys[i] == bound:
                    pick[i] = True
                    seen += 1
        m = need
    else:
        pick = keys >= bound
    cand = (keys[pick].astype(np.uint64) << np.uint64(32)) | (
        MASK32 - (lo + np.nonzero(pick)[0]).astype(np.uint64))
    assert len(cand) == m and need <= m <= max(short, need)
    return np.sort(cand)[::-1][:need]


def merge(parts, k, merge_keys=4096, merge_cand=512):
    """The kernel's pass 2: the keys at or above the largest of the
    tiles' k-th keys, ranked, where they are at most ``merge_cand`` and
    the row's keys fit ``merge_keys``; else rounds of at most
    ``merge_keys`` keys sorted, the best k kept between them."""
    keys = np.concatenate(parts)
    if len(keys) <= merge_keys:
        low = max(p[k - 1] for p in parts)
        cand = keys[keys >= low]
        assert len(cand) >= k
        if len(cand) <= merge_cand:
            return np.sort(cand)[::-1][:k]
    kept = np.zeros(0, np.uint64)
    base = 0
    while base < len(keys):
        take = min(merge_keys - len(kept), len(keys) - base)
        kept = np.sort(np.concatenate([kept, keys[base:base + take]]))[::-1]
        kept = kept[:k]
        base += take
    return kept


def tiled_topk(x, k, tile, merge_keys=4096, merge_cand=512, **pass1):
    """Values and indices of each row of ``x`` by the kernel's two passes
    at a tile of ``tile`` elements."""
    vals, idx = [], []
    for row in np.atleast_2d(x):
        keys = value_keys(row)
        parts = []
        for lo in range(0, len(row), tile):
            got = tile_select(keys[lo:lo + tile], lo, k, tile,
                              vec=len(row) % 4 == 0, **pass1)
            parts.append(np.concatenate(
                [got, np.zeros(k - len(got), np.uint64)]))
        best = parts[0][:k] if len(parts) == 1 else merge(
            parts, k, merge_keys, merge_cand)
        i = (MASK32 - (best & MASK32)).astype(np.int64)
        idx.append(i)
        vals.append(row[i])
    return np.stack(vals), np.stack(idx)


def tilewise_by_keys(x, k, tile):
    """The decomposition alone: each tile's k largest of ``topk_keys``,
    merged by one sort."""
    keys = topk_keys(torch.from_numpy(x))
    n = x.shape[-1]
    parts = [torch.sort(keys[:, lo:lo + tile], dim=-1,
                        descending=True).values[:, :k]
             for lo in range(0, n, tile)]
    best = torch.sort(torch.cat(parts, dim=-1), dim=-1,
                      descending=True).values[:, :k]
    idx = 0xFFFFFFFF - (best & 0xFFFFFFFF)
    return torch.gather(torch.from_numpy(x), -1, idx).numpy(), idx.numpy()


def assert_same(got, want):
    gv, gi = got
    wv, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(np.asarray(gi, np.int64), wi)
    # bit for bit: -0.0 comes back as -0.0
    np.testing.assert_array_equal(np.asarray(gv, np.float32).view(np.int32),
                                  wv.astype(np.float32).view(np.int32))


LEVELS = np.array([0.0, -0.0, 1.0, 2.5, -np.inf, 7.0, 1 / 3], np.float32)


@st.composite
def tie_rows(draw):
    """Rows of few values (ties at every rank), runs of one value planted
    across tile edges, k up to past a tile's length."""
    tile = draw(st.sampled_from([4, 8, 16, 64]))
    n = draw(st.integers(1, 6 * tile + 3))
    k = draw(st.integers(1, min(n, 70)))
    q = draw(st.integers(1, 3))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    x = LEVELS[rng.integers(0, draw(st.integers(1, len(LEVELS))), (q, n))]
    for r in range(q):
        if draw(st.booleans()) and n > tile:
            at = tile * int(rng.integers(1, -(-n // tile))) - int(
                rng.integers(0, 3))
            x[r, max(at, 0):at + k + 3] = 9.0
    return x.astype(np.float32), k, tile


BLOCKS = [dict(short=4, threads=8, lanes=4), dict(short=8, threads=16,
                                                 lanes=4),
          dict(short=16, threads=4, lanes=2), dict()]


@settings(max_examples=150, deadline=None)
@given(tie_rows(), st.sampled_from(BLOCKS))
def test_tiled_selection_matches_topk_exact(case, block):
    """Pass 1 with blocks small enough for the tiles: the first bound from
    thread maxima, the least value's ties, the radix levels and their tie
    scan all run; at the kernel's own block (256 threads) tiles this small
    take the radix levels."""
    x, k, tile = case
    want = topk_exact(torch.from_numpy(x), k)
    assert_same(tiled_topk(x, k, tile, **block), want)
    assert_same(tilewise_by_keys(x, k, tile), want)


@settings(max_examples=150, deadline=None)
@given(tie_rows())
def test_merge_rounds_keep_the_best_k(case):
    """Pass 2's sort when the candidates above the tiles' bound are too
    many (merge_cand k) and in rounds smaller than the row's keys (k + 1
    to 3k a round)."""
    x, k, tile = case
    want = topk_exact(torch.from_numpy(x), k)
    for merge_keys, merge_cand in ((4096, k), (k + 1, 512), (2 * k, 512),
                                   (3 * k, k)):
        assert_same(tiled_topk(x, k, tile, merge_keys, merge_cand,
                               short=8, threads=16, lanes=4), want)


@pytest.mark.parametrize("tile", [8, 64, 1024])
@pytest.mark.parametrize("k", [1, 10, 64, 65])
@pytest.mark.parametrize("data", ["distinct", "few levels", "zeros",
                                  "few positive", "pads"])
def test_tiled_selection_matches_jax(tile, k, data):
    """Against the JAX package's topk_exact, as its own tests run it on
    the CPU; "pads" is the candidate axis as finish_candidates ranks it
    (scores >= 0, then -1 for every pad slot).  No -0.0 here: XLA's top_k
    ranks it below +0.0, where the port's contract ties the two (the
    tests against the port's topk_exact hold that)."""
    rng = np.random.default_rng(tile + k)
    n = 3 * tile + 77 if tile < 1024 else 2500
    if data == "distinct":
        x = rng.random((3, n)).astype(np.float32)
    elif data == "few levels":
        x = (rng.integers(0, 4, (3, n)) / 7).astype(np.float32)
    elif data == "zeros":
        x = np.zeros((3, n), np.float32)
    elif data == "few positive":
        x = np.zeros((3, n), np.float32)
        for r in range(3):
            x[r, rng.choice(n, 3, replace=False)] = rng.random(3) + 1
    else:
        x = (rng.integers(0, 3, (3, n)) / 3).astype(np.float32)
        x[:, n // 3:] = -1.0
        x[2, 5:] = -1.0
    want = j_topk(jnp.asarray(x), k)
    assert_same(tiled_topk(x, k, tile), want)
    assert_same(tiled_topk(x, k, tile, short=4, threads=8, lanes=4), want)
    assert_same(tilewise_by_keys(x, k, tile), want)
    assert_same(topk_exact(torch.from_numpy(x), k), want)


def test_all_of_one_value_takes_the_shortcut_and_the_smallest_indices():
    """A row of zeros: every tile's k are its first k indices, the row's
    the first k of the row; -0.0 and +0.0 tie and keep their bits."""
    x = np.zeros((2, 300), np.float32)
    x[1, ::2] = -0.0
    v, i = tiled_topk(x, 10, 64)
    assert i.tolist() == [list(range(10))] * 2
    assert np.signbit(v[1]).tolist() == [True, False] * 5
