"""The port's similarity arithmetic against exact arithmetic and against the
JAX package.

``ops/kernels.py:fma_f32`` (one rounding of ``a * b + c``) is held to
``fractions.Fraction`` arithmetic rounded to nearest float32, on
hypothesis-drawn float32 triples and on planted exact midpoints and
cancellations.  ``similarity_plain`` (the plain version of K10 and of
K1's epilogue) is held bit for bit to the JAX package's
``search/scoring.py:apply_similarity_device`` jitted with ``avgdl`` a
traced argument, for every BM25 kind, and to ``traced_form``, a numpy
float64 emulation of that form (``denom = fma(k1, fma(b, dl / avgdl,
1 - b), tf)``).  One JAX program is not in that form on every element:
where the doc lengths broadcast over the rows of a [Q, N] block, the
columns past the last full 32-column group of XLA's vector loop take
the length norm as one product computed once per column
(``hoisted_form``: ``tf + fl(k1 * fma(b, x, 1 - b))``); that is the JAX
package's own inconsistency (``ROADMAP.md`` Queue 3), pinned here.  The
port's ``score()`` per kind equals the JAX ``score()`` bit for bit."""
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.search import scoring as jscoring
from searcharray_tpu.search.similarity import (bm25_impact,
                                               bm25_legacy_similarity,
                                               bm25_similarity)
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.search.similarity import (
    bm25_impact as t_bm25_impact, bm25_legacy_similarity as t_legacy,
    bm25_similarity as t_bm25)

F32, F64 = np.float32, np.float64
BM25_KINDS = ["bm25", "bm25_legacy", "bm25_impact"]


# ---------------------------------------------------------------------------
# numpy forms of the similarity (shared with test_torch_fuzz_engines.py)
# ---------------------------------------------------------------------------
def fma32(a, b, c):
    """numpy float64 emulation of a float32 fused multiply-add, rounding to
    odd before the cast (the method of ``fma_f32``, written apart)."""
    a, b, c = (np.asarray(x, F32).astype(F64) for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    move = (e != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(move, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(F32)


def _finish(kind, tf, denom, idf, k1):
    if kind == "bm25":
        return (tf / denom) * idf
    if kind == "bm25_legacy":
        return idf * ((tf * (F32(k1) + F32(1))) / denom)
    return tf / denom


def traced_form(kind, tf, dl, idf, avgdl, k1=1.2, b=0.75):
    """The BM25 family as the JAX package's programs compute it where
    ``avgdl`` is traced: two fused multiply-adds."""
    tf, dl, idf = np.asarray(tf, F32), np.asarray(dl, F32), F32(idf) \
        if np.ndim(idf) == 0 else np.asarray(idf, F32)
    x = dl / F32(avgdl)
    denom = fma32(F32(k1), fma32(F32(b), x, F32(1) - F32(b)), tf)
    return _finish(kind, tf, denom, idf, k1)


def hoisted_form(kind, tf, dl, idf, avgdl, k1=1.2, b=0.75):
    """The length norm as one product, then added to tf: what XLA computes
    where it takes the norm out of a loop or shares it across rows."""
    tf, dl = np.asarray(tf, F32), np.asarray(dl, F32)
    idf = F32(idf) if np.ndim(idf) == 0 else np.asarray(idf, F32)
    x = dl / F32(avgdl)
    norm = F32(k1) * fma32(F32(b), x, F32(1) - F32(b))
    return _finish(kind, tf, tf + norm, idf, k1)


# ---------------------------------------------------------------------------
# fma_f32 against exact arithmetic
# ---------------------------------------------------------------------------
def round_f32(x: Fraction) -> float:
    """Round-to-nearest-even of an exact rational to float32."""
    f = F32(float(x))   # at most one float32 step from the answer
    cands = [np.nextafter(f, F32(-np.inf)), f, np.nextafter(f, F32(np.inf))]
    errs = [abs(Fraction(float(c)) - x) for c in cands]
    best = [c for c, e in zip(cands, errs) if e == min(errs)]
    if len(best) > 1:
        best = [c for c in best if int(c.view(np.int32)) & 1 == 0]
    return float(best[0])


def exact_fma(a, b, c) -> float:
    return round_f32(Fraction(float(a)) * Fraction(float(b))
                     + Fraction(float(c)))


finite32 = st.floats(width=32, allow_nan=False, allow_infinity=False,
                     min_value=-2.0 ** 50, max_value=2.0 ** 50)


@settings(max_examples=400, deadline=None)
@given(finite32, finite32, finite32)
def test_fma_f32_is_correctly_rounded(a, b, c):
    got = K.fma_f32(torch.tensor([a], dtype=torch.float32),
                    torch.tensor([b], dtype=torch.float32),
                    torch.tensor([c], dtype=torch.float32))
    assert float(got[0]) == exact_fma(a, b, c)


@settings(max_examples=200, deadline=None)
@given(finite32, finite32)
def test_fma_f32_cancellation(a, b):
    """c = -fl(a * b): the result is the product's rounding error, exact."""
    c = -float(F32(F32(a) * F32(b)))
    got = K.fma_f32(torch.tensor([a], dtype=torch.float32), float(b),
                    torch.tensor([c], dtype=torch.float32))
    assert float(got[0]) == exact_fma(a, b, c)


def test_fma_f32_midpoints_round_to_even():
    """a * b + c exactly halfway between two float32 values, and a hair
    past it: round to even, and away."""
    rng = np.random.default_rng(3)
    cs = rng.uniform(1, 2, 2000).astype(F32)
    ulp = np.spacing(cs)
    half = ulp.astype(F64) / 2            # a power of two: a * b = half
    a = np.sqrt(half).astype(F32)         # exact for even exponents
    b = (half / a.astype(F64)).astype(F32)
    assert np.all(a.astype(F64) * b.astype(F64) == half)
    got = K.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(cs)).numpy()
    want = [exact_fma(x, y, z) for x, y, z in zip(a, b, cs)]
    np.testing.assert_array_equal(got, np.asarray(want, F32))
    even_down = (cs.view(np.int32) & 1) == 0
    np.testing.assert_array_equal(got[even_down], cs[even_down])
    # a hair above the midpoint: a * b = half * (1 + 2^-20)
    b2 = np.nextafter(b, F32(np.inf))
    got2 = K.fma_f32(torch.from_numpy(a), torch.from_numpy(b2),
                     torch.from_numpy(cs)).numpy()
    np.testing.assert_array_equal(got2, cs + ulp)
    assert np.array_equal(fma32(a, b, cs), got)
    assert np.array_equal(fma32(a, b2, cs), got2)


def test_sqrt_f32_is_correctly_rounded():
    """Every integer below 2^18 (doc lengths, tfs) and random float32
    values over the exponent range, against numpy's float64 root rounded
    once to float32 (a float32 root from a correctly rounded float64 one
    is correctly rounded)."""
    rng = np.random.default_rng(9)
    x = np.concatenate([np.arange(1 << 18, dtype=F32),
                        rng.uniform(0, 3e38, 100_000).astype(F32),
                        np.exp2(rng.uniform(-149, 127, 100_000)).astype(F32)])
    got = K.sqrt_f32(torch.from_numpy(x)).numpy()
    want = np.sqrt(x.astype(F64)).astype(F32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert float(K.sqrt_f32(torch.tensor([267.0]))[0]) == float(
        np.sqrt(F64(267)).astype(F32))


def test_fma_f32_scalars_and_broadcast():
    x = torch.tensor([[1.5, 2.25], [3.0, -0.5]], dtype=torch.float32)
    got = K.fma_f32(0.75, x, torch.tensor([0.25, 1.0]))
    want = torch.tensor([[1.375, 2.6875], [2.5, 0.625]])
    assert torch.equal(got, want) and got.dtype == torch.float32


# ---------------------------------------------------------------------------
# similarity_plain against the JAX package's jitted similarity
# ---------------------------------------------------------------------------
def jax_similarity(kind, tf, dl, idf, avgdl, k1=1.2, b=0.75):
    fn = jax.jit(lambda t, d, i, a: jscoring.apply_similarity_device(
        kind, t, d, i, a, k1, b))
    return np.asarray(fn(tf, dl, idf, F32(avgdl)))


def sim_inputs(seed, shape, per_row_idf, full_lens):
    rng = np.random.default_rng(seed)
    tf = rng.integers(0, 12, shape).astype(F32)
    n = shape[-1]
    dl = rng.integers(1, 300, shape if full_lens else n).astype(F32)
    if len(shape) == 2 and not full_lens:
        dl = dl[None, :]
    idf = (rng.uniform(0.1, 9, (shape[0], 1)).astype(F32) if per_row_idf
           else F32(rng.uniform(0.1, 9)))
    return tf, dl, idf, F32(rng.uniform(3, 90))


def t_sim(kind, tf, dl, idf, avgdl):
    idf_t = torch.from_numpy(idf) if np.ndim(idf) else float(idf)
    return K.similarity_plain(kind, torch.from_numpy(tf),
                              torch.from_numpy(np.ascontiguousarray(dl)),
                              idf_t, avgdl, 1.2, 0.75).numpy()


@pytest.mark.parametrize("kind", BM25_KINDS)
@pytest.mark.parametrize("shape,per_row_idf,full_lens", [
    ((1500,), False, False), ((7, 1500), True, True),
    ((5, 333), False, True), ((3, 4096), True, False),
    ((9, 2048), False, False)])
def test_similarity_plain_equals_jax_jitted(kind, shape, per_row_idf,
                                            full_lens):
    tf, dl, idf, avgdl = sim_inputs(len(shape) + shape[-1], shape,
                                    per_row_idf, full_lens)
    got = t_sim(kind, tf, dl, idf, avgdl)
    want = jax_similarity(kind, tf, dl, idf, avgdl)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32),
        traced_form(kind, tf, dl, idf, avgdl).view(np.int32))
    # the per-op form differs: the test would see a wrong rounding
    x = dl / avgdl
    perop = _finish(kind, tf, tf + F32(1.2) * (F32(0.25) + F32(0.75) * x),
                    idf, 1.2)
    assert (perop != got).any()


@pytest.mark.parametrize("kind", BM25_KINDS)
def test_jax_broadcast_lengths_round_the_vector_tail_otherwise(kind):
    """The JAX package's own inconsistency: lengths broadcast over the rows
    of a [Q, N] block, N = 1500.  XLA's vector loop covers 1472 columns in
    the two-FMA form; the last 28 columns round otherwise (the hoisted
    form for bm25 and impact; legacy's tail matches no one form).  The
    port takes the two-FMA form on every column, so there it is compared
    within rtol 1e-6."""
    tf, dl, idf, avgdl = sim_inputs(11, (7, 1500), True, False)
    got = t_sim(kind, tf, dl, idf, avgdl)
    want = jax_similarity(kind, tf, dl, idf, avgdl)
    head = 1500 // 32 * 32
    np.testing.assert_array_equal(got[:, :head], want[:, :head])
    if kind != "bm25_legacy":
        np.testing.assert_array_equal(
            want[:, head:], hoisted_form(kind, tf, dl, idf, avgdl)[:, head:])
    np.testing.assert_array_equal(got, traced_form(kind, tf, dl, idf, avgdl))
    assert (got[:, head:] != want[:, head:]).any()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_classic_is_the_multi_query_form():
    tf, dl, idf, _ = sim_inputs(5, (4, 700), True, True)
    got = t_sim("classic", tf, dl, idf, 1.0)

    def r32(x):   # one float32 rounding of a float64 result: for + - * /
        return np.asarray(x, F64).astype(F32)   # and sqrt that is exact

    num = r32(idf.astype(F64) * r32(np.sqrt(tf.astype(F64))))
    want = r32(num.astype(F64) / r32(np.sqrt(dl.astype(F64))))
    np.testing.assert_array_equal(got, want)


def test_similarity_wrapper_shapes_on_the_cpu():
    """K10's wrapper on CPU tensors: a strided [Q, N] view, [N] lengths or
    a [1, N] view of them, [Q, N] lengths, scalar or per-row idf, out= in
    place, kind none untouched; the plain version's result each time."""
    from searcharray_tpu_torch.ops.cuda import score as kc

    rng = np.random.default_rng(8)
    big = torch.from_numpy(rng.integers(0, 9, (5, 40)).astype(F32))
    tf = big[:, :33]
    dl = torch.from_numpy(rng.integers(1, 50, 33).astype(F32))
    idf = torch.from_numpy(rng.uniform(1, 3, 5).astype(F32))
    want = K.similarity_plain("bm25", tf, dl[None, :], idf[:, None], 7.5,
                              1.2, 0.75)
    for lens in (dl, dl[None, :]):
        for i in (idf, idf[:, None]):
            got = kc.similarity("bm25", tf, lens, i, 7.5, 1.2, 0.75)
            assert torch.equal(got, want) and got.is_contiguous()
    full = dl[None, :].expand(5, 33).contiguous()
    assert torch.equal(kc.similarity("bm25", tf, full, idf, 7.5, 1.2, 0.75),
                       want)
    own = tf.contiguous()
    assert kc.similarity("bm25", own, dl, idf, 7.5, 1.2, 0.75,
                         out=own) is own
    assert torch.equal(own, want)
    assert K.apply_similarity_device("none", tf, dl, 1.0, 7.5, 1.2,
                                     0.75) is tf
    with pytest.raises(ValueError):
        kc.similarity("bm25", tf, dl[:5], idf, 7.5, 1.2, 0.75)
    with pytest.raises(ValueError):
        kc.similarity("nosuch", tf, dl, idf, 7.5, 1.2, 0.75)


# ---------------------------------------------------------------------------
# score() per kind against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(1234)
    vocab = [f"t{i}" for i in range(120)]
    p = 1.0 / np.arange(1, 121) ** 1.1
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 60),
                                p=p / p.sum())) for _ in range(1500)]
    return JSearchArray.index(docs), SearchArray.index(docs, device="cpu")


SIMS = {"bm25": (bm25_similarity, t_bm25),
        "bm25_legacy": (bm25_legacy_similarity, t_legacy),
        "bm25_impact": (bm25_impact, t_bm25_impact)}


@pytest.mark.parametrize("kind", BM25_KINDS)
@pytest.mark.parametrize("query,slop", [
    ("t0", 0), ("t7", 0), ("t55", 0), (["t0", "t1"], 0), (["t2", "t0"], 2),
    (["t1", "t3", "t0"], 0), (["t0", "t0"], 1)])
def test_score_equals_jax_bit_for_bit(both, kind, query, slop):
    jarr, tarr = both
    jsim, tsim = SIMS[kind]
    want = np.asarray(jarr.score(query, similarity=jsim(), slop=slop))
    got = np.asarray(tarr.score(query, similarity=tsim(), slop=slop))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # windowed: the JAX package's term program and the sparse chain
    want = np.asarray(jarr.score(query, similarity=jsim(), min_posn=0,
                                 max_posn=35))
    got = np.asarray(tarr.score(query, similarity=tsim(), min_posn=0,
                                max_posn=35))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
