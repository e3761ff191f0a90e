"""edismax's composition rounded as the JAX package rounds it.

``ops/kernels.py:compose_plain`` (K11's plain version) against the JAX
package's compiled composers on numpy-seeded stacks, bit for bit:
``searcharray_tpu/solr.py:_compose_tc_jit`` (the field sum a chain of
fused multiply-adds, the tie fold one), ``_compose_fc_jit`` (the fold
one fused multiply-add, every other op one rounding) and both branches of
``_compose_batch_jit`` (under ``lax.map``: the term-centric field sum one
rounding per add).  Then ``edismax`` and ``edismax_batch`` of both
packages on a zipf frame, term- and field-centric, with ``tie=0.1`` and
``title^2`` (where the per-op composition of earlier versions differed
in the last bit) and ``tie=0``, bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import searcharray_tpu as jpkg
import searcharray_tpu.solr as jsolr
import searcharray_tpu_torch as tpkg
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.ops.cuda import roofline
from test_torch_solr import frames, zipf_docs

BOOSTS = [1.3, 0.7, 2.9]
N = 20_000


def stacks_for(rng, Ts, n=N):
    out = []
    for T in Ts:
        s = rng.gamma(1.5, 2.0, size=(T, n)).astype(np.float32)
        s[rng.random((T, n)) < 0.5] = 0
        out.append(s)
    return out


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def plain(stacks, boosts, tie, msm, **kw):
    return K.compose_plain([torch.from_numpy(s) for s in stacks], boosts,
                           tie, msm, **kw).numpy()


@pytest.mark.parametrize("F", [1, 2, 3])
@pytest.mark.parametrize("tie", [0.0, 0.1])
@pytest.mark.parametrize("msm", [1, 3])
def test_term_centric_matches_the_jax_program(F, tie, msm):
    rng = np.random.default_rng(100 * F + msm)
    st = stacks_for(rng, [4] * F)
    want = np.asarray(jsolr._compose_tc_jit(F, tie, msm)(
        tuple(jnp.asarray(s) for s in st), jnp.asarray(BOOSTS[:F],
                                                       jnp.float32)))
    got = plain(st, BOOSTS[:F], tie, msm, term_centric=True)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert (want == 0).any() and (want > 0).any()
    if F > 1 and tie:
        # the JAX program's field sum is the fused chain: the per-add
        # form of its batch program differs from it in the last bit
        per_add = plain(st, BOOSTS[:F], tie, msm, term_centric=True,
                        chain=False)
        assert (bits(per_add) != bits(want)).sum() > 0


@pytest.mark.parametrize("Ts", [(4,), (4, 3), (4, 2, 3), (3, 0)])
@pytest.mark.parametrize("tie", [0.0, 0.1])
@pytest.mark.parametrize("mask", [False, True])
def test_field_centric_matches_the_jax_program(Ts, tie, mask):
    rng = np.random.default_rng(len(Ts) * 7 + int(mask))
    st = stacks_for(rng, Ts)
    msms = tuple(min(2, t) if mask else min(1, t) for t in Ts)
    F = len(Ts)
    want = np.asarray(jsolr._compose_fc_jit(F, tie, msms)(
        tuple(jnp.asarray(s) for s in st), jnp.asarray(BOOSTS[:F],
                                                       jnp.float32)))
    got = plain(st, BOOSTS[:F], tie, msms, term_centric=False)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("kind", ["tc", "fc"])
@pytest.mark.parametrize("F", [1, 2, 3])
@pytest.mark.parametrize("tie", [0.0, 0.1])
def test_batch_program_matches_on_row_views(kind, F, tie):
    """``_compose_batch_jit`` slices each query's rows out of shared
    stacks; ``compose_plain`` takes the same rows as strided views."""
    rng = np.random.default_rng(F * 11 + (kind == "tc"))
    n, Cp, T = 5_000, 4, 3
    Ts = (3, 2, 4)[:F]
    big = stacks_for(rng, [12] * F, n)
    starts = rng.integers(0, 8, size=(Cp, F)).astype(np.int32)
    ckey = (("tc", T, 2) if kind == "tc"
            else ("fc", Ts, tuple(min(2, t) for t in Ts)))
    want = np.asarray(jsolr._compose_batch_jit(n, F, ckey, tie, Cp)(
        tuple(jnp.asarray(s) for s in big), jnp.asarray(starts),
        jnp.asarray(BOOSTS[:F], jnp.float32)))
    views = [torch.from_numpy(s) for s in big]
    for c in range(Cp):
        rows = [views[f][starts[c, f]: starts[c, f] + (T if kind == "tc"
                                                       else Ts[f])]
                for f in range(F)]
        got = K.compose_plain(rows, BOOSTS[:F], tie, ckey[2],
                              term_centric=kind == "tc", chain=False)
        np.testing.assert_array_equal(bits(got.numpy()), bits(want[c]))
        if kind == "tc" and F > 1 and tie:
            chained = K.compose_plain(rows, BOOSTS[:F], tie, ckey[2],
                                      term_centric=True)
            assert (bits(chained.numpy()) != bits(want[c])).sum() > 0


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    st = [torch.from_numpy(s) for s in stacks_for(rng, [3, 3], 1000)]
    before = kc.compose.launches
    out = torch.empty(1000)
    got = K.compose_device(st, [2.0, 1.0], 0.1, 2, term_centric=True,
                           out=out)
    assert got is out and kc.compose.launches == before
    np.testing.assert_array_equal(
        got.numpy(), K.compose_plain(st, [2.0, 1.0], 0.1, 2,
                                     term_centric=True).numpy())
    with pytest.raises(ValueError, match="one term count"):
        kc.compose([st[0], st[1][:2]], [1.0, 1.0], 0.0, 1,
                   term_centric=True)
    with pytest.raises(ValueError, match="one msm per field"):
        kc.compose(st, [1.0, 1.0], 0.0, [1], term_centric=False)
    with pytest.raises(ValueError, match="fields"):
        kc.compose(st * 9, [1.0] * 18, 0.0, 1, term_centric=True)
    with pytest.raises(ValueError, match="no K11 kernel"):
        kc.compose([s.to("meta") for s in st], [1.0, 1.0], 0.0, 1,
                   term_centric=True)


def test_k11_work():
    w = roofline.k11_work([4, 4], 1_000_000)
    assert w["bytes"] == 4 * 8 * 1_000_000 + 4 * 1_000_000
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(36e6 / 3.35e12 * 1e3)


# ---------------------------------------------------------------------------
# edismax and edismax_batch of both packages, bit for bit
# ---------------------------------------------------------------------------
def drop_foo(text):
    """A body analyzer that drops "foo": field-centric for queries with it."""
    return [t for t in text.split() if t != "foo"]


@pytest.fixture(scope="module")
def zipf_frames():
    docs = zipf_docs(seed=29, n=2500)
    tc = frames({"title": (docs, None), "body": (list(reversed(docs)), None)})
    fc = frames({"title": (docs, None),
                 "body": (list(reversed(docs)), drop_foo)})
    return {"tc": tc, "fc": fc}


QUERIES = ["foo bar", "foo bar baz", "qux", "w5 w9 foo", "bar baz qux w3",
           "w1 w2 w3 w4 w5", "zzz_nomatch qux"]
CASES = {
    "tie_title2": dict(qf=["title^2", "body"], tie=0.1),
    "tie_three_boosts": dict(qf=["title^1.3", "body^0.7"], tie=0.3,
                             mm="2<75%"),
    "no_tie": dict(qf=["title^2", "body"]),
    "tie_mm": dict(qf=["title", "body^2"], tie=0.1, mm="2"),
}


@pytest.mark.parametrize("mode", ["tc", "fc"])
@pytest.mark.parametrize("case", list(CASES))
def test_edismax_is_bit_equal_to_jax(zipf_frames, mode, case):
    jf, tf = zipf_frames[mode]
    kw = CASES[case]
    for q in QUERIES:
        want, wexp = jpkg.edismax(jf, q, **kw)
        got, gexp = tpkg.edismax(tf, q, **kw)
        assert gexp == wexp
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=q)
    if mode == "fc":
        assert "~" in wexp and "|" in wexp and "(title:" not in wexp[:2]


@pytest.mark.parametrize("mode", ["tc", "fc"])
@pytest.mark.parametrize("case", list(CASES))
def test_edismax_batch_is_bit_equal_to_jax(zipf_frames, mode, case):
    jf, tf = zipf_frames[mode]
    kw = CASES[case]
    want, wexp = jpkg.edismax_batch(jf, QUERIES, **kw)
    got, gexp = tpkg.edismax_batch(tf, QUERIES, **kw)
    assert gexp == wexp
    np.testing.assert_array_equal(bits(got), bits(want))
    (ts, ti), _ = tpkg.edismax_batch(tf, QUERIES, top_k=10, **kw)
    (js, ji), _ = jpkg.edismax_batch(jf, QUERIES, top_k=10, **kw)
    np.testing.assert_array_equal(bits(ts), bits(js))
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("mode", ["tc", "fc"])
@pytest.mark.parametrize("phases", [
    dict(pf=["title^1.5"], pf3=["body^0.5"]),
    dict(pf2=["body^2"], pf=["title"]),
])
def test_edismax_with_phases_is_bit_equal_to_jax(zipf_frames, mode, phases):
    """The phases add to the composed scores one rounding at a time in
    both packages (eager ops in the JAX package's ``_ngram_phases``, adds
    in its ``_finish_jit``).  Here every field scores one distinct gram a
    query (queries of two or three terms), whose row both packages round
    in the two-FMA form."""
    jf, tf = zipf_frames[mode]
    kw = dict(qf=["title^2", "body"], tie=0.1, **phases)
    for q in [q for q in QUERIES if len(q.split()) <= 3]:
        if "pf2" in phases and len(q.split()) != 2:
            continue
        want, wexp = jpkg.edismax(jf, q, **kw)
        got, gexp = tpkg.edismax(tf, q, **kw)
        assert gexp == wexp
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=q)


PHASES = dict(pf=["title", "body^1.5"], pf2=["body"], pf3=["title^0.25"])


@pytest.mark.parametrize("mode", ["tc", "fc"])
def test_edismax_with_many_grams_differs_only_in_the_gram_rows(zipf_frames,
                                                                mode):
    """Where a field scores two or more distinct grams in one call, the
    JAX package's dense phrase group hoists its length norm out of the
    ``lax.map`` loop (``ROADMAP.md`` Queue 3, PR 11), so its gram rows
    round otherwise than the two-FMA form the port keeps.  There the
    scores agree within rtol 1e-6, and wherever they are not bit-equal
    the packages' gram rows are not either."""
    jf, tf = zipf_frames[mode]
    kw = dict(qf=["title^2", "body"], tie=0.1, **PHASES)
    differed = 0
    for q in QUERIES:
        want, wexp = jpkg.edismax(jf, q, **kw)
        got, gexp = tpkg.edismax(tf, q, **kw)
        assert gexp == wexp
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        if np.array_equal(bits(got), bits(want)):
            continue
        differed += 1
        terms = q.split()
        grams = [terms] + [terms[i: i + 2] for i in range(len(terms) - 1)]
        rows_differ = False
        for field in ("title", "body"):
            jr = np.asarray(jf[field].array.score_batch_device(grams))
            tr = tf[field].array.score_batch_device(grams).numpy()
            np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=0)
            rows_differ |= not np.array_equal(bits(tr), bits(jr))
        assert rows_differ, q
    assert differed   # the case this test is about arises on this frame
