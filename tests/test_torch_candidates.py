"""Port parity for the candidate-subset engine: K8a's and K8b's plain
versions (``ops/kernels.py:compact_rows_plain`` and
``minis_for_rows_plain``) against the JAX package's ``_compact_rows``,
``cterm_body`` and ``minis_for_rows`` on seeded posting slices, under both
of its mini alignments; the routing of ``_classify`` against the JAX
package's; ``score_batch`` (dense, ranked, deduplicated, with slop) and
``score_batch_device`` on the corpus of tests/test_candidates.py with the
engine forced on in both packages, indices equal to the JAX candidate
path's, zero tail included; and ``score_batch_device(rows=)``.  Both
packages are forced by patching the same constants."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu.search import batch as jbatch
from searcharray_tpu.search import candidates as jcand
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.search import batch
from searcharray_tpu_torch.search import candidates as cand
from searcharray_tpu_torch.search import dense
from test_torch_slop import carried_pair

TOL = dict(rtol=1e-6, atol=1e-6)


def candidate_docs():
    """The corpus of tests/test_candidates.py."""
    rng = np.random.default_rng(21)
    vocab = ["hot1", "hot2", "hot3"] + [f"r{i}" for i in range(300)]
    probs = np.concatenate([[0.25, 0.2, 0.15], np.full(300, 0.4 / 300)])
    corpus = [" ".join(rng.choice(vocab, size=rng.integers(6, 50), p=probs))
              for _ in range(4000)]
    corpus.append("r0 hot1 r0 hot1 r0")
    corpus.append("r1 r2 r3 r1 r2 r3")
    corpus.append("")
    return corpus


QUERIES = [
    "r0", "r17", ["r0", "hot1"], ["hot1", "r0"], ["r1", "r2", "r3"],
    ["r0", "r0"], ["r1", "r2", "r3", "r1"], "nosuchterm",
    ["r0", "nosuchterm"],
]
SLOP_QUERIES = [["r0", "hot1"], ["r1", "r2", "r3"], ["r0", "r0"],
                ["r1", "r2", "r3", "r1"], "r17", ["r0", "nosuchterm"]]


@pytest.fixture(scope="module")
def pair():
    return carried_pair(candidate_docs())


_JAX: dict = {}   # the JAX package's results, per (mode, call)
_SEARCHSORTED_CACHE: dict = {}


def jax_once(mode, what, fn):
    key = (mode, what)
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


@pytest.fixture(params=["mini", "mixed", "searchsorted"])
def forced(request, monkeypatch):
    """The engine forced on in both packages (CAND_MAX_FRAC = 0 lifts the
    selectivity gate that the 4096-row buffer floor trips on this small
    corpus); "mixed" makes the hot terms pool sources, "searchsorted" sets
    the JAX package's other alignment (the port has one)."""
    for mod in (jcand, cand):
        monkeypatch.setattr(mod, "CAND_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "CAND_TERM_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "CAND_MAX_FRAC", 0)
        if request.param == "mixed":
            monkeypatch.setattr(mod, "MINI_MAX_WORDS", 2048)
    if request.param == "searchsorted":
        # group programs are cached by a key that does not name the
        # alignment: this mode traces its own, into a cache of its own
        monkeypatch.setattr(jcand, "use_imap", lambda *a: False)
        monkeypatch.setattr(jbatch, "_group_cache", _SEARCHSORTED_CACHE)
    return request.param


def resolve(arr, queries):
    return [arr._resolve_tids(q) for q in queries]


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's bodies
# ---------------------------------------------------------------------------
def posting_planes(seed, sizes, num_docs, blk_bits, tail=1 << 16):
    """Doc-sorted slices of unique headers (``sizes`` words each) laid end
    to end, with a PAD tail: (hdrs int32, pays int32, offsets).  Half the
    words of every slice after the first lie in the first slice's docs."""
    rng = np.random.default_rng(seed)
    S = 1 << blk_bits
    hdrs, pays, offs = [], [], []
    at = 0
    for n in sizes:
        near = np.asarray([], np.int64)
        if hdrs and len(hdrs[0]):
            docs0 = np.unique(hdrs[0] >> blk_bits)
            near = np.unique(rng.choice(docs0, n // 2) * S
                             + rng.integers(0, S, n // 2))
        rest = np.setdiff1d(np.arange(num_docs * S), near)
        flat = np.sort(np.concatenate([near, rng.choice(
            rest, size=n - len(near), replace=False)]))
        hdrs.append(flat.astype(np.int32))
        pays.append(rng.integers(1, 1 << 18, n).astype(np.int32))
        offs.append(at)
        at += n
    hdrs.append(np.full(tail, K.PAD_HDR32, np.int32))
    pays.append(np.zeros(tail, np.int32))
    return np.concatenate(hdrs), np.concatenate(pays), offs


@pytest.mark.parametrize("n,num_docs,Kc", [
    (0, 100, 4096), (1, 100, 4096), (2047, 600, 4096), (2049, 600, 4096),
    (5000, 1200, 16384), (20000, 9000, 65536), (300, 400, 8)])
def test_compact_rows_plain_matches_jax(n, num_docs, Kc):
    bb = 3
    h, p, offs = posting_planes(n + num_docs, [n], num_docs, bb)
    bucket = K.expand_bucket_of(max(1, n))
    static = {"N": num_docs, "blk_bits": bb}
    jtf, jrows = jcand.cterm_body(static, Kc, bucket, jnp.asarray(h),
                                  jnp.asarray(p.view(np.uint32)), 0, n)
    hb, pb = h[:bucket], p[:bucket]
    valid = np.arange(bucket) < n
    keys = np.where(valid, hb, K.PAD_HDR32) >> bb
    j2rows, jcidx, _nv = jcand._compact_rows(jnp.asarray(keys),
                                             jnp.asarray(valid), Kc,
                                             num_docs)
    rows, cidx, tf = K.compact_rows_plain(
        torch.from_numpy(keys), torch.from_numpy(valid), Kc, num_docs,
        K.popcount_i32(torch.from_numpy(np.where(valid, pb, 0))))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j2rows))
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(jcidx))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jtf))
    # the K8a wrapper on the CPU: the exact slice, one query of a chunk
    th, tp = torch.from_numpy(h), torch.from_numpy(p)
    before = kc_launches()
    wr, wt = kc.cand_rows(th, tp, [0, 0], [n, n], Kc, num_docs=num_docs,
                          blk_bits=bb)
    assert kc_launches() == before   # the plain version launches nothing
    np.testing.assert_array_equal(wr.numpy(), np.stack([rows.numpy()] * 2))
    np.testing.assert_array_equal(wt.numpy(), np.stack([tf.numpy()] * 2))
    r0, none = kc.cand_rows(th, tp, [0], [n], Kc, num_docs=num_docs,
                            blk_bits=bb, with_tf=False)
    assert none is None and torch.equal(r0[0], rows)


def kc_launches():
    return kc.cand_rows.launches + kc.cand_minis.launches


@pytest.mark.parametrize("imap_frac", [256, 1])
@pytest.mark.parametrize("sizes,srcs", [
    ((300, 5000, 900), ("mini", "pool", "mini")),
    ((40, 2000, 7000, 1), ("mini", "mini", "pool", "pool")),
    ((1, 3000), ("mini", "mini")),
    ((2500, 2600), ("pool", "mini"))])
def test_minis_plain_match_jax(sizes, srcs, imap_frac, monkeypatch):
    """Term 0 is the rows source; the JAX package aligns the mini terms
    by its doc -> candidate map (imap_frac 256) or by searchsorted."""
    monkeypatch.setattr(jcand, "ALIGN_IMAP_FRAC", imap_frac)
    num_docs, bb = 20000, 3
    S = 1 << bb
    h, p, offs = posting_planes(sum(sizes), sizes, num_docs, bb)
    T = len(sizes)
    Kc = K.expand_bucket_of(sizes[0])
    rows, _ = kc.cand_rows(torch.from_numpy(h), torch.from_numpy(p),
                           [offs[0]], [sizes[0]], Kc, num_docs=num_docs,
                           blk_bits=bb, with_tf=False)
    pool_is = [i for i in range(T) if srcs[i] == "pool"]
    pool = np.zeros((len(pool_is) + 1, num_docs * S), np.int32)
    for j, i in enumerate(pool_is):
        pool[j + 1, h[offs[i]: offs[i] + sizes[i]]] = p[offs[i]:
                                                        offs[i] + sizes[i]]
    mini_is = [i for i in range(T) if srcs[i] != "pool"]
    mb = max(K.expand_bucket_of(sizes[i]) for i in mini_is)
    jsrcs = tuple("pool" if s == "pool" else mb for s in srcs)
    assert jcand.use_imap(num_docs, jsrcs) == (imap_frac == 256)
    jminis = jcand.minis_for_rows(
        {"N": num_docs, "blk_bits": bb}, T, jsrcs, Kc,
        jnp.asarray(rows[0].numpy()), jnp.asarray(h),
        jnp.asarray(p.view(np.uint32)), jnp.asarray(pool.view(np.uint32)),
        [offs[i] for i in mini_is], [sizes[i] for i in mini_is],
        [j + 1 for j in range(len(pool_is))])
    slots = [[pool_is.index(i) + 1 if i in pool_is else -1
              for i in range(T)]]
    got = K.minis_for_rows_plain(
        rows, slots, [offs], [sizes], pool=torch.from_numpy(pool),
        hdrs=torch.from_numpy(h), pays=torch.from_numpy(p),
        num_docs=num_docs, blk_bits=bb)
    valid = np.repeat(rows[0].numpy() < num_docs, S)
    assert valid.sum() > 0 and (~valid).sum() > 0   # pads too
    for i in range(T):
        want = np.asarray(jminis[i]).view(np.int32)
        np.testing.assert_array_equal(got[i].numpy()[valid], want[valid])
        assert got[i].numpy()[valid].any() or sizes[i] == 1
    # the K8b wrapper on the CPU, one table for all queries
    again = kc.cand_minis(rows[0], slots * 2, [offs] * 2, [sizes] * 2,
                          pool=torch.from_numpy(pool),
                          hdrs=torch.from_numpy(h), pays=torch.from_numpy(p),
                          num_docs=num_docs, blk_bits=bb)
    assert torch.equal(again, torch.cat([got, got]))


def test_k8_wrappers_reject_bad_requests():
    h, p, offs = posting_planes(3, [50], 100, 3)
    th, tp = torch.from_numpy(h), torch.from_numpy(p)
    with pytest.raises(ValueError, match="runs past"):
        kc.cand_rows(th, tp, [len(h) - 10], [50], 64, num_docs=100,
                     blk_bits=3)
    rows, _ = kc.cand_rows(th, tp, [0], [50], 64, num_docs=100,
                           blk_bits=3)
    with pytest.raises(ValueError, match="pool"):
        kc.cand_minis(rows, [[0]], [[0]], [[50]], pool=None, hdrs=th,
                      pays=tp, num_docs=100, blk_bits=3)
    with pytest.raises(ValueError, match="one row table"):
        kc.cand_minis(rows, [[-1], [-1]], [[0], [0]], [[50], [50]],
                      pool=None, hdrs=th, pays=tp, num_docs=100, blk_bits=3)
    with pytest.raises(ValueError, match="int32"):
        kc.cand_minis(rows.long(), [[-1]], [[0]], [[50]], pool=None,
                      hdrs=th, pays=tp, num_docs=100, blk_bits=3)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def kinds(groups, fallback=()):
    """query index -> its group's key (candidate groups, whose keys the
    two packages share) or kind."""
    out = {}
    for gkey, grows in groups.items():
        for r in grows:
            out[r[0]] = gkey if gkey[0][0] == "c" else gkey[0]
    for fb in fallback:
        out[fb[0]] = "span"
    return out


def clear_hits(*devs):
    for d in devs:
        d.phrase_hits.clear()


@pytest.mark.parametrize("slop", [0, 1, 4])
def test_routing_matches_jax(pair, forced, slop):
    jarr, tarr = pair
    tids = resolve(tarr, QUERIES)
    clear_hits(jarr.dev, tarr.dev.maps)
    jg, _zero, jfb = jbatch._classify(jarr.dev, tids, "bm25",
                                      allow_candidates=True, slop=slop)
    tg = batch._classify(tarr.dev, tids, "bm25", slop=slop,
                         allow_candidates=True)
    want = kinds(jg, jfb)
    assert kinds(tg) == want
    assert {k if isinstance(k, str) else k[0] for k in want.values()} == (
        {"cterm", "cspan" if slop else "cphrase"})
    ptid = tids[2]   # ["r0", "hot1"]
    gkey = kinds(tg)[2]
    assert ("pool" in gkey[4 if slop == 0 else 5]) == (forced == "mixed")
    # a ranked call larger than the buffer keeps every query off
    tg = batch._classify(tarr.dev, [ptid], "bm25", slop=slop,
                         allow_candidates=True, top_k=1 << 20)
    jg, _, _ = jbatch._classify(jarr.dev, [ptid], "bm25", slop=slop,
                                allow_candidates=True, top_k=1 << 20)
    assert kinds(tg) == kinds(jg) and kinds(tg)[0][0] == "d"
    clear_hits(jarr.dev, tarr.dev.maps)


def test_routing_unforced_and_before_promotion(pair):
    """At the default thresholds this corpus is too small for the engine;
    forced on, an eligible phrase is a candidate before the phrase-tf
    cache could promote it (the JAX package's order)."""
    jarr, tarr = pair
    tids = resolve(tarr, QUERIES)
    for slop in (0, 2):
        clear_hits(jarr.dev, tarr.dev.maps)
        jg, _, jfb = jbatch._classify(jarr.dev, tids, "bm25",
                                      allow_candidates=True, slop=slop)
        tg = batch._classify(tarr.dev, tids, "bm25", slop=slop,
                             allow_candidates=True)
        assert kinds(tg) == kinds(jg, jfb)
        assert not any(isinstance(k, tuple) for k in kinds(tg).values())
    clear_hits(jarr.dev, tarr.dev.maps)
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jcand, cand):
            mp.setattr(mod, "CAND_MIN_DOCS", 0)
            mp.setattr(mod, "CAND_MAX_FRAC", 0)
        for _ in range(3):   # hits enough to promote, were it dense
            tg = batch._classify(tarr.dev, [tids[2]], "bm25",
                                 allow_candidates=True)
            jg, _, _ = jbatch._classify(jarr.dev, [tids[2]], "bm25",
                                        allow_candidates=True)
            assert kinds(tg) == kinds(jg) and kinds(tg)[0][0] == "cphrase"
        assert not tarr.dev.maps.phrase_hits and not jarr.dev.phrase_hits
        # terms keep their own threshold
        assert batch._classify(tarr.dev, [tids[0]], "bm25",
                               allow_candidates=True).keys() == {("dterm",)}
    finally:
        mp.undo()
    clear_hits(jarr.dev, tarr.dev.maps)


BETWEEN_DOCS = (1 << 16) + 1000   # past the JAX package's term threshold
RARE_AT = (70, 4000, 60000)


def test_default_thresholds_route_rare_terms_apart_from_jax():
    """The one routing difference from the JAX package, at the default
    thresholds: on a corpus between its term threshold (2^16 docs) and the
    port's, it takes a rare term to ``cterm`` and the port to the
    full-corpus ``dterm`` group.  The scores agree; past the term's three
    matches the JAX package repeats its fallback doc (the doc after the
    last candidate) and the port lists the smallest-index zero-score
    docs."""
    assert (jcand.CAND_TERM_MIN_DOCS <= BETWEEN_DOCS
            < cand.CAND_TERM_MIN_DOCS)
    assert jcand.CAND_MIN_DOCS < cand.CAND_MIN_DOCS
    rng = np.random.default_rng(5)
    docs = [" ".join(rng.choice(["a", "b", "c", "d"], size=3))
            for _ in range(BETWEEN_DOCS)]
    for d in RARE_AT:
        docs[d] += " rare"
    jarr, tarr = carried_pair(docs)
    tids = resolve(tarr, ["rare"])
    jg, _, jfb = jbatch._classify(jarr.dev, tids, "bm25",
                                  allow_candidates=True, top_k=10)
    tg = batch._classify(tarr.dev, tids, "bm25", allow_candidates=True,
                         top_k=10)
    assert kinds(jg, jfb)[0][0] == "cterm" and kinds(tg)[0] == "dterm"
    ws, wi = jarr.score_batch(["rare"], top_k=10)
    gs, gi = tarr.score_batch(["rare"], top_k=10)
    np.testing.assert_allclose(gs, ws, **TOL)
    assert (gs[0, :3] > 0).all() and (gs[0, 3:] == 0).all()
    np.testing.assert_array_equal(gi[0, :3], wi[0, :3])
    assert sorted(gi[0, :3]) == list(RARE_AT)
    np.testing.assert_array_equal(wi[0, 3:], [RARE_AT[-1] + 1] * 7)
    np.testing.assert_array_equal(gi[0, 3:], np.arange(7))


def test_eligibility_matches_jax(pair, monkeypatch):
    jarr, tarr = pair
    for mod in (jcand, cand):
        monkeypatch.setattr(mod, "CAND_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "CAND_TERM_MIN_DOCS", 0)
    for q in ["r0", "hot1", "r17", "hot3"]:
        t = tarr._resolve_tids(q)[0]
        for top_k in (None, 5, 4097):
            assert cand.eligible_term(tarr.dev, t, top_k) == \
                jcand.eligible_term(jarr.dev, t, top_k)
        assert cand.kc_bucket(tarr.dev, t) == jcand.kc_bucket(jarr.dev, t)
    for q in QUERIES[2:7]:
        t = tarr._resolve_tids(q)
        assert cand.eligible_phrase(tarr.dev, t, 10) == \
            jcand.eligible_phrase(jarr.dev, t, 10)
        lens = [tarr.dev.term_span(x)[1] for x in t]
        assert cand.query_sources(tarr.dev, lens) == \
            jcand.query_sources(jarr.dev, lens)
        assert cand.rows_source(tarr.dev, t) == jcand.rows_source(jarr.dev, t)


# ---------------------------------------------------------------------------
# scoring on the forced engine.  Each JAX call compiles its group programs
# (seconds each), so every test of a mode reads the same few calls
# ---------------------------------------------------------------------------
# QUERIES, then repeats of three of them (the batch scores each once and
# fans the results back out)
BATCH = QUERIES + ["r0", ["r0", "hot1"], "r17"]
REPEATS = [(9, 0), (10, 2), (11, 1)]
SLOP_BATCH = SLOP_QUERIES + SLOP_QUERIES
SLOPS = [1] * len(SLOP_QUERIES) + [4] * len(SLOP_QUERIES)


def jax_dense(jarr, mode):
    return jax_once(mode, "dense", lambda: jarr.score_batch(BATCH))


def jax_ranked(jarr, mode, k=5):
    return jax_once(mode, ("top", k),
                    lambda: jarr.score_batch(BATCH, top_k=k))


def test_dense_scores_match_jax(pair, forced):
    jarr, tarr = pair
    got = tarr.score_batch(BATCH)
    np.testing.assert_allclose(got, jax_dense(jarr, forced), **TOL)
    assert (got > 0).any(axis=1).sum() >= 6


def test_ranked_results_match_jax_index_for_index(pair, forced):
    jarr, tarr = pair
    ws, wi = jax_ranked(jarr, forced)
    gs, gi = tarr.score_batch(BATCH, top_k=5)
    np.testing.assert_allclose(gs, ws, **TOL)
    np.testing.assert_array_equal(gi, wi)   # the zero tail too
    collect = tarr.score_batch(BATCH, top_k=5, block=False)
    ds, di = collect()
    np.testing.assert_array_equal(di, gi)
    np.testing.assert_array_equal(ds, gs)


def test_ranked_tail_repeats_the_fallback_doc(pair, monkeypatch):
    """"r17" is in fewer than 300 docs: past them the ranking repeats one
    zero-score doc beside the candidates, as in the JAX package."""
    jarr, tarr = pair
    for mod in (jcand, cand):
        monkeypatch.setattr(mod, "CAND_TERM_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "CAND_MAX_FRAC", 0)
    ws, wi = jarr.score_batch(["r17", "r0"], top_k=300)
    gs, gi = tarr.score_batch(["r17", "r0"], top_k=300)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, **TOL)
    tail = gi[0][gs[0] == 0]
    assert len(tail) > 1 and len(set(tail)) == 1
    assert tarr.score("r17")[tail[0]] == 0


def test_score_batch_device_matches_jax(pair, forced):
    jarr, tarr = pair
    got = tarr.score_batch_device(BATCH)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), jax_dense(jarr, forced), **TOL)


def test_dedup_fans_out(pair, forced):
    jarr, tarr = pair
    got = tarr.score_batch(BATCH)
    gs, gi = tarr.score_batch(BATCH, top_k=5)
    ws, wi = jax_ranked(jarr, forced)
    for a, b in REPEATS:
        np.testing.assert_array_equal(got[a], got[b])
        np.testing.assert_array_equal(gi[a], gi[b])
        np.testing.assert_array_equal(gi[a], wi[a])
        np.testing.assert_array_equal(gs[a], gs[b])


def test_slop_matches_jax(pair, forced):
    """Slop 1 and slop 4 in one batch (``slop`` per query)."""
    jarr, tarr = pair
    want = jax_once(forced, "slop", lambda: jarr.score_batch(
        SLOP_BATCH, slop=SLOPS))
    got = tarr.score_batch(SLOP_BATCH, slop=SLOPS)
    np.testing.assert_allclose(got, want, **TOL)
    for i, (q, sl) in enumerate(zip(SLOP_BATCH, SLOPS)):
        np.testing.assert_allclose(got[i], tarr.score(q, slop=sl), **TOL,
                                   err_msg=f"{q} slop={sl}")
    ws, wi = jax_once(forced, "slopk", lambda: jarr.score_batch(
        SLOP_BATCH, top_k=4, slop=SLOPS))
    gs, gi = tarr.score_batch(SLOP_BATCH, top_k=4, slop=SLOPS)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, **TOL)
    assert (got[:6] <= got[6:]).all() and (got[6:] > got[:6]).any()


def test_a_candidate_batch_launches_no_kernel_on_the_cpu(pair, forced):
    _, tarr = pair
    before = (kc_launches(), kc.topk.launches, kc.phrase_chain.launches)
    calls = []
    real = kc.cand_rows

    def spy(*a, **kw):
        calls.append(kw.get("with_tf", True))
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(kc, "cand_rows", spy)
    try:
        tarr.score_batch(QUERIES, top_k=3)
    finally:
        mp.undo()
    assert sorted(set(calls)) == [False, True]   # terms and phrases
    assert (kc_launches(), kc.topk.launches,
            kc.phrase_chain.launches) == before


# ---------------------------------------------------------------------------
# score_batch_device(rows=)
# ---------------------------------------------------------------------------
ROWS_QUERIES = ["hot1", "r5", ["hot1", "hot2"], ["r1", "r2", "r3"],
                ["hot2", "r0", "hot1"], "nosuchterm", ["hot1", "hot1"]]


def rows_of(tarr, step=7):
    """Every ``step``-th doc, and the crafted docs 4000 and 4001."""
    return np.union1d(np.arange(2, len(tarr), step), [4000, 4001])


def test_rows_match_jax(pair):
    jarr, tarr = pair
    rows = rows_of(tarr)
    got = tarr.score_batch_device(ROWS_QUERIES, rows=rows)
    want = np.asarray(jarr.score_batch_device(ROWS_QUERIES, rows=rows))
    assert got.shape == (len(ROWS_QUERIES), len(rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    full = tarr.score_batch(ROWS_QUERIES)
    np.testing.assert_allclose(got.numpy(), full[:, rows], **TOL)
    assert (got.numpy()[3] > 0).any()
    # unsorted and repeated rows, an empty set
    odd = np.asarray([4002, 3, 3, 17, 0])
    np.testing.assert_allclose(
        tarr.score_batch_device(ROWS_QUERIES, rows=odd).numpy(),
        full[:, odd], **TOL)
    assert tarr.score_batch_device(ROWS_QUERIES, rows=[]).shape == (7, 0)
    with pytest.raises(ValueError, match="doc ids"):
        tarr.score_batch_device(["r0"], rows=[len(tarr)])


def test_rows_take_k8b_on_the_phrase_groups(pair):
    _, tarr = pair
    calls = []
    real = kc.cand_minis

    def spy(rows, slots, *a, **kw):
        calls.append(np.asarray(slots).min())
        return real(rows, slots, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(kc, "cand_minis", spy)
    try:
        tarr.score_batch_device([["hot3", "hot1"], ["hot1", "hot3", "hot2"]],
                                rows=rows_of(tarr))
    finally:
        mp.undo()
    assert len(calls) == 2 and min(calls) >= 0   # every term pooled


def test_rows_on_a_cached_phrase_row(pair):
    jarr, tarr = pair
    q = [["hot3", "hot2"]]
    for _ in range(2):   # the second hit promotes it in both packages
        tarr.score_batch(q)
        jarr.score_batch(q)
    sig = (tuple(tarr._resolve_tids(q[0])), 0)
    assert sig in tarr.dev.maps.tf_slot and sig in jarr.dev.tf_slot
    rows = rows_of(tarr, 5)
    got = tarr.score_batch_device(q, rows=rows)
    want = np.asarray(jarr.score_batch_device(q, rows=rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got.numpy() > 0).any()


def test_rows_on_a_sparse_group_corpus(pair, monkeypatch):
    jarr, tarr = pair
    for mod in (jdense, dense):
        monkeypatch.setattr(mod, "DENSE_TERM_BYTES_LIMIT", 0)
    tids = resolve(tarr, ROWS_QUERIES)
    assert {g[0] for g in batch._classify(tarr.dev, tids, "bm25")} == {
        "term", "phrase"}
    rows = rows_of(tarr, 3)
    got = tarr.score_batch_device(ROWS_QUERIES, rows=rows)
    want = np.asarray(jarr.score_batch_device(ROWS_QUERIES, rows=rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bad", ["slop", "slop_list", "similarity", "view"])
def test_rows_refusals_match_jax(pair, bad):
    jarr, tarr = pair
    kw = {"slop": dict(slop=2), "slop_list": dict(slop=[0, 3]),
          "similarity": dict(similarity=lambda tfs, *_: tfs),
          "view": {}}[bad]
    for arr in (tarr, jarr):
        target = arr[::2] if bad == "view" else arr
        with pytest.raises(ValueError, match="rows= requires"):
            target.score_batch_device(["r0", ["r1", "r2"]], rows=[1, 2],
                                      **kw)
