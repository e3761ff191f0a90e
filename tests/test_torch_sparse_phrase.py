"""Port parity for the sparse exact-phrase chain: the merge step and the
same-term step (K7's plain version), whole chains, and the facade's
windowed, not-dense-eligible and pool-overflow phrase paths, against the
JAX package on the same numpy-seeded inputs.  Freqs are exact, scores
within rtol 1e-6."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import similarity as jsim
from searcharray_tpu.search import dense as jdense
from searcharray_tpu.search import phrase as jphrase
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.search import batch, dense, phrase
from test_phrase import CASES
from test_torch_phrase import crafted_pair, make_docs, phrase_sigs

SIMS = ["bm25_similarity", "bm25_legacy_similarity", "bm25_impact",
        "classic_similarity"]
NUM_DOCS, BLK_BITS = 120, 2


def random_lists(seed, n_lists, density=0.5):
    """``n_lists`` posting lists over NUM_DOCS docs of 4 blocks: sorted
    unique int32 headers and 18-bit payloads, bit 17 and bit 0 often set
    so matches cross block (and doc) boundaries."""
    rng = np.random.default_rng(seed)
    NS = NUM_DOCS << BLK_BITS
    out = []
    for _ in range(n_lists):
        h = np.flatnonzero(rng.random(NS) < density).astype(np.int32)
        p = rng.integers(1, 1 << 18, len(h))
        p[rng.random(len(h)) < 0.3] |= (1 << 17) | 1
        out.append((h, p.astype(np.uint32)))
    return out


def as_planes(lists):
    """The lists laid end to end as the port's int32 planes, with each
    list's (off, n)."""
    hdrs = torch.from_numpy(np.concatenate([h for h, _ in lists]))
    pays = torch.from_numpy(
        np.concatenate([p for _, p in lists]).view(np.int32))
    ns = np.asarray([len(h) for h, _ in lists], np.int64)
    return hdrs, pays, kc.prefix_offsets(ns), ns


def per_doc(keys, counts, num_docs=NUM_DOCS):
    return kc.segment_sum(keys, counts, num_docs=num_docs).numpy()


# ---------------------------------------------------------------------------
# K7's plain version: one step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("need_cont", [True, False])
@pytest.mark.parametrize("cont_side", ["rhs", "lhs"])
@pytest.mark.parametrize("seed,dens", [(0, (0.5, 0.5)), (1, (0.05, 0.7)),
                                       (2, (0.7, 0.05)), (3, (0.0, 0.4)),
                                       (4, (0.4, 0.0))])
def test_merge_step_matches_jax(seed, dens, cont_side, need_cont):
    (lh, lp), = random_lists(seed, 1, dens[0])
    (rh, rp), = random_lists(seed + 50, 1, dens[1])
    want_d, want_c = jphrase._merge_step(
        jnp.asarray(lh), jnp.asarray(lp), jnp.asarray(rh), jnp.asarray(rp),
        cont_side, NUM_DOCS, BLK_BITS, need_cont=need_cont)
    hdrs, pays, offs, ns = as_planes([(lh, lp), (rh, rp)])
    base, other = (1, 0) if cont_side == "rhs" else (0, 1)
    keys, counts, cont = kc.merge_step(
        hdrs, pays, pays, [offs[base]], [ns[base]], [offs[other]],
        [ns[other]], [offs[other]], cont_side=cont_side, blk_bits=BLK_BITS,
        need_cont=need_cont)
    np.testing.assert_array_equal(per_doc(keys, counts), np.asarray(want_d))
    if need_cont:
        np.testing.assert_array_equal(np.asarray(want_c[0]),
                                      (rh, lh)[base ^ 1])
        np.testing.assert_array_equal(cont.numpy().view(np.uint32),
                                      np.asarray(want_c[1]))
    else:
        assert cont is None and want_c is None


@pytest.mark.parametrize("window", [None, (1, 2), (0, 0)])
@pytest.mark.parametrize("cont_side", ["rhs", "lhs"])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_same_term_step_matches_jax(seed, cont_side, window):
    (h, p), = random_lists(seed, 1, 0.6)
    pj = p
    if window is not None:
        blk = h & ((1 << BLK_BITS) - 1)
        pj = np.where((blk >= window[0]) & (blk <= window[1]), p, 0).astype(
            np.uint32)
    want_d, want_c = jphrase._same_term_step(
        jnp.asarray(h), jnp.asarray(pj), cont_side, NUM_DOCS, BLK_BITS)
    hdrs, pays, offs, ns = as_planes([(h, p)])
    mb = dict(min_blk=window[0], max_blk=window[1]) if window else {}
    keys, counts, cont = kc.merge_step(
        hdrs, pays, pays, offs, ns, offs, ns, offs, cont_side=cont_side,
        same_term=True, blk_bits=BLK_BITS, **mb)
    np.testing.assert_array_equal(per_doc(keys, counts), np.asarray(want_d))
    np.testing.assert_array_equal(cont.numpy().view(np.uint32),
                                  np.asarray(want_c[1]))


def test_batched_step_writes_flat_keys_at_prefix_offsets():
    """Three queries in one call, the middle one with no base words and
    the last with no other words: each equals its own single call, keys
    offset by q * key_stride."""
    lists = random_lists(8, 4, 0.5)
    hdrs, pays, offs, ns = as_planes(lists)
    stride = 128
    b_off, b_n = [offs[1], offs[2], offs[3]], [ns[1], 0, ns[3]]
    o_off, o_n = [offs[0], offs[0], offs[2]], [ns[0], ns[0], 0]
    keys, counts, cont = kc.merge_step(
        hdrs, pays, pays, b_off, b_n, o_off, o_n, o_off, cont_side="rhs",
        blk_bits=BLK_BITS, key_stride=stride)
    assert len(keys) == ns[1] + ns[3] and bool((keys[1:] >= keys[:-1]).all())
    start = kc.prefix_offsets(b_n)
    for q in (0, 2):
        k1_, c1_, t1_ = kc.merge_step(
            hdrs, pays, pays, [b_off[q]], [b_n[q]], [o_off[q]], [o_n[q]],
            [o_off[q]], cont_side="rhs", blk_bits=BLK_BITS)
        sl = slice(start[q], start[q] + b_n[q])
        assert torch.equal(keys[sl], k1_ + q * stride)
        assert torch.equal(counts[sl], c1_) and torch.equal(cont[sl], t1_)
    assert not counts[start[2]:].any()  # nothing to match: all-zero counts
    with pytest.raises(ValueError, match="past"):
        kc.merge_step(hdrs, pays, pays, [offs[3]], [ns[3] + 1], [0], [1],
                      [0], cont_side="rhs", blk_bits=BLK_BITS)


# ---------------------------------------------------------------------------
# whole chains against both JAX formulations
# ---------------------------------------------------------------------------
CHAINS = [
    # (terms, plan split): equal terms share a list and a pattern tag
    ([0, 1], 0), ([0, 0], 0), ([0, 1, 2], 0), ([0, 1, 2], 2),
    ([0, 0, 1], 0), ([1, 0, 0], 2), ([0, 1, 0], 0), ([0, 1, 0], 2),
    ([0, 0, 1], 2), ([1, 0, 0], 0), ([0, 1, 2, 3], 1), ([0, 1, 2, 3], 2),
    ([0, 1, 2, 3, 4], 2), ([0, 0, 1, 2, 2], 2), ([0, 1, 2, 3, 4, 5], 3),
    ([0, 1, 0, 1, 0, 1], 2), ([3, 3, 3, 3, 3, 3], 0),
    ([3, 3, 3, 3, 3, 3], 5),
]


def jax_chain_freqs(lists, terms, plan, merged):
    pattern = [terms.index(t) for t in terms]
    planes = [(jnp.asarray(lists[t][0]), jnp.asarray(lists[t][1]))
              for t in terms]
    denses = []
    for direction, idxs in plan:
        sub = [planes[i] for i in idxs]
        tags = [pattern[i] for i in idxs]
        if merged and len(sub) >= 3:
            denses += jphrase._merged_chain(sub, tags, direction, NUM_DOCS,
                                            BLK_BITS, None)
        else:
            denses += jphrase._chain_planes(sub, tags, direction, NUM_DOCS,
                                            BLK_BITS)
    return np.minimum.reduce([np.asarray(d) for d in denses])


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("terms,split", CHAINS)
def test_chain_matches_both_jax_formulations(terms, split, merged):
    lists = random_lists(len(terms) * 7 + split, 6, 0.55)
    plan = jphrase._plan(len(terms), split)
    assert plan == phrase._plan(len(terms), split)
    want = jax_chain_freqs(lists, terms, plan, merged)
    hdrs, pays, offs, ns = as_planes(lists)
    # two queries of the chunk: the chain, and the same chain again
    got = phrase.sparse_chain_freqs(
        hdrs, pays, [offs[terms]] * 2, [ns[terms]] * 2, plan,
        [terms.index(t) for t in terms], blk_bits=BLK_BITS, key_stride=128)
    assert got.shape == (2, 128) and want.max() > 0
    np.testing.assert_array_equal(got[0, :NUM_DOCS].numpy(), want)
    assert torch.equal(got[0], got[1]) and not got[:, NUM_DOCS:].any()


# ---------------------------------------------------------------------------
# the facade on the sparse path
# ---------------------------------------------------------------------------
@pytest.fixture()
def sparse_only(monkeypatch):
    """No corpus is dense-eligible, in either package."""
    monkeypatch.setattr(jdense, "DENSE_TERM_BYTES_LIMIT", 0)
    monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)


def make_pair(docs, **kw):
    return (JSearchArray.index(docs, **kw),
            SearchArray.index(docs, device="cpu", **kw))


@pytest.mark.parametrize("mode", ["never", "always"])
@pytest.mark.parametrize("name", list(CASES))
def test_scenario_table_sparse(name, mode, sparse_only, monkeypatch):
    monkeypatch.setattr(jphrase, "COMPOSITE_MODE", mode)
    corpus, text, expected = CASES[name]
    repeat = 1 if name == "many_occurrences" else 25
    jarr, tarr = make_pair(corpus.split("|") * repeat)
    assert not dense.dense_eligible(tarr.dev)
    ph = text.split()
    want = np.asarray(expected * repeat, dtype=np.float32)
    if len(ph) == 1:
        np.testing.assert_array_equal(tarr.termfreqs(ph) > 0, want > 0)
        return
    got = tarr.termfreqs(ph)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jarr.termfreqs(ph))
    np.testing.assert_allclose(tarr.score(ph), jarr.score(ph), rtol=1e-6,
                               atol=1e-7)
    assert not phrase_sigs(tarr.dev.maps)  # sparse phrases take no tf-pool slot


@pytest.mark.parametrize("off", list(range(14, 23)) + [35, 36, 53, 89, 90])
def test_block_boundaries_sparse(off, sparse_only):
    doc = " ".join(["pad"] * off) + " alpha beta gamma"
    jarr, tarr = make_pair([doc, "alpha beta", "no match"] * 5)
    for ph in (["alpha", "beta", "gamma"], ["beta", "gamma"]):
        got = tarr.termfreqs(ph)
        np.testing.assert_array_equal(got, jarr.termfreqs(ph))
        assert got[0] == 1


WINDOWED = [(["foo", "bar"], dict(min_posn=0, max_posn=17)),
            (["foo", "bar"], dict(min_posn=18, max_posn=None)),
            (["foo", "bar", "gap"], dict(min_posn=18, max_posn=None)),
            (["bar", "bar"], dict(min_posn=0, max_posn=17)),
            (["boz", "boz", "foo"], dict(min_posn=18, max_posn=35)),
            (["boz", "boz"], dict(min_posn=None, max_posn=17))]


@pytest.mark.parametrize("mode", ["never", "always"])
@pytest.mark.parametrize("ph,win", WINDOWED)
def test_windowed_phrases_match_jax(ph, win, mode, monkeypatch):
    """Windows take the sparse chain on a dense-eligible corpus too; a
    match across the window's edge dies."""
    monkeypatch.setattr(jphrase, "COMPOSITE_MODE", mode)
    corpus = ["foo bar bar baz " + " ".join(["boz"] * 25) + " foo bar gap",
              "data2", "data3 bar"] * 10
    jarr, tarr = make_pair(corpus)
    assert dense.dense_eligible(tarr.dev)
    np.testing.assert_array_equal(tarr.termfreqs(ph, **win),
                                  jarr.termfreqs(ph, **win))
    for sim in SIMS:
        np.testing.assert_allclose(
            tarr.score(ph, similarity=getattr(tsim, sim)(), **win),
            jarr.score(ph, similarity=getattr(jsim, sim)(), **win),
            rtol=1e-6, atol=1e-7)
    assert not phrase_sigs(tarr.dev.maps) and tarr.dev.plane_pool is None
    with pytest.raises(ValueError, match="multiple of 18"):
        tarr.termfreqs(ph, min_posn=5)


def trim_docs():
    """A stopword in every doc and a rare term in a few docs of the
    middle of the corpus, so the stopword's slice is trimmed."""
    rng = np.random.default_rng(21)
    vocab = ["the", "of", "a"] + [f"w{i}" for i in range(6)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(30, 80)))
            for _ in range(600)]
    for d in (200, 231, 260):
        docs[d] += " the rare the of rare the the rare"
    return docs


@pytest.mark.parametrize("ph", [["the", "rare"], ["rare", "the"],
                                ["the", "rare", "the"],
                                ["of", "rare", "the", "the"],
                                ["the", "the", "rare"],
                                ["a", "the", "rare", "the", "of"]])
def test_trim_spans_changes_slices_not_results(ph, sparse_only, monkeypatch):
    jarr, tarr = make_pair(trim_docs())
    dev = tarr.dev
    tids = [tarr.term_dict.get_term_id(t) for t in ph]
    spans = [dev.term_span(t) for t in tids]
    trimmed = phrase.trim_spans(dev, spans)
    jtrim = jphrase.trim_spans(jarr.dev, [jarr.dev.term_span(t)
                                          for t in tids])
    assert trimmed == [s[:2] for s in jtrim]
    assert trimmed != [s[:2] for s in spans]
    got = tarr.termfreqs(ph)
    assert got.sum() > 0
    np.testing.assert_array_equal(got, jarr.termfreqs(ph))
    monkeypatch.setattr(phrase, "TRIM_FACTOR", 1 << 40)
    assert phrase.trim_spans(dev, spans) == [s[:2] for s in spans]
    np.testing.assert_array_equal(tarr.termfreqs(ph), got)
    np.testing.assert_array_equal(
        tarr.score_batch([ph, "the"])[0], tarr.score(ph))


@pytest.mark.parametrize("call", ["score", "termfreqs", "score_batch"])
def test_phrase_above_the_chain_cap_takes_the_sparse_chain(call):
    """A 40-term phrase (K5 takes 32) on a dense-eligible corpus."""
    docs = make_docs(seed=13)
    docs[7] = " ".join(docs[:6])
    long = docs[7].split()[:40]
    jarr, tarr = make_pair(docs)
    assert dense.dense_eligible(tarr.dev) and len(long) == 40
    for _ in range(2):
        if call == "score":
            got, want = tarr.score(long), jarr.score(long)
        elif call == "termfreqs":
            got, want = tarr.termfreqs(long), jarr.termfreqs(long)
            np.testing.assert_array_equal(got, want)
            assert got[7] >= 1
        else:
            got = tarr.score_batch(["red", long])
            want = jarr.score_batch(["red", long])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert not phrase_sigs(tarr.dev.maps) and not tarr.dev.maps.phrase_recipes


@pytest.fixture()
def small_pool_pair(monkeypatch):
    monkeypatch.setattr(jdense, "PLANE_POOL_MAX_SLOTS", 4)
    monkeypatch.setattr(dense, "PLANE_POOL_MAX_SLOTS", 4)
    rng = np.random.default_rng(7)
    vocab = [f"t{i}" for i in range(30)]
    corpus = [" ".join(rng.choice(vocab, size=rng.integers(8, 40)))
              for _ in range(300)]
    corpus.append(" ".join(f"t{i}" for i in range(12)) * 2)
    return make_pair(corpus)


def test_phrase_overflowing_the_plane_pool_single_query(small_pool_pair):
    jarr, tarr = small_pool_pair
    assert dense.plane_capacity(tarr.dev) == 4
    ph = [f"t{i}" for i in range(8)]  # 8 unique terms > capacity - 1
    np.testing.assert_array_equal(tarr.termfreqs(ph), jarr.termfreqs(ph))
    assert tarr.termfreqs(ph)[-1] >= 1
    for _ in range(3):
        np.testing.assert_allclose(tarr.score(ph), jarr.score(ph),
                                   rtol=1e-6, atol=1e-7)
    assert not phrase_sigs(tarr.dev.maps) and tarr.dev.plane_pool is None


def test_phrase_overflowing_the_plane_pool_batch(small_pool_pair):
    jarr, tarr = small_pool_pair
    qs = [[f"t{i}" for i in range(8)],   # overflows: the sparse group
          ["t0", "t1"],                  # fits: the dense group
          "t5", [f"t{i}" for i in range(2, 9)]]
    groups = batch._classify(
        tarr.dev, [tarr._resolve_tids(q) for q in qs], "bm25")
    assert sorted(k[0] for k in groups) == ["dphrase", "dterm", "phrase",
                                            "phrase"]
    np.testing.assert_allclose(tarr.score_batch(qs), jarr.score_batch(qs),
                               rtol=1e-6, atol=1e-7)
    ws, wi = jarr.score_batch(qs, top_k=5)
    gs, gi = tarr.score_batch(qs, top_k=5)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)


SPARSE_QUERIES = ["red", ["red", "fox"], "w4", ["the", "the"], ["red", "fox"],
                  ["w1", "the", "red", "w2", "fox"], ["fox", "red", "fox"],
                  "nope", ["the", "red", "fox", "w3"], ["fox"],
                  ["red", "nope"], ["the", "the", "red"],
                  ["dog", "the", "the"]]


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("sim", SIMS)
def test_score_batch_on_a_sparse_corpus_matches_jax(block, sim, sparse_only):
    jarr, tarr = make_pair(make_docs(seed=8))
    ws, wi = jarr.score_batch(SPARSE_QUERIES,
                              similarity=getattr(jsim, sim)(), top_k=10)
    out = tarr.score_batch(SPARSE_QUERIES, similarity=getattr(tsim, sim)(),
                           top_k=10, block=block)
    gs, gi = out if block else out()
    np.testing.assert_array_equal(gi, wi)  # smallest-index tie rule
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    if block:
        np.testing.assert_allclose(
            tarr.score_batch(SPARSE_QUERIES, similarity=getattr(tsim, sim)()),
            jarr.score_batch(SPARSE_QUERIES, similarity=getattr(jsim, sim)()),
            rtol=1e-6, atol=1e-7)
    assert not phrase_sigs(tarr.dev.maps) and tarr.dev.plane_pool is None


def test_sparse_group_steps_launch_once_per_chunk(sparse_only, monkeypatch):
    """All queries of one chain structure share each step's K7 call and
    its K2 call; the word budget cuts chunks without changing results."""
    _, tarr = make_pair(make_docs(seed=8))
    words = ["red", "fox", "the", "dog", "w1", "w2", "w3", "w5"]
    by_key: dict = {}
    for q in itertools.permutations(words, 3):
        key = phrase.chain_key(tarr.dev, tarr._resolve_tids(list(q)))
        by_key.setdefault(key, []).append(list(q))
    qs = max(by_key.values(), key=len)[:4]
    assert len(qs) == 4
    calls = []
    step = kc.merge_step

    def counting(*a, **kw):
        calls.append(len(a[3]))
        return step(*a, **kw)

    monkeypatch.setattr(kc, "merge_step", counting)
    want = tarr.score_batch(qs)
    assert calls == [4, 4]  # T - 1 steps for the chunk, not per query
    calls.clear()
    monkeypatch.setattr(batch, "_SPARSE_CHUNK_WORDS", 1)
    np.testing.assert_array_equal(tarr.score_batch(qs), want)
    assert calls == [1] * 8


def test_sliced_view_and_topk_on_a_sparse_corpus(sparse_only):
    jarr, tarr = make_pair(make_docs(seed=5))
    ph = ["the", "red", "fox"]
    jv, tv = jarr[100:500:3], tarr[100:500:3]
    np.testing.assert_array_equal(tv.termfreqs(ph), jv.termfreqs(ph))
    np.testing.assert_allclose(tv.score(ph), jv.score(ph), rtol=1e-6,
                               atol=1e-7)
    ws, wi = jarr.topk(ph, k=7)
    gs, gi = tarr.topk(ph, k=7)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("terms", [[0, 1], [0, 1, 1], [0, 0], [1, 0],
                                   [0, 0, 1]])
def test_sparse_chain_reads_across_the_doc_boundary(terms, window,
                                                    sparse_only):
    """The hand-made state of test_torch_phrase: "a" in doc 0's last slot
    with bit 17 set, "b" at doc 1's position 0.  header - 1 crosses the
    document boundary on the compressed header as the JAX package's
    sorted compare does."""
    jdev, tdev = crafted_pair()
    win = dict(min_posn=0, max_posn=35) if window else {}
    want = np.asarray(jphrase.phrase_freqs_dense(jdev, terms, **win))
    got = phrase.phrase_freqs_dense(tdev, terms, **win).numpy()
    np.testing.assert_array_equal(got, want)
    if terms == [0, 1]:
        assert got.tolist() == [0, 1]
