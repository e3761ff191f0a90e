"""Port parity for exact phrases on the dense plane engine: the plane fill
(K4's plain version), the bigram chain (K5's plain version) and the
facade's phrase paths, against the JAX package on the same numpy-seeded
inputs.  The sparse chain's own cases are in test_torch_sparse_phrase.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import similarity as jsim
from searcharray_tpu.index import builder as jbuilder
from searcharray_tpu.index.device import DeviceIndex as JDeviceIndex
from searcharray_tpu.index.vocab import Vocabulary as JVocabulary
from searcharray_tpu.search import dense as jdense
from searcharray_tpu.search import phrase as jphrase
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch.index.device import from_numpy_state
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.ops.kernels import PAD_HDR32
from searcharray_tpu_torch.search import batch, dense, phrase
from test_phrase import CASES

SIMS = ["bm25_similarity", "bm25_legacy_similarity", "bm25_impact",
        "classic_similarity"]
PHRASES = [["red", "fox"], ["the", "the"], ["red", "fox", "the"],
           ["fox", "red", "fox"], ["the", "red", "fox", "w3"],
           ["w1", "the", "red", "w2", "fox"], ["red", "nope"]]
QUERIES = ["red", ["red", "fox"], "w4", ["the", "the"], ["red", "fox"],
           ["w1", "the", "red", "w2", "fox"], ["fox", "red", "fox"], "nope",
           ["the", "red", "fox", "w3"], ["fox"]]


def make_docs(n=800, seed=5):
    rng = np.random.default_rng(seed)
    vocab = ["red", "fox", "the", "dog"] + [f"w{i}" for i in range(12)]
    return [" ".join(rng.choice(vocab, size=rng.integers(1, 50)))
            for _ in range(n)]


def make_pair(docs, **kw):
    return (JSearchArray.index(docs, **kw),
            SearchArray.index(docs, device="cpu", **kw))


@pytest.fixture(scope="module")
def pair():
    return make_pair(make_docs())


# ---------------------------------------------------------------------------
# K4's plain version: plane-pool rows
# ---------------------------------------------------------------------------
def test_plane_rows_match_jax_pool(pair):
    jarr, tarr = pair
    terms = ["red", "the", "w7", "dog"]
    tids = [tarr.term_dict.get_term_id(t) for t in terms]
    assert tids == [jarr.term_dict.get_term_id(t) for t in terms]
    jdense.ensure_planes(jarr.dev, tids)
    dense.ensure_planes(tarr.dev, tids)
    for t in tids:
        want = np.asarray(jarr.dev.plane_pool[jarr.dev.plane_slot[t]])
        got = tarr.dev.plane_pool[tarr.dev.maps.plane_slot[t]].numpy()
        np.testing.assert_array_equal(got, want.view(np.int32))


def test_plane_fill_drops_pad_and_out_of_plane_words():
    hdrs = torch.tensor([1, 4, 6, 9, PAD_HDR32, 0, 7], dtype=torch.int32)
    pays = torch.tensor([5, 6, 7, 8, 9, 3, 2], dtype=torch.int32)
    pool = torch.full((3, 8), -1, dtype=torch.int32)
    kc.plane_fill(hdrs, pays, [0, 5], [5, 2], [2, 0], pool)
    assert pool[2].tolist() == [0, 5, 0, 0, 6, 0, 7, 0]
    assert pool[0].tolist() == [3, 0, 0, 0, 0, 0, 0, 2]
    assert pool[1].tolist() == [-1] * 8
    with pytest.raises(ValueError):
        kc.plane_fill(hdrs, pays, [0], [5], [3], pool)  # no such row


# ---------------------------------------------------------------------------
# K5's plain version on random planes
# ---------------------------------------------------------------------------
CHAINS = [
    # (terms, plan split): equal terms share a plane and a pattern tag
    ([0, 1], 0), ([0, 0], 0), ([0, 1, 2], 0), ([0, 1, 2], 2),
    ([0, 0, 1], 0), ([1, 0, 0], 2), ([0, 1, 2, 3], 1), ([0, 1, 2, 3], 2),
    ([0, 1, 2, 3, 4], 2), ([0, 0, 1, 2, 2], 2), ([0, 1, 2, 3, 4, 5], 3),
    ([0, 1, 0, 1, 0, 1], 2), ([3, 3, 3, 3, 3, 3], 0),
]


def random_planes(seed, n_planes, num_docs, slots):
    """18-bit payload planes, dense enough that chains match, with bit 17
    and bit 0 often set so matches cross slot (and doc) boundaries."""
    rng = np.random.default_rng(seed)
    NS = num_docs * slots
    planes = rng.integers(0, 1 << 18, (n_planes, NS))
    planes[rng.random((n_planes, NS)) > 0.6] = 0
    planes[rng.random((n_planes, NS)) < 0.25] |= (1 << 17) | 1
    return planes.astype(np.uint32)


@pytest.mark.parametrize("slots", [1, 2, 8])
@pytest.mark.parametrize("terms,split", CHAINS)
def test_chain_matches_jax(terms, split, slots):
    num_docs = 301
    planes = random_planes(len(terms) * 10 + slots, 6, num_docs, slots)
    plan = jphrase._plan(len(terms), split)
    assert plan == phrase._plan(len(terms), split)
    pattern = [terms.index(t) for t in terms]
    want = np.asarray(jdense.phrase_counts_dense_planes(
        [jnp.asarray(planes[t]) for t in terms], pattern, plan, num_docs,
        slots))
    pool = torch.from_numpy(planes.view(np.int32))
    got = dense.phrase_counts_dense_planes([pool[t] for t in terms],
                                           pattern, plan, num_docs, slots)
    np.testing.assert_array_equal(got.numpy(), want)
    # the K5 wrapper's CPU path: two queries, rows of a larger f32 table
    out = torch.full((4, num_docs), -1.0)
    blk_bits = slots.bit_length() - 1
    kc.phrase_chain(pool, [terms, terms], plan, pattern,
                    num_docs=num_docs, blk_bits=blk_bits, out=out,
                    out_rows=[3, 1])
    np.testing.assert_array_equal(out[[3, 1]].numpy(), np.stack([want] * 2))
    assert (out[[0, 2]] == -1).all()


def test_chain_rejects_phrases_above_the_cap():
    pool = torch.zeros((2, 80), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32"):
        kc.phrase_chain(pool, np.zeros((1, 33), np.int32),
                        phrase._plan(33, 0), [0] * 33, num_docs=10,
                        blk_bits=3)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_scenario_table(name):
    corpus, text, expected = CASES[name]
    repeat = 1 if name == "many_occurrences" else 25
    jarr, tarr = make_pair(corpus.split("|") * repeat)
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


@pytest.mark.parametrize("sim", SIMS)
def test_phrase_score_and_freqs_match_jax(pair, sim):
    jarr, tarr = pair
    for ph in PHRASES:
        np.testing.assert_array_equal(tarr.termfreqs(ph), jarr.termfreqs(ph))
        # three calls: the chain, the promotion, the cached row
        for _ in range(3):
            np.testing.assert_allclose(
                tarr.score(ph, similarity=getattr(tsim, sim)()),
                jarr.score(ph, similarity=getattr(jsim, sim)()),
                rtol=1e-6, atol=1e-7, err_msg=str(ph))


def test_custom_similarity_phrase_matches_jax(pair):
    jarr, tarr = pair

    def sim(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
        return term_freqs * doc_freqs.sum() + doc_lens / avg_doc_lens

    for ph in (["red", "fox"], ["red", "nope"]):
        np.testing.assert_allclose(tarr.score(ph, similarity=sim),
                                   jarr.score(ph, similarity=sim),
                                   rtol=1e-6)


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("sim", SIMS)
def test_score_batch_with_phrases_matches_jax(block, sim):
    jarr, tarr = make_pair(make_docs(seed=8))
    for _ in range(3):  # chain, promotion, cached rows
        ws, wi = jarr.score_batch(QUERIES, similarity=getattr(jsim, sim)(),
                                  top_k=10)
        out = tarr.score_batch(QUERIES, similarity=getattr(tsim, sim)(),
                               top_k=10, block=block)
        gs, gi = out if block else out()
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tarr.score_batch(QUERIES),
                               jarr.score_batch(QUERIES), rtol=1e-6,
                               atol=1e-7)


def test_phrase_tf_cache_promotes_on_second_hit():
    jarr, tarr = make_pair(make_docs(seed=9))
    qs = [["red", "fox"], ["the", "red", "fox", "w3"], "dog"]
    sigs = lambda dev: {k for k in dev.tf_slot if isinstance(k, tuple)}  # noqa: E731
    launches = []
    runs = []
    for _ in range(3):
        before = dense.DISPATCHES[0]
        runs.append(tarr.score_batch(qs))
        launches.append(dense.DISPATCHES[0] - before)
        np.testing.assert_allclose(runs[-1], jarr.score_batch(qs),
                                   rtol=1e-6, atol=1e-7)
        if len(runs) == 1:
            assert not sigs(tarr.dev.maps)
    want = {((tuple(tarr.term_dict.get_term_id(t) for t in q)), 0)
            for q in qs[:2]}
    assert sigs(tarr.dev.maps) == want == sigs(jarr.dev)
    np.testing.assert_array_equal(runs[1], runs[0])
    np.testing.assert_array_equal(runs[2], runs[0])
    # the third call reads the cached rows: one dterm group, no fill
    assert launches[2] == 1


def test_sliced_view_phrases_match_jax(pair):
    jarr, tarr = pair
    jv, tv = jarr[100:500:3], tarr[100:500:3]
    for ph in PHRASES[:4]:
        np.testing.assert_array_equal(tv.termfreqs(ph), jv.termfreqs(ph))
        np.testing.assert_allclose(tv.score(ph), jv.score(ph), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(tv.score_batch(QUERIES),
                               jv.score_batch(QUERIES), rtol=1e-6, atol=1e-7)
    ws, wi = jv.score_batch(QUERIES, top_k=5)
    gs, gi = tv.score_batch(QUERIES, top_k=5)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)


def test_plane_pool_exhaustion_raises_like_jax(monkeypatch):
    monkeypatch.setattr(jdense, "PLANE_POOL_BYTES", 1)
    monkeypatch.setattr(dense, "PLANE_POOL_BYTES", 1)
    jarr, tarr = make_pair(make_docs(seed=3), autowarm=False)
    assert dense.plane_capacity(tarr.dev) == jdense.plane_capacity(
        jarr.dev) == 8
    tids = list(range(9))
    with pytest.raises(RuntimeError, match="exhausted"):
        jdense.ensure_planes(jarr.dev, tids)
    with pytest.raises(RuntimeError, match="exhausted"):
        dense.ensure_planes(tarr.dev, tids)
    assert len(tarr.dev.maps.plane_slot) == 0  # nothing assigned, nothing stale
    # phrases whose terms together overflow the pool split into waves
    qs = [["w0", "w1", "w2"], ["w3", "w4", "w5"], ["w6", "w7", "w8"],
          ["red", "fox"], "dog"]
    ws, wi = JSearchArray.index(make_docs(seed=3),
                                autowarm=False).score_batch(qs, top_k=5)
    gs, gi = tarr.score_batch(qs, top_k=5)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    # a phrase with more unique terms than the pool takes runs the sparse
    # chain in both packages
    docs = make_docs(seed=3)
    long = [f"w{i}" for i in range(8)]
    docs[4] = " ".join(long) + " " + docs[4]
    jarr, tarr = make_pair(docs, autowarm=False)
    assert not dense.phrase_fits_pool(tarr.dev, list(range(8)))
    np.testing.assert_array_equal(tarr.termfreqs(long), jarr.termfreqs(long))
    assert tarr.termfreqs(long)[4] >= 1
    np.testing.assert_allclose(tarr.score(long), jarr.score(long), rtol=1e-6,
                               atol=1e-7)


def phrase_sigs(dev):
    return {k for k in dev.tf_slot if isinstance(k, tuple)}


@pytest.mark.parametrize("call", ["score", "termfreqs", "score_batch"])
def test_phrase_above_the_chain_cap_raises_every_time(call):
    """A phrase of more than CHAIN_MAX_TERMS terms no longer raises: it
    takes the sparse chain, equals the JAX package's result every time,
    and no tf-pool slot or recipe is left for it (a promoted signature
    would have K5 fill a row it cannot take)."""
    docs = make_docs(seed=11)
    long = (["red", "fox", "the", "dog"] * 9)[:dense.CHAIN_MAX_TERMS + 1]
    docs[2] = " ".join(long) + " " + docs[2]
    jarr, tarr = make_pair(docs)
    for _ in range(3):
        if call == "score":
            got, want = tarr.score(long), jarr.score(long)
        elif call == "termfreqs":
            got, want = tarr.termfreqs(long), jarr.termfreqs(long)
            np.testing.assert_array_equal(got, want)
        else:
            got, want = (a.score_batch(["red", long], top_k=3)
                         for a in (tarr, jarr))
            np.testing.assert_array_equal(got[1], want[1])
            got, want = got[0], want[0]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert got.max() > 0
    assert not phrase_sigs(tarr.dev.maps) and not tarr.dev.maps.phrase_recipes
    capped = long[:dense.CHAIN_MAX_TERMS]
    np.testing.assert_array_equal(tarr.termfreqs(capped),
                                  jarr.termfreqs(capped))


def test_failed_fill_leaves_no_slot_behind(monkeypatch):
    """A fill that raises unmaps every slot its ensure_batch assigned: the
    promoted phrase is not left on an unfilled tf-pool row, nor its terms
    on unfilled planes, and later calls fill and score them."""
    jarr, tarr = make_pair(make_docs(seed=12))
    dev = tarr.dev
    ph = ["the", "red", "fox"]
    want = jarr.score(ph)
    np.testing.assert_allclose(tarr.score(ph), want, rtol=1e-6, atol=1e-7)
    chain = kc.phrase_chain

    def failing_row_fill(*args, out=None, **kw):
        if out is not None:
            raise RuntimeError("phrase_chain launch failed: CUDA error 700")
        return chain(*args, **kw)

    monkeypatch.setattr(kc, "phrase_chain", failing_row_fill)
    before = (dict(dev.maps.plane_slot), dict(dev.maps.tf_slot), len(dev.maps.plane_free),
              len(dev.maps.tf_free))
    with pytest.raises(RuntimeError, match="CUDA error"):
        tarr.score(ph)  # the second hit promotes; its row fill raises
    # a recipe whose planes are not resident yet: they are released too
    tids = [tarr.term_dict.get_term_id(t) for t in ("w1", "w2")]
    sig = (tuple(tids), 0)
    dev.maps.phrase_recipes[sig] = (tids, ("ph", 2) + phrase.chain_key(dev, tids))
    with pytest.raises(RuntimeError, match="CUDA error"):
        dense.ensure_batch(dev, tf_tids=[sig])
    assert (dict(dev.maps.plane_slot), dict(dev.maps.tf_slot), len(dev.maps.plane_free),
            len(dev.maps.tf_free)) == before
    monkeypatch.setattr(kc, "phrase_chain", chain)
    for _ in range(2):
        np.testing.assert_allclose(tarr.score(ph), want, rtol=1e-6,
                                   atol=1e-7)
    assert phrase_sigs(dev.maps) == {(tuple(tarr.term_dict.get_term_id(t)
                                       for t in ph), 0)}


def crafted_pair():
    """Two docs (blk_bits 1, two slots each).  Doc 0 holds "a" in its
    LAST slot with bit 17 set; doc 1 holds "b" at position 0.  The chain's
    slot shift runs over the flat axis, so the JAX package counts "a b"
    once in doc 1; the port must count the same."""
    w = lambda doc, blk, pay: (doc << 36) | (blk << 18) | pay  # noqa: E731
    data = np.asarray([w(0, 1, 1 << 17), w(1, 0, 1)], np.uint64)
    state = {"data": data, "offsets": np.asarray([0, 1]),
             "lengths": np.asarray([1, 1]),
             "doc_lens": np.asarray([18, 18], np.float32),
             "doc_freqs": np.asarray([1, 1]), "avg_doc_length": 18.0,
             "terms": ["a", "b"]}
    tdev = from_numpy_state(state, "cpu")
    built = tdev.built
    vocab = JVocabulary()
    for t in state["terms"]:
        vocab.add_term(t)
    jdev = JDeviceIndex(jbuilder.BuiltIndex(
        postings=jbuilder.TermPostings(data, state["offsets"],
                                       state["lengths"]),
        doc_term=jbuilder.DocTermMatrix(built.doc_term.cols,
                                        built.doc_term.rows),
        vocab=vocab, doc_lens=built.doc_lens, avg_doc_length=18.0,
        doc_freqs=built.doc_freqs))
    return jdev, tdev


@pytest.mark.parametrize("terms", [[0, 1], [0, 1, 1], [0, 0]])
def test_last_slot_bit17_reads_across_the_doc_boundary(terms):
    jdev, tdev = crafted_pair()
    assert tdev.blk_bits == jdev.blk_bits == 1
    want = np.asarray(jphrase.phrase_freqs_dense(jdev, terms))
    # the posting slices (K7 + K2), and a one-query batch: the
    # ``dphrase`` group, K5 on pooled planes
    got = phrase.phrase_freqs_dense(tdev, terms).numpy()
    np.testing.assert_array_equal(got, want)
    pooled = batch.score_batch_fused(tdev, [terms], "none",
                                     as_device=True)[0].numpy()
    np.testing.assert_array_equal(pooled, want)
    assert set(tdev.maps.plane_slot) == set(terms)
    if terms == [0, 1]:
        assert got.tolist() == [0, 1]


@pytest.mark.parametrize("call", ["window", "slop", "slop_batch",
                                  "not_dense"])
def test_unported_phrase_paths_raise(pair, call, monkeypatch):
    _, tarr = pair
    if call == "window":
        # ported: a windowed phrase equals the JAX package's freqs
        jarr, _ = pair
        got = tarr.termfreqs(["red", "fox"], min_posn=0, max_posn=17)
        np.testing.assert_array_equal(
            got, jarr.termfreqs(["red", "fox"], min_posn=0, max_posn=17))
        assert 0 < got.sum() < tarr.termfreqs(["red", "fox"]).sum()
    elif call == "slop":
        # ported: a slop phrase on dense planes equals the JAX package's
        jarr, _ = pair
        np.testing.assert_array_equal(
            tarr.termfreqs(["red", "fox"], slop=1),
            jarr.termfreqs(["red", "fox"], slop=1))
        got = tarr.score(["red", "fox"], slop=1)
        np.testing.assert_allclose(got, jarr.score(["red", "fox"], slop=1),
                                   rtol=1e-6, atol=1e-7)
        assert (got > 0).sum() > (tarr.score(["red", "fox"]) > 0).sum()
        # ported too: the shapes the sparse span kernel takes
        wide = tarr.score(["red", "fox"], slop=18)
        np.testing.assert_allclose(wide, jarr.score(["red", "fox"], slop=18),
                                   rtol=1e-6, atol=1e-7)
        assert (wide > 0).sum() > (got > 0).sum()
    elif call == "slop_batch":
        # ported: a batch mixing slop 0 and 2
        jarr, _ = pair
        qs = ["red", ["red", "fox"], ["fox", "the", "fox"]]
        ws, wi = jarr.score_batch(qs, slop=[0, 2, 2], top_k=3)
        gs, gi = tarr.score_batch(qs, slop=[0, 2, 2], top_k=3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
        ws, wi = jarr.score_batch(["red", ["red", "fox"]], slop=[0, 30],
                                  top_k=3)
        gs, gi = tarr.score_batch(["red", ["red", "fox"]], slop=[0, 30],
                                  top_k=3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    else:
        # ported: phrases on a corpus that is not dense-eligible
        jarr, arr = make_pair(make_docs(n=50))
        monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
        monkeypatch.setattr(jdense, "DENSE_TERM_BYTES_LIMIT", 0)
        ws, wi = jarr.score_batch([["red", "fox"]], top_k=3)
        gs, gi = arr.score_batch([["red", "fox"]], top_k=3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
        assert gs[0, 0] > 0
        assert arr.score_batch(["red", "fox"], top_k=3)[0].shape == (2, 3)
