"""The fused ranking pass (``ops/cuda/score.py:rank_rows``, K3's selection
over scores that K10's per-element function computes as it reads the tf
rows): its plain twin against ``similarity_plain`` then ``topk_exact``
bit for bit (every kind, k of 1, 10 and 64, slots repeated and out of
order, ties across tile edges, rows of zeros, zero-length docs), the
route the batch driver's group bodies take (``dense.rank_or_score``:
fused for a top k of at most ``RANK_MAX_K`` over whole rows, K10 then K3
otherwise, counted on ``batch.enqueue``), and, on a card, the kernel
against the gather, K10 and K3 it replaces."""
import numpy as np
import pytest
import torch

from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.search import batch, dense
from searcharray_tpu_torch.utils import profiling

SIM_KINDS = ["bm25", "bm25_legacy", "bm25_impact", "classic"]
AVGDL, K1, B = 37.25, 1.2, 0.75


def tf_rows(seed, rows, n, *, zero_rows=(), zero_lens=False, kind="bm25"):
    """Integer tfs, mostly zero, few levels (ties at every rank), doc
    lengths 1-89 (some 0 with ``zero_lens``; not for classic, whose
    0 / 0 is no score), one idf a row (negative ones for bm25_legacy, as
    its idf of a term in most docs is)."""
    rng = np.random.default_rng(seed)
    tf = np.where(rng.random((rows, n)) < 0.2,
                  rng.integers(1, 6, (rows, n)), 0).astype(np.float32)
    tf[list(zero_rows)] = 0
    dl = rng.integers(1, 90, n).astype(np.float32)
    if zero_lens:
        dl[rng.random(n) < 0.1] = 0
        tf[:, dl == 0] = 0
    lo = -2.0 if kind == "bm25_legacy" else 0.1
    idfs = rng.uniform(lo, 6.0, rows).astype(np.float32)
    return torch.from_numpy(tf), torch.from_numpy(dl), torch.from_numpy(idfs)


def want(kind, src, slots, dl, idfs, k):
    """``similarity_plain`` of the ranked rows, then ``topk_exact``."""
    rows = src if slots is None else src.index_select(0, slots)
    scores = K.similarity_plain(kind, rows, dl[None, :], idfs[:, None],
                                AVGDL, K1, B)
    return K.topk_exact(scores, k)


def same_bits(got, exp):
    assert torch.equal(got[1].long(), exp[1])
    assert torch.equal(got[0].view(torch.int32), exp[0].view(torch.int32))


@pytest.mark.parametrize("kind", SIM_KINDS)
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("n", [71, 1000, 2 * kc.RANK_TILE + 7])
def test_plain_twin_matches_similarity_then_topk(kind, k, n):
    """``kc.rank_rows`` on the CPU (the plain twin) on rows narrower than
    the kernel's tile and across two tile edges: slots repeated and out of
    order, a row of zeros, zero-length docs (not classic)."""
    src, dl, _ = tf_rows(k + n, 9, n, zero_rows=[4],
                         zero_lens=kind != "classic", kind=kind)
    slots = torch.tensor([7, 2, 2, 4, 0, 8, 7], dtype=torch.int64)
    _, _, idfs = tf_rows(k, len(slots), 1, kind=kind)
    got = kc.rank_rows(kind, src, slots, dl, idfs, AVGDL, K1, B, k)
    assert got[1].dtype == torch.int32
    same_bits(got, want(kind, src, slots, dl, idfs, k))
    same_bits(got, K.rank_rows_plain(kind, src, slots, dl, idfs, AVGDL, K1,
                                     B, k))


@pytest.mark.parametrize("kind", SIM_KINDS)
@pytest.mark.parametrize("k", [1, 10, 64])
def test_ties_across_a_tile_edge(kind, k):
    """k + 3 equal scores that start before, at and after the kernel's
    16,384-element tile edge, one score above them: the earliest indices
    win, through ``kc.rank_rows`` on the CPU and against ``kc.topk`` of
    ``kc.similarity``."""
    tile = kc.RANK_TILE
    n = 2 * tile + 100
    src = torch.zeros((4, n))
    dl = torch.full((n,), 10.0)
    for r, at in enumerate((tile - 2, tile - 1, tile, tile - k // 2)):
        src[r, at: at + k + 3] = 3.0
        src[r, 2 * tile + 50] = 7.0
    idfs = torch.tensor([1.5, 0.5, 2.0, 3.0])
    got = kc.rank_rows(kind, src, None, dl, idfs, AVGDL, K1, B, k)
    same_bits(got, want(kind, src, None, dl, idfs, k))
    exp = kc.topk(kc.similarity(kind, src, dl, idfs, AVGDL, K1, B), k)
    assert torch.equal(got[1], exp[1])
    assert torch.equal(got[0].view(torch.int32), exp[0].view(torch.int32))
    assert got[1][0, 0].item() == 2 * tile + 50
    if k > 1:
        assert got[1][1, 1].item() == tile - 1


def test_rank_rows_rejects_what_the_kernel_does_not_take():
    src, dl, idfs = tf_rows(1, 3, 100)
    with pytest.raises(ValueError):
        kc.rank_rows("bm25", src, None, dl, idfs, AVGDL, K1, B,
                     kc.RANK_MAX_K + 1)
    with pytest.raises(ValueError):
        kc.rank_rows("none", src, None, dl, idfs, AVGDL, K1, B, 10)
    with pytest.raises(ValueError):
        kc.rank_rows("bm25", src, None, dl, idfs[:2], AVGDL, K1, B, 10)
    with pytest.raises(TypeError):
        kc.rank_rows("bm25", src, torch.tensor([0, 1], dtype=torch.int32),
                     dl, idfs[:2], AVGDL, K1, B, 10)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
QUERIES = ["alpha", "beta", ["alpha", "beta"], ["gamma", "delta", "eps"],
           ["beta", "gamma", "eta"], "theta", ["alpha", "beta"]]
SLOPS = [0, 0, 0, 0, 2, 0, 0]
DISTINCT = 6


def make_array():
    rng = np.random.default_rng(5)
    docs = [" ".join(rng.choice(WORDS, size=rng.integers(0, 30)))
            for _ in range(400)]
    return SearchArray.index(docs, workers=1, device="cpu", autowarm=False)


@pytest.fixture(scope="module")
def arr():
    return make_array()


def enqueue_counts(call):
    """(ranked_rows, ranked_unfused_rows) summed over the ``batch.enqueue``
    spans of ``call()``, and its result."""
    profiling.clear()
    with profiling.recording():
        got = call()
    spans = [s for s in profiling.spans() if s.name == "batch.enqueue"]
    profiling.clear()
    assert spans
    return (sum(s.counts.get("ranked_rows", 0) for s in spans),
            sum(s.counts.get("ranked_unfused_rows", 0) for s in spans)), got


def never_fused(top_k):
    return False


@pytest.mark.parametrize("sparse", [False, True])
def test_group_bodies_route_by_top_k(arr, monkeypatch, sparse):
    """Terms, exact and slop phrases on the dense groups, then with the
    dense engine off (``DENSE_TERM_BYTES_LIMIT = 0``: the sparse term and
    phrase groups, and ``span`` groups, which K10 and one K3 rank): top 10
    is fused wherever the group takes it, 65 never; full scores rank
    nothing; the fused and unfused routes give the same answers."""
    if sparse:
        monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
        arr = make_array()
    counts, fused = enqueue_counts(
        lambda: arr.score_batch(QUERIES, slop=SLOPS, top_k=10))
    span_rows = 1 if sparse else 0
    assert counts == (DISTINCT, span_rows)
    counts, _ = enqueue_counts(
        lambda: arr.score_batch(QUERIES, slop=SLOPS, top_k=65))
    assert counts == (DISTINCT, DISTINCT)
    counts, _ = enqueue_counts(lambda: arr.score_batch(QUERIES, slop=SLOPS))
    assert counts == (0, 0)
    with monkeypatch.context() as m:
        m.setattr(dense, "fuses", never_fused)
        counts, unfused = enqueue_counts(
            lambda: arr.score_batch(QUERIES, slop=SLOPS, top_k=10))
    assert counts == (DISTINCT, DISTINCT)
    np.testing.assert_array_equal(fused[1], unfused[1])
    np.testing.assert_array_equal(fused[0].view(np.int32),
                                  unfused[0].view(np.int32))


def test_term_group_body_with_rows_is_unfused(arr):
    """A ``rows`` subset takes K10 then K3, and ranks the scores the full
    rows give at those docs."""
    dev = arr.dev
    dense.ensure_tfs(dev, [0, 3, 5])
    slots = torch.from_numpy(dense.tf_slots_of(dev.maps, [5, 0, 3]))
    idfs = torch.tensor([1.25, 0.5, 2.0])
    rows = torch.tensor([399, 3, 17, 250, 251, 100, 7, 8, 9, 10, 11, 12],
                        dtype=torch.int32)
    avgdl = np.float32(dev.avg_doc_length)
    with profiling.recording(), profiling.span("test") as sp:
        got = dense.term_group_body("bm25", K1, B, 10, dev.tf_pool, slots,
                                    dev.doc_lens, idfs, avgdl, rows=rows)
        full = dense.term_group_body("bm25", K1, B, None, dev.tf_pool, slots,
                                     dev.doc_lens, idfs, avgdl)
    assert sp.counts == {"ranked_rows": 3, "ranked_unfused_rows": 3}
    assert torch.equal(got, dense.pack_topk(full.index_select(1, rows), 10))


@pytest.mark.parametrize("top_k", [1, 10, 64, 65, None])
def test_sparse_phrase_scores_route(arr, top_k):
    """``batch._phrase_scores`` (the sparse phrase groups' finish) on a
    strided freqs view: fused to 64, K10 and K3 above, the same answers."""
    big, dl, idfs = tf_rows(9, 5, 420)
    freqs = big[:, :400]
    dl = dl[:400].contiguous()
    with profiling.recording(), profiling.span("test") as sp:
        got = batch._phrase_scores(freqs, "bm25", K1, B, top_k, dl, AVGDL,
                                   idfs.numpy())
    scores = K.similarity_plain("bm25", freqs, dl[None, :], idfs[:, None],
                                AVGDL, K1, B)
    if top_k is None:
        assert sp.counts == {}
        assert torch.equal(got.view(torch.int32), scores.view(torch.int32))
        return
    fused = top_k <= kc.RANK_MAX_K
    assert sp.counts == ({"ranked_rows": 5} if fused else
                         {"ranked_rows": 5, "ranked_unfused_rows": 5})
    assert torch.equal(got, dense.pack_topk(scores, top_k))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("kind", SIM_KINDS)
@pytest.mark.parametrize("n", [1_000_003, 1_000_000])
@pytest.mark.parametrize("k1,b", [(K1, B), (K1, 1.0), (0.9, 0.0)])
def test_kernel_matches_gather_k10_k3(kind, n, k1, b):
    """37 ranked rows by slot out of a 40-row pool across many tiles
    (scalar loads at 1,000,003, 16-byte ones at 1,000,000), and the pool's
    rows themselves through a strided view: values bit for bit, indices
    equal, for k of 1, 10 and 64.  Zero-length docs and b = 1 (a tf of 0
    scores 0 / 0 there), and b = 0: the BM25 forms' shortcut for a tf of 0
    is taken only where it is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    card = torch.device("cuda")
    lib = kc._get_lib()
    assert (kc.RANK_TILE, kc.RANK_MAX_K) == (lib.sa_topk_tile(),
                                             lib.sa_topk_one_pass_cap())
    pool, dl, _ = tf_rows(n, 40, n, zero_rows=[3],
                          zero_lens=kind != "classic", kind=kind)
    pool, dl = pool.to(card), dl.to(card)
    rng = np.random.default_rng(n)
    slots = torch.from_numpy(rng.integers(0, 40, 37)).to(card)
    _, _, idfs = tf_rows(n + 1, 37, 1, kind=kind)
    idfs = idfs.to(card)
    wide = torch.zeros((5, n + 4), device=card)
    wide[:, :n] = pool[:5]
    for k in (1, 10, 64):
        before = kc.rank_rows.launches
        got = kc.rank_rows(kind, pool, slots, dl, idfs, AVGDL, k1, b, k)
        exp = kc.topk(kc.similarity(kind, pool.index_select(0, slots), dl,
                                    idfs, AVGDL, k1, b), k)
        torch.cuda.synchronize()
        assert kc.rank_rows.launches == before + 1
        assert torch.equal(got[1], exp[1])
        assert torch.equal(got[0].view(torch.int32),
                           exp[0].view(torch.int32))
        got = kc.rank_rows(kind, wide[:, :n], None, dl, idfs[:5], AVGDL, k1,
                           b, k)
        exp = kc.topk(kc.similarity(kind, pool[:5], dl, idfs[:5], AVGDL, k1,
                                    b), k)
        assert torch.equal(got[1], exp[1])
        assert torch.equal(got[0].view(torch.int32),
                           exp[0].view(torch.int32))
