"""The CUDA kernels K1, K2, K4 and K5 against their plain PyTorch
versions, and the port's main path on a card against the same path on
the CPU.

CUDA kernels have no CPU mode: every test here needs a CUDA device and
skips without one.  The file imports no jax, so it also runs where only
PyTorch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.ops.kernels import PAD_HDR32
from searcharray_tpu_torch.search.phrase import _plan

pytestmark = pytest.mark.cuda

KINDS = ["none", "bm25", "bm25_legacy", "bm25_impact"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def term_slice(seed, num_docs, n_words, blk_bits=3, pad=64):
    """A random doc-sorted (hdr32, pay32) slice with a PAD tail."""
    rng = np.random.default_rng(seed)
    docs = np.sort(rng.integers(0, num_docs, n_words))
    hdr = (docs << blk_bits | rng.integers(0, 5, n_words)).astype(np.int32)
    pay = rng.integers(0, 1 << 18, n_words).astype(np.int32)
    hdr = np.concatenate([hdr, np.full(pad, PAD_HDR32, np.int32)])
    pay = np.concatenate([pay, np.zeros(pad, np.int32)])
    dl = rng.integers(1, 90, num_docs).astype(np.float32)
    return (torch.from_numpy(hdr), torch.from_numpy(pay),
            torch.from_numpy(dl))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(1000, 50), (100_000, 300_000),
                                   (70_001, 0), (3000, 40_000)])
def test_k1_kernel_matches_plain(card, kind, shape):
    num_docs, n_words = shape
    h, p, dl = (t.to(card) for t in term_slice(sum(shape), *shape))
    kw = dict(num_docs=num_docs, blk_bits=3, kind=kind)
    before = kc.score_term.launches
    got = kc.score_term(h, p, dl, 1.25, 37.5, **kw)
    want = kc.score_term_plain(h, p, dl, 1.25, 37.5, **kw)
    torch.cuda.synchronize()
    assert kc.score_term.launches == before + 1
    # integer tf and IEEE round-to-nearest epilogue: bit-equal
    assert torch.equal(got, want)


def test_k1_kernel_writes_into_a_pool_row(card):
    h, p, dl = (t.to(card) for t in term_slice(7, 5000, 20_000))
    pool = torch.full((3, 5000), -1.0, device=card)
    kc.score_term(h, p, dl, 0.0, 1.0, num_docs=5000, blk_bits=3,
                  kind="none", out=pool[1])
    want = kc.score_term_plain(h, p, dl, 0.0, 1.0, num_docs=5000,
                               blk_bits=3, kind="none")
    assert torch.equal(pool[1], want)
    assert bool((pool[0] == -1).all() and (pool[2] == -1).all())


def test_k1_rejects_a_mixed_device_call(card):
    h, p, dl = term_slice(3, 100, 50)
    with pytest.raises(ValueError):
        kc.score_term(h.to(card), p, dl.to(card), 1.0, 1.0, num_docs=100,
                      blk_bits=3)


@pytest.mark.parametrize("seed,hot", [(4, 0), (5, 0), (6, 20_000)])
def test_k2_kernel_matches_plain(card, seed, hot):
    rng = np.random.default_rng(seed)
    # ``hot`` extra ids of one slot: a long document's run of one term
    ids = np.sort(np.concatenate([rng.integers(0, 50_000, 200_000),
                                  np.full(hot, 777)])).astype(np.int32)
    ids[-100:] = 2**30  # padding tail: out-of-range ids are dropped
    vals = rng.random(len(ids)).astype(np.float32)
    gi = torch.from_numpy(ids).to(card)
    gv = torch.from_numpy(vals).to(card)
    before = kc.segment_sum.launches
    got = kc.segment_sum(gi, gv, num_docs=50_000)
    want = kc.segment_sum_plain(gi, gv, num_docs=50_000)
    torch.cuda.synchronize()
    assert kc.segment_sum.launches == before + 1
    # float atomics land in no fixed order: sums agree to rtol 1e-5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # integer-valued inputs (the term group's popcounts) are exact
    ints = torch.from_numpy(rng.integers(0, 18, len(ids)).astype(
        np.float32)).to(card)
    assert torch.equal(kc.segment_sum(gi, ints, num_docs=50_000),
                       kc.segment_sum_plain(gi, ints, num_docs=50_000))


def test_main_path_on_card_matches_cpu(card):
    rng = np.random.default_rng(11)
    vocab = ["alpha", "beta", "gamma", "delta"] + [f"w{i}" for i in range(50)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 30)))
            for _ in range(3000)]
    gpu = SearchArray.index(docs, device="cuda")
    cpu = SearchArray.index(docs, device="cpu")
    for term in ["alpha", "w0", "w44", "nope"]:
        np.testing.assert_allclose(gpu.score(term), cpu.score(term),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(gpu.termfreqs(term, min_posn=18,
                                                    max_posn=35),
                                      cpu.termfreqs(term, min_posn=18,
                                                    max_posn=35))
        np.testing.assert_array_equal(gpu.topk(term, k=10)[1],
                                      cpu.topk(term, k=10)[1])
    qs = ["alpha", "w0", "w44", "nope", "alpha", "w3"]
    want = cpu.score_batch(qs, top_k=10)
    for got in (gpu.score_batch(qs, top_k=10),
                gpu.score_batch(qs, top_k=10, block=False)()):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)


def plane_rows(seed, num_docs, blk_bits, n_rows):
    """Doc-sorted (hdr32, pay32) slices of ``n_rows`` random terms, one
    after another, each with a PAD word and a word past the plane (both
    dropped), and their (offs, ns)."""
    rng = np.random.default_rng(seed)
    ns_ = 1 << blk_bits
    hs, ps, offs, ns = [], [], [], []
    at = 0
    for _ in range(n_rows):
        n = int(rng.integers(1, num_docs * ns_ // 3))
        h = np.sort(rng.choice(num_docs * ns_, n, replace=False))
        h = np.concatenate([h, [num_docs * ns_ + 3, PAD_HDR32]])
        p = rng.integers(1, 1 << 18, len(h))
        hs.append(h)
        ps.append(p)
        offs.append(at)
        ns.append(len(h))
        at += len(h)
    hdrs = torch.from_numpy(np.concatenate(hs).astype(np.int32))
    pays = torch.from_numpy(np.concatenate(ps).astype(np.int32))
    return hdrs, pays, offs, ns


@pytest.mark.parametrize("num_docs,blk_bits", [(1, 3), (3001, 3),
                                               (70_001, 1), (37, 12)])
def test_k4_kernel_matches_plain(card, num_docs, blk_bits):
    hdrs, pays, offs, ns = plane_rows(num_docs, num_docs, blk_bits, 5)
    NS = num_docs << blk_bits
    slots = [6, 0, 3, 2, 4]
    pools = [torch.full((8, NS), -7, dtype=torch.int32, device=card)
             for _ in range(2)]
    h, p = hdrs.to(card), pays.to(card)
    before = kc.plane_fill.launches
    kc.plane_fill(h, p, offs, ns, slots, pools[0])
    kc.plane_fill_plain(h, p, np.asarray(offs), np.asarray(ns),
                        np.asarray(slots), pools[1])
    torch.cuda.synchronize()
    assert kc.plane_fill.launches == before + 1
    assert torch.equal(pools[0], pools[1])
    # rows not named keep their contents
    assert bool((pools[0][[1, 5, 7]] == -7).all())


def chain_pool(seed, num_docs, blk_bits, n_planes, density=0.7):
    """A random int32 plane pool: 18-bit payloads, many with bit 17 and
    bit 0 set, so matches and cross-slot adjacency occur everywhere,
    block edges included."""
    rng = np.random.default_rng(seed)
    NS = num_docs << blk_bits
    pool = rng.integers(0, 1 << 18, (n_planes, NS))
    pool[rng.random((n_planes, NS)) > density] = 0
    pool[rng.random((n_planes, NS)) < 0.3] |= (1 << 17) | 1
    return torch.from_numpy(pool.astype(np.int32))


CHAINS = [
    # (terms as plane-pool rows, plan split)
    ([0, 1], 0),
    ([0, 0], 0),                         # same-term first step, l2r
    ([2, 1, 1], 2),                      # r2l, same-term first step
    ([1, 2, 3, 4, 5], 2),                # two halves
    ([3, 3, 4, 5, 5, 5], 3),             # two halves, same-term in each
    ([i % 7 for i in range(32)], 0),     # the cap, l2r
    ([i % 5 for i in range(32)], 31),    # the cap, r2l
]


@pytest.mark.parametrize("terms,split", CHAINS)
@pytest.mark.parametrize("num_docs,blk_bits", [(3001, 3), (5, 0),
                                               (1999, 1), (37, 12)])
def test_k5_kernel_matches_plain(card, terms, split, num_docs, blk_bits):
    pool = chain_pool(len(terms) + num_docs, num_docs, blk_bits, 8).to(card)
    T = len(terms)
    plan = _plan(T, split)
    pattern = [terms.index(t) for t in terms]
    rng = np.random.default_rng(T)
    # three queries of one structure: the terms, and two relabelings
    perm = [np.arange(8), rng.permutation(8), rng.permutation(8)]
    slots = np.asarray([[p[t] for t in terms] for p in perm], np.int32)
    kw = dict(num_docs=num_docs, blk_bits=blk_bits)
    before = kc.phrase_chain.launches
    got = kc.phrase_chain(pool, slots, plan, pattern, **kw)
    want = kc.phrase_chain_plain(pool, slots, plan, pattern, **kw)
    torch.cuda.synchronize()
    assert kc.phrase_chain.launches == before + 1
    # integer counts: bit-equal
    assert torch.equal(got, want)
    if T <= 3 and num_docs > 1000:
        assert float(want.max()) > 0  # the chain matched somewhere


def test_k5_kernel_writes_into_tf_pool_rows(card):
    pool = chain_pool(9, 4099, 3, 6).to(card)
    tfpool = torch.full((10, 4099), -1.0, device=card)
    slots = np.asarray([[0, 1, 2], [3, 4, 5], [5, 5, 1]], np.int32)
    plan = _plan(3, 1)
    kw = dict(num_docs=4099, blk_bits=3)
    kc.phrase_chain(pool, slots, plan, (0, 1, 2), out=tfpool,
                    out_rows=[7, 2, 4], **kw)
    want = kc.phrase_chain_plain(pool, slots, plan, (0, 1, 2), **kw)
    assert torch.equal(tfpool[[7, 2, 4]], want)
    keep = [i for i in range(10) if i not in (7, 2, 4)]
    assert bool((tfpool[keep] == -1).all())


def test_k5_rejects_phrases_above_the_cap(card):
    pool = chain_pool(1, 100, 3, 4).to(card)
    slots = np.zeros((1, 33), np.int32)
    with pytest.raises(ValueError, match="at most 32"):
        kc.phrase_chain(pool, slots, _plan(33, 0), [0] * 33,
                        num_docs=100, blk_bits=3)


def test_phrase_path_on_card_matches_cpu(card):
    rng = np.random.default_rng(5)
    vocab = ["red", "fox", "the", "dog"] + [f"w{i}" for i in range(20)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 60)))
            for _ in range(3000)]
    gpu = SearchArray.index(docs, device="cuda")
    cpu = SearchArray.index(docs, device="cpu")
    phrases = [["red", "fox"], ["the", "the"], ["red", "fox", "the", "dog"],
               ["w1", "the", "red", "w2", "fox"]]
    for ph in phrases:
        np.testing.assert_array_equal(gpu.termfreqs(ph), cpu.termfreqs(ph))
        for _ in range(3):  # chain, promotion, cached row
            np.testing.assert_allclose(gpu.score(ph), cpu.score(ph),
                                       rtol=1e-6, atol=1e-7)
    qs = ["red", *phrases, "w3", ["fox", "red"]]
    for _ in range(3):
        want = cpu.score_batch(qs, top_k=10)
        for got in (gpu.score_batch(qs, top_k=10),
                    gpu.score_batch(qs, top_k=10, block=False)()):
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6,
                                       atol=1e-7)
