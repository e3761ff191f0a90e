"""The CUDA kernels K1 to K11 against their plain PyTorch versions, and
the port's main path on a card against the same path on the CPU.

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
from searcharray_tpu_torch.search import batch
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


K2_SHARE = 2048   # merged keys + slot ends per block, csrc/segment_sum.cu


def k2_case(name, rng):
    """(sorted int32 ids, num_out) of one K2 case."""
    spread = lambda n, hi: rng.integers(0, hi, n)  # noqa: E731
    if name.startswith("run "):
        n = {"run 200k": 200_000, "run 1M": 1_000_000}[name]
        return np.sort(np.concatenate([spread(1000, 5000),
                                       np.full(n, 777)])), 5000
    if name == "runs across the share":
        # run i of id 2i, lengths one off each side of several share sizes
        lens = [K2_SHARE * j + e for j in (1, 2, 3, 8) for e in (-1, 0, 1)]
        ids = np.concatenate([np.full(n, 2 * i) for i, n in enumerate(lens)])
        return ids, 2 * len(lens) + 1
    if name == "3 keys over 4M slots":
        return np.array([5, 2_000_000, 3_999_999]), 4_000_000
    if name == "no key in range":  # m_in == 0 with num_out > 0
        return np.concatenate([np.full(500, 3000), np.full(100, 2**30)]), 3000
    if name == "empty":
        return np.zeros(0), 3001
    if name == "all pad":
        return np.full(5000, 2**30), 5000
    if name == "ids past num_out":
        past = rng.integers(9000, 2**30, 20_000)
        return np.sort(np.concatenate([spread(20_000, 9000), past])), 9000
    if name == "odd num_out":
        return np.sort(spread(70_000, 10_007)), 10_007
    if name.startswith("flat keys"):
        # _flat_keys of Qg rows of one bucket: doc keys, then the PAD tail
        # clamped onto the row's last slot
        Qg, N, bucket = int(name.split("=")[1]), 30_000, 40_960
        Npad = batch._npad(N)
        keys = np.full((Qg, bucket), PAD_HDR32 >> 3, np.int32)
        for q in range(Qg):
            n = int(rng.integers(bucket * 3 // 4, bucket))
            keys[q, :n] = np.sort(spread(n, N))
        flat = batch._flat_keys(torch.from_numpy(keys), Qg, Npad).numpy()
        return flat, Qg * Npad
    raise KeyError(name)


K2_CASES = ["run 200k", "run 1M", "runs across the share",
            "3 keys over 4M slots", "no key in range", "empty", "all pad",
            "ids past num_out", "odd num_out", "flat keys Qg=1",
            "flat keys Qg=3", "flat keys Qg=8"]


@pytest.mark.parametrize("values", ["integers", "floats"])
@pytest.mark.parametrize("case", K2_CASES)
def test_k2_design_matches_plain(card, case, values):
    """K2's merge-path shares: exact on integer values; on random floats
    within rtol 1e-5 of the plain version summed in float64 (a float32
    sum of a 1M-key run is itself ~3e-5 off)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    ids, n_out = k2_case(case, rng)
    if values == "integers":
        vals = rng.integers(0, 18, len(ids)).astype(np.float32)
    else:
        vals = rng.random(len(ids)).astype(np.float32)
    gi = torch.from_numpy(ids.astype(np.int32)).to(card)
    gv = torch.from_numpy(vals).to(card)
    before = kc.segment_sum.launches
    got = kc.segment_sum(gi, gv, num_docs=n_out)
    torch.cuda.synchronize()
    assert kc.segment_sum.launches == before + 1
    if values == "integers":
        assert torch.equal(got, kc.segment_sum_plain(gi, gv, num_docs=n_out))
    else:
        want = kc.segment_sum_plain(gi, gv.double(), num_docs=n_out)
        torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k2_on_unaligned_views(card, offset):
    """Views that start off a 16-byte boundary take K2's 4-byte loads."""
    rng = np.random.default_rng(offset)
    ids = np.sort(np.concatenate([rng.integers(0, 6000, 30_000),
                                  np.full(9000, 1234)])).astype(np.int32)
    vals = rng.integers(0, 18, len(ids)).astype(np.float32)
    gi = torch.from_numpy(ids).to(card)[offset:]
    gv = torch.from_numpy(vals).to(card)[offset:]
    assert torch.equal(kc.segment_sum(gi, gv, num_docs=6000),
                       kc.segment_sum_plain(gi, gv, num_docs=6000))


def test_k2_calls_of_many_sizes_in_a_row(card):
    """K2's scratch (one carry per share and the ticket counter) is reused
    and grown across calls on one stream."""
    rng = np.random.default_rng(9)
    for n_out, m in [(100, 10), (2_000_000, 3_000_000), (50, 0),
                     (5000, 200_000), (3, 7)]:
        ids = np.sort(rng.integers(0, n_out, m)).astype(np.int32)
        vals = rng.integers(0, 18, m).astype(np.float32)
        gi = torch.from_numpy(ids).to(card)
        gv = torch.from_numpy(vals).to(card)
        assert torch.equal(kc.segment_sum(gi, gv, num_docs=n_out),
                           kc.segment_sum_plain(gi, gv, num_docs=n_out))


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


# --- the Hopper designs: K5's warp and tile paths, K1's warp search and
# --- vector epilogue, the multi-row K1

K5_SHAPES = [
    # (S = 2^blk_bits, num_docs): no num_docs is a multiple of a warp
    # window (248 or fewer counted slots), a block (8 windows) or a tile
    (0, 2999), (1, 2999), (3, 3001), (4, 1501), (5, 777), (6, 301),
    (12, 37),
]
K5_CHAINS = [
    # (terms as plane-pool rows, plan split): T = 2, 3, 31, 32, both plan
    # shapes and same-term first steps
    ([0, 1], 0),
    ([3, 3], 0),
    ([0, 1, 2], 0),
    ([2, 1, 1], 2),
    ([1, 2, 3, 4, 5], 2),
    ([3, 3, 4, 5, 5, 5], 3),
    ([i % 6 for i in range(31)], 0),
    ([(i * 5) % 7 for i in range(31)], 30),
    ([i % 7 for i in range(32)], 0),
    ([i % 5 for i in range(32)], 31),
    ([0, 0, 1, 2, 3] * 6 + [4, 4], 14),
]


@pytest.mark.parametrize("terms,split", K5_CHAINS)
@pytest.mark.parametrize("blk_bits,num_docs", K5_SHAPES)
def test_k5_design_matches_plain(card, terms, split, blk_bits, num_docs):
    """The warp kernel (S <= 32: 4-byte and 16-byte copies, 1-8 docs per
    lane, 2-4 lanes per doc) and the tile kernel (S >= 64) bit for bit."""
    pool = chain_pool(blk_bits * 1000 + len(terms), num_docs, blk_bits,
                      8).to(card)
    T = len(terms)
    pattern = [terms.index(t) for t in terms]
    rng = np.random.default_rng(T + split)
    perm = [np.arange(8), rng.permutation(8), rng.permutation(8)]
    slots = np.asarray([[p[t] for t in terms] for p in perm], np.int32)
    kw = dict(num_docs=num_docs, blk_bits=blk_bits)
    got = kc.phrase_chain(pool, slots, _plan(T, split), pattern, **kw)
    want = kc.phrase_chain_plain(pool, slots, _plan(T, split), pattern, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("blk_bits,num_docs", [(3, 40_001), (1, 3333),
                                               (5, 999)])
def test_k5_group_sharing_planes_matches_plain(card, blk_bits, num_docs):
    """A group of 40 two-term queries over 6 planes: every plane is read
    by many queries of one launch, and each warp's ring wraps many
    times."""
    pool = chain_pool(blk_bits, num_docs, blk_bits, 6).to(card)
    pairs = [(a, b) for a in range(6) for b in range(6) if a != b]
    slots = np.asarray(pairs[:40] if len(pairs) >= 40 else
                       (pairs * 2)[:40], np.int32)
    kw = dict(num_docs=num_docs, blk_bits=blk_bits)
    got = kc.phrase_chain(pool, slots, _plan(2, 0), (0, 1), **kw)
    want = kc.phrase_chain_plain(pool, slots, _plan(2, 0), (0, 1), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(want.max()) > 0


@pytest.mark.parametrize("blk_bits", [0, 3, 4, 6])
def test_k5_design_writes_into_tf_pool_rows(card, blk_bits):
    num_docs = 2001
    pool = chain_pool(blk_bits + 3, num_docs, blk_bits, 6).to(card)
    tfpool = torch.full((12, num_docs), -1.0, device=card)
    slots = np.asarray([[0, 1, 2, 3], [3, 4, 5, 0], [5, 1, 1, 2]], np.int32)
    plan = _plan(4, 2)
    rows = [11, 0, 6]
    kw = dict(num_docs=num_docs, blk_bits=blk_bits)
    kc.phrase_chain(pool, slots, plan, (0, 1, 2, 3), out=tfpool,
                    out_rows=rows, **kw)
    want = kc.phrase_chain_plain(pool, slots, plan, (0, 1, 2, 3), **kw)
    torch.cuda.synchronize()
    assert torch.equal(tfpool[rows], want)
    keep = [i for i in range(12) if i not in rows]
    assert bool((tfpool[keep] == -1).all())


def k1_slice(docs, num_docs, seed, blk_bits=3, pad=16):
    """A doc-sorted (hdr32, pay32) slice of words in ``docs`` (sorted),
    with a PAD tail, and random doc lengths."""
    rng = np.random.default_rng(seed)
    docs = np.sort(np.asarray(docs, np.int64))
    hdr = (docs << blk_bits | rng.integers(0, 1 << blk_bits,
                                           len(docs))).astype(np.int32)
    hdr = np.sort(hdr)
    pay = rng.integers(0, 1 << 18, len(docs)).astype(np.int32)
    hdr = np.concatenate([hdr, np.full(pad, PAD_HDR32, np.int32)])
    pay = np.concatenate([pay, np.zeros(pad, np.int32)])
    dl = rng.integers(1, 90, num_docs).astype(np.float32)
    return (torch.from_numpy(hdr), torch.from_numpy(pay),
            torch.from_numpy(dl))


K1_NUM_DOCS = 1_000_003  # not a multiple of the 1024-doc block


def k1_case(name):
    rng = np.random.default_rng(len(name))
    n = K1_NUM_DOCS
    if name.startswith("m="):
        return rng.integers(0, n, int(name[2:]))
    if name == "one block":
        return rng.integers(2048, 3072, 5000)
    if name.startswith("block edges"):
        edges = np.arange(1024, n, 1024)
        words = [edges - 1, edges, [0, n - 1]]
        if name.endswith("dense"):  # more than n / 4 words: 1024-doc blocks
            words.append(rng.integers(0, n, 300_000))
        return np.concatenate(words)
    raise KeyError(name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", ["m=0", "m=1", "m=31", "m=32", "m=33",
                                  "m=1023", "m=2900000", "one block",
                                  "block edges", "block edges, dense"])
def test_k1_design_matches_plain(card, kind, case):
    """The warp search and the vector epilogue, in 4096-doc blocks (rows
    of at most one word per 4 docs) and 1024-doc blocks (denser rows)."""
    h, p, dl = (t.to(card) for t in k1_slice(k1_case(case), K1_NUM_DOCS,
                                             len(case)))
    kw = dict(num_docs=K1_NUM_DOCS, blk_bits=3, kind=kind)
    got = kc.score_term(h, p, dl, 1.25, 37.5, **kw)
    want = kc.score_term_plain(h, p, dl, 1.25, 37.5, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [9000, 1000])
def test_k1_unaligned_pool_rows_match_plain(card, m):
    """Rows of an f32 [R, N] pool with N % 4 != 0 are not 16-byte aligned:
    the epilogue stores them one float at a time."""
    n = 5003
    h, p, dl = (t.to(card) for t in k1_slice(
        np.random.default_rng(1).integers(0, n, m), n, 2))
    pool = torch.full((3, n), -1.0, device=card)
    for kind in KINDS:
        kc.score_term(h, p, dl, 0.5, 20.0, num_docs=n, blk_bits=3, kind=kind,
                      out=pool[1])
        want = kc.score_term_plain(h, p, dl, 0.5, 20.0, num_docs=n,
                                   blk_bits=3, kind=kind)
        assert torch.equal(pool[1], want)
    assert bool((pool[0] == -1).all() and (pool[2] == -1).all())


@pytest.mark.parametrize("num_docs", [1, 1000, 5003, 70_001, 100_003])
def test_k1_rows_match_single_row_calls(card, num_docs):
    """One multi-row launch against a loop of single-row K1 calls: rows of
    every size (empty, one word, whole blocks), written to scattered tf
    rows; the rows it does not name keep their contents."""
    rng = np.random.default_rng(num_docs)
    sizes = [0, 1, 33, 1500, 20_000, 0, 7]
    hs, ps, offs, ns = [], [], [], []
    at = 0
    for i, m in enumerate(sizes):
        h, p, _ = k1_slice(rng.integers(0, num_docs, m), num_docs, i, pad=3)
        hs.append(h)
        ps.append(p)
        offs.append(at)
        ns.append(m)
        at += len(h)
    hdrs, pays = torch.cat(hs).to(card), torch.cat(ps).to(card)
    out_rows = [9, 2, 0, 11, 5, 6, 1]
    pool = torch.full((12, num_docs), -3.0, device=card)
    before = kc.score_term_rows.launches
    kc.score_term_rows(hdrs, pays, offs, ns, pool, out_rows,
                       num_docs=num_docs, blk_bits=3)
    torch.cuda.synchronize()
    assert kc.score_term_rows.launches == before + 1
    dl = torch.ones(num_docs, device=card)
    for off, m, row in zip(offs, ns, out_rows):
        want = kc.score_term(hdrs[off: off + m], pays[off: off + m], dl, 0.0,
                             1.0, num_docs=num_docs, blk_bits=3, kind="none")
        assert torch.equal(pool[row], want)
    keep = [i for i in range(12) if i not in out_rows]
    assert bool((pool[keep] == -3).all())
    # and the plain multi-row version agrees
    plain = torch.full((12, num_docs), -3.0, device=card)
    kc.score_term_rows_plain(hdrs, pays, np.asarray(offs), np.asarray(ns),
                             plain, np.asarray(out_rows), num_docs=num_docs,
                             blk_bits=3)
    assert torch.equal(pool, plain)


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_and_k4_with_the_warp_search(card, seed):
    """K2 and K4 take the shared warp search: ranges on block edges, empty
    blocks, and ids past the output."""
    rng = np.random.default_rng(seed)
    n_out = 10_241
    edges = np.arange(0, n_out, 1024)
    ids = np.sort(np.concatenate([rng.integers(0, n_out, 30_000), edges,
                                  edges[1:] - 1,
                                  np.full(50, n_out + 7),
                                  np.full(50, 2**30)])).astype(np.int32)
    vals = rng.integers(0, 18, len(ids)).astype(np.float32)
    gi, gv = torch.from_numpy(ids).to(card), torch.from_numpy(vals).to(card)
    assert torch.equal(kc.segment_sum(gi, gv, num_docs=n_out),
                       kc.segment_sum_plain(gi, gv, num_docs=n_out))
    hdrs, pays, offs, ns = plane_rows(seed + 20, 4097, 3, 4)
    NS = 4097 << 3
    pools = [torch.full((6, NS), -7, dtype=torch.int32, device=card)
             for _ in range(2)]
    h, p = hdrs.to(card), pays.to(card)
    kc.plane_fill(h, p, offs, ns, [5, 1, 0, 3], pools[0])
    kc.plane_fill_plain(h, p, np.asarray(offs), np.asarray(ns),
                        np.asarray([5, 1, 0, 3]), pools[1])
    torch.cuda.synchronize()
    assert torch.equal(pools[0], pools[1])


# ---------------------------------------------------------------------------
# K7: the merge step of the sparse phrase chain
# ---------------------------------------------------------------------------
K7_BLK_BITS = 3


def posting_lists(seed, sizes, num_docs):
    """Doc-sorted lists of unique int32 headers (num_docs docs of 8
    blocks) with 18-bit payloads, bits 17 and 0 often set, laid end to end
    with their (offsets, lengths)."""
    rng = np.random.default_rng(seed)
    NS = num_docs << K7_BLK_BITS
    hs, ps = [], []
    for n in sizes:
        h = np.unique(rng.integers(0, NS, n)).astype(np.int32)
        p = rng.integers(0, 1 << 18, len(h))
        p[rng.random(len(h)) < 0.3] |= (1 << 17) | 1
        hs.append(h)
        ps.append(p.astype(np.int32))
    ns = np.asarray([len(h) for h in hs], np.int64)
    return (torch.from_numpy(np.concatenate(hs + [np.zeros(1, np.int32)])),
            torch.from_numpy(np.concatenate(ps + [np.zeros(1, np.int32)])),
            kc.prefix_offsets(ns), ns)


def k7_both(card, args, **kw):
    """K7 and its plain version on the same card tensors: bit-equal."""
    before = kc.merge_step.launches
    got = kc.merge_step(*args, **kw)
    want = kc.merge_step_plain(*args, **{k: v for k, v in kw.items()
                                         if k != "need_cont"})
    torch.cuda.synchronize()
    M = int(np.sum(args[4]))
    assert kc.merge_step.launches == before + (1 if M else 0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kw.get("need_cont", True):
        assert torch.equal(got[2], want[2])
    else:
        assert got[2] is None
    return got


@pytest.mark.parametrize("window", [None, (0, 0), (2, 5)])
@pytest.mark.parametrize("cont_side", ["rhs", "lhs"])
@pytest.mark.parametrize("sizes", [(0, 0), (0, 1000), (1000, 0), (1, 1),
                                   (1023, 1025), (5000, 5000),
                                   (300, 2_000_000), (2_000_000, 300),
                                   (3_000_000, 2_500_000)])
def test_k7_kernel_matches_plain(card, sizes, cont_side, window):
    num_docs = max(50, max(sizes) // 3)
    hdrs, pays, offs, ns = posting_lists(sum(sizes) + 1, sizes, num_docs)
    hdrs, pays = hdrs.to(card), pays.to(card)
    mb = dict(min_blk=window[0], max_blk=window[1]) if window else {}
    for need_cont in (True, False):
        k7_both(card, (hdrs, pays, pays, [offs[0]], [ns[0]], [offs[1]],
                       [ns[1]], [offs[1]]), cont_side=cont_side,
                blk_bits=K7_BLK_BITS, need_cont=need_cont, **mb)


@pytest.mark.parametrize("window", [None, (1, 6)])
@pytest.mark.parametrize("cont_side", ["rhs", "lhs"])
@pytest.mark.parametrize("n", [1, 1024, 1025, 700_000])
def test_k7_same_term_step_matches_plain(card, n, cont_side, window):
    hdrs, pays, offs, ns = posting_lists(n, (n,), max(10, n // 5))
    hdrs, pays = hdrs.to(card), pays.to(card)
    mb = dict(min_blk=window[0], max_blk=window[1]) if window else {}
    _, counts, _ = k7_both(card, (hdrs, pays, pays, offs, ns, offs, ns, offs),
                           cont_side=cont_side, same_term=True,
                           blk_bits=K7_BLK_BITS, **mb)
    assert n < 1000 or counts.sum() > 0


@pytest.mark.parametrize("cont_side", ["rhs", "lhs"])
def test_k7_carry_step_and_unaligned_views(card, cont_side):
    """A second step reads the first step's continuation buffer beside the
    first base's headers; the planes are views at an odd word offset."""
    hdrs, pays, offs, ns = posting_lists(3, (40_000, 50_000, 45_000), 30_000)
    pad = torch.zeros(3, dtype=torch.int32)
    hdrs = torch.cat([pad, hdrs]).to(card)[3:]
    pays = torch.cat([pad, pays]).to(card)[3:]
    kw = dict(cont_side=cont_side, blk_bits=K7_BLK_BITS)
    _, _, cont = k7_both(card, (hdrs, pays, pays, [offs[1]], [ns[1]],
                                [offs[0]], [ns[0]], [offs[0]]), **kw)
    carry = torch.cat([pad[:1].to(card), cont])[1:]
    _, counts, _ = k7_both(card, (hdrs, pays, carry, [offs[2]], [ns[2]],
                                  [offs[1]], [ns[1]], [0]), **kw)
    assert counts.sum() > 0


def test_k7_batched_form_with_empty_slices(card):
    sizes = (3000, 200_000, 0, 70_000, 1024, 5, 2048)
    hdrs, pays, offs, ns = posting_lists(9, sizes, 60_000)
    hdrs, pays = hdrs.to(card), pays.to(card)
    base = [1, 2, 0, 4, 3, 6, 5]    # query 1 has no base words,
    other = [0, 1, 2, 3, 4, 5, 6]   # query 2 no other words
    stride = 60_416
    keys, counts, _ = k7_both(
        card, (hdrs, pays, pays, offs[base], ns[base], offs[other],
               ns[other], offs[other]), cont_side="rhs",
        blk_bits=K7_BLK_BITS, key_stride=stride)
    assert bool((keys[1:] >= keys[:-1]).all())
    got = kc.segment_sum(keys, counts, num_docs=len(base) * stride)
    want = kc.segment_sum_plain(keys, counts, num_docs=len(base) * stride)
    assert torch.equal(got, want)
    assert not got.reshape(len(base), stride)[2].any()


@pytest.mark.parametrize("aligned", [True, False])
def test_k7_one_launch_mixes_directions_and_same_term_steps(card, aligned):
    """One launch of queries that step left to right and right to left,
    same-term first steps among them, some writing the continuation: more
    tiles than the grid holds (3M base words), a 300-word base list whose
    2M other words overflow every staged window, empty slices; the planes
    as views at an odd word offset (4-byte copies) or aligned."""
    sizes = (3_000_000, 2_500_000, 300, 2_000_000, 1024, 0, 70_000, 5)
    hdrs, pays, offs, ns = posting_lists(11, sizes, 1_000_000)
    shift = 0 if aligned else 3
    pad = torch.zeros(shift, dtype=torch.int32)
    hdrs = torch.cat([pad, hdrs]).to(card)[shift:]
    pays = torch.cat([pad, pays]).to(card)[shift:]
    base = np.asarray([0, 2, 3, 4, 6, 5, 7, 1])
    other = np.asarray([1, 3, 2, 4, 5, 6, 0, 1])
    sides = ["rhs", "lhs", "rhs", "lhs", "rhs", "lhs", "lhs", "rhs"]
    same = [False, False, False, True, False, False, False, True]
    need = [True, False, True, True, False, True, True, False]
    stride = 1 << 20
    args = (hdrs, pays, pays, offs[base], ns[base], offs[other], ns[other],
            offs[other])
    for window in (None, (2, 6)):
        mb = (dict(min_blk=window[0], max_blk=window[1]) if window else {})
        before = kc.merge_step.launches
        got = kc.merge_step(*args, cont_side=sides, same_term=same,
                            need_cont=need, blk_bits=K7_BLK_BITS,
                            key_stride=stride, **mb)
        want = kc.merge_step_plain(*args, cont_side=sides, same_term=same,
                                   blk_bits=K7_BLK_BITS, key_stride=stride,
                                   **mb)
        torch.cuda.synchronize()
        assert kc.merge_step.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        rows = torch.from_numpy(np.repeat(need, ns[base])).to(card)
        assert torch.equal(got[2][rows], want[2][rows])
        assert got[1].sum() > 0


def test_k7_rejects_bad_requests(card):
    hdrs, pays, offs, ns = posting_lists(2, (100, 100), 50)
    hdrs, pays = hdrs.to(card), pays.to(card)
    args = [hdrs, pays, pays, [offs[0]], [ns[0]], [offs[1]], [ns[1]],
            [offs[1]]]
    with pytest.raises(ValueError, match="cont_side"):
        kc.merge_step(*args, cont_side="mid", blk_bits=K7_BLK_BITS)
    with pytest.raises(ValueError, match="past"):
        kc.merge_step(*args[:6], [ns[1] + 2], [offs[1]], cont_side="rhs",
                      blk_bits=K7_BLK_BITS)
    with pytest.raises(ValueError):
        kc.merge_step(hdrs, pays.cpu(), pays, *args[3:], cont_side="rhs",
                      blk_bits=K7_BLK_BITS)


def test_sparse_phrase_path_on_card_matches_cpu(card, monkeypatch):
    """Windowed phrases, and a corpus that is not dense-eligible, through
    the facade on the card and on the CPU."""
    from searcharray_tpu_torch.search import dense

    rng = np.random.default_rng(31)
    vocab = ["red", "fox", "the", "dog"] + [f"w{i}" for i in range(12)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 70)))
            for _ in range(5000)]
    cpu = SearchArray.index(docs, device="cpu")
    gpu = SearchArray.index(docs, device="cuda")
    qs = [["red", "fox"], ["the", "the"], "dog", ["the", "red", "fox", "w3"],
          ["fox", "red", "fox"], ["w1", "the", "red", "w2", "fox"]]
    before = kc.merge_step.launches
    for q in qs:
        if isinstance(q, list):
            win = dict(min_posn=18, max_posn=53)
            np.testing.assert_array_equal(gpu.termfreqs(q, **win),
                                          cpu.termfreqs(q, **win))
            np.testing.assert_allclose(gpu.score(q, **win),
                                       cpu.score(q, **win), rtol=1e-6,
                                       atol=1e-7)
    monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
    for block in (True, False):
        ws, wi = cpu.score_batch(qs, top_k=10)
        out = gpu.score_batch(qs, top_k=10, block=block)
        gs, gi = out if block else out()
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
    assert kc.merge_step.launches > before


# ---------------------------------------------------------------------------
# K3: exact top-k
# ---------------------------------------------------------------------------
K3_TILE = 16384   # elements of a row per block of the radix select
K3_SORT_CAP = 2048


@pytest.fixture
def k3_lib(card):
    """The two-launch path's tile and k cap, as the library reports them."""
    lib = kc._get_lib()
    return lib.sa_topk_tile(), lib.sa_topk_one_pass_cap()


def k3_both(card, x, k):
    """K3 and its plain version on the same card tensor: values and
    indices equal exactly."""
    gx = torch.from_numpy(x).to(card)
    before = kc.topk.launches
    vals, idx = kc.topk(gx, k)
    want_v, want_i = kc.topk_plain(gx, k)
    torch.cuda.synchronize()
    assert kc.topk.launches == before + 1
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    assert vals.shape == idx.shape == gx.shape[:-1] + (k,)
    assert torch.equal(idx.long(), want_i)
    # bit for bit: -0.0 comes back as -0.0
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    return vals, idx


def k3_rows(name, rng, q, n):
    if name == "distinct":
        return rng.random((q, n)).astype(np.float32)
    if name == "few levels":       # heavy ties at every rank
        return (rng.integers(0, 5, (q, n)) / 7).astype(np.float32)
    if name == "one value":
        return np.full((q, n), 2.5, np.float32)
    if name == "zeros":
        return np.zeros((q, n), np.float32)
    if name == "few positive":     # fewer than k positive scores
        x = np.zeros((q, n), np.float32)
        for r in range(q):
            hot = rng.choice(n, size=min(n, 3), replace=False)
            x[r, hot] = rng.random(len(hot)).astype(np.float32) + 1
        return x
    if name == "signed zeros and -inf":
        x = rng.standard_normal((q, n)).astype(np.float32)
        x[rng.random((q, n)) < 0.3] = -np.inf
        x[rng.random((q, n)) < 0.2] = -0.0
        x[rng.random((q, n)) < 0.2] = 0.0
        return x
    if name == "all -inf":
        return np.full((q, n), -np.inf, np.float32)
    if name == "bm25-like":        # mostly zero, positive scores with ties
        x = np.zeros((q, n), np.float32)
        mask = rng.random((q, n)) < 0.05
        x[mask] = (rng.integers(1, 40, int(mask.sum())) / 3).astype(
            np.float32)
        return x
    raise KeyError(name)


K3_DATA = ["distinct", "few levels", "one value", "zeros", "few positive",
           "signed zeros and -inf", "all -inf", "bm25-like"]


@pytest.mark.parametrize("k", [1, 10, 100, K3_SORT_CAP, K3_SORT_CAP + 1])
@pytest.mark.parametrize("data", K3_DATA)
def test_k3_kernel_matches_plain(card, data, k):
    """Both sides of the in-kernel sort's cap, N off the tile size and off
    a multiple of 4 (the 4-byte loads)."""
    rng = np.random.default_rng(k + len(data))
    for q, n in ((3, 3 * K3_TILE + 1237), (2, 40_000)):
        k3_both(card, k3_rows(data, rng, q, n), k)


@pytest.mark.parametrize("q", [1, 2, 7, 64, 150])
def test_k3_row_counts(card, q):
    rng = np.random.default_rng(q)
    k3_both(card, k3_rows("bm25-like", rng, q, 70_001), 10)


@pytest.mark.parametrize("n,k", [(1, 1), (5, 5), (5, 1), (2049, 2049),
                                 (K3_TILE, K3_TILE), (3 * K3_TILE + 5, 5000),
                                 (100_003, 100_003)])
def test_k3_k_up_to_n(card, n, k):
    rng = np.random.default_rng(n + k)
    for data in ("distinct", "few levels", "zeros"):
        k3_both(card, k3_rows(data, rng, 2, n), k)


@pytest.mark.parametrize("k", [1, 10, 3000])
def test_k3_ties_across_tile_edges(card, k3_lib, k):
    """Runs of the k-th value that start, end and straddle tile edges: the
    earliest indices win.  At the two-launch path's tile (read from the
    library) and at the radix select's 16,384."""
    for tile in sorted({k3_lib[0], K3_TILE}):
        n = 4 * tile
        x = np.zeros((4, n), np.float32)
        for r, at in enumerate((tile - 2, tile - 1, tile,
                                2 * tile - k // 2)):
            x[r, at: at + k + 3] = 7.0       # k + 3 ties for k places
            x[r, 3 * tile + 5] = 9.0         # and one score above them
        vals, idx = k3_both(card, x, k)
        assert idx[0, 0].item() == 3 * tile + 5
        if k > 1:
            assert idx[1, 1].item() == tile - 1


@pytest.mark.parametrize("data", K3_DATA)
@pytest.mark.parametrize("above", [0, 1])
def test_k3_k_at_the_one_pass_cap(card, k3_lib, data, above):
    """k at the two-launch path's cap and one above it (the radix select),
    rows of one, two and several tiles."""
    tile, cap = k3_lib
    rng = np.random.default_rng(above + len(data))
    for q, n in ((5, tile), (3, 2 * tile - 3), (2, 5 * tile + 12)):
        k3_both(card, k3_rows(data, rng, q, n), cap + above)


@pytest.mark.parametrize("n", [1, 7, 100, 4095, "tile-1", "tile",
                               "tile+1"])
@pytest.mark.parametrize("data", ["distinct", "few levels", "zeros",
                                  "signed zeros and -inf"])
def test_k3_rows_shorter_than_a_tile(card, k3_lib, n, data):
    """Rows of one tile, written by one kernel, k from 1 to the row or the
    cap; and the tile plus one, two kernels."""
    tile, cap = k3_lib
    n = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(n, n)
    rng = np.random.default_rng(n)
    x = k3_rows(data, rng, 3, n)
    for k in sorted({1, min(n, 10), min(n, cap)}):
        before = kc.topk.kernels
        k3_both(card, x, k)
        assert kc.topk.kernels - before == (1 if n <= tile else 2)


@pytest.mark.parametrize("n", [16_384, 65_536])
@pytest.mark.parametrize("q", [1, 2, 7, 64, 200])
def test_k3_candidate_axis(card, n, q):
    """The candidate axis as finish_candidates ranks it: Kc of 16,384 or
    65,536, BM25-like scores (mostly 0, ties) at the candidates and -1 at
    the pad slots behind them (every slot of some rows, none of others)."""
    rng = np.random.default_rng(n + q)
    x = k3_rows("bm25-like", rng, q, n)
    for r in range(q):
        x[r, int(rng.integers(0, n + 1)):] = -1.0
    x[0, :] = -1.0
    if q > 1:
        x[1, n // 2:] = -1.0
    for k in (1, 10, 64):
        k3_both(card, x, k)


def test_k3_signed_zeros_tie(card):
    """-0.0 and +0.0 tie, the smaller index first, and keep their bits."""
    n = 70_001
    x = np.zeros((3, n), np.float32)
    x[0, ::2] = -0.0
    x[1, 40_000:] = -0.0
    x[1, 5] = 1.0
    x[2, :] = -0.0
    x[2, 50_000] = 0.0
    for k in (1, 10, 64):
        vals, idx = k3_both(card, x, k)
        assert idx[0].tolist() == list(range(k))
        assert torch.signbit(vals[0]).tolist() == [i % 2 == 0
                                                   for i in range(k)]


@pytest.mark.parametrize("n", [16_384, 1_000_000])
def test_k3_one_pass_is_at_most_two_device_operations(card, k3_lib, n):
    """A call at k = 10 enqueues its tile kernel and, above one tile, its
    merge: no memset, no tie scan, nothing else on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(k3_rows("bm25-like", np.random.default_rng(1), 8,
                                 n)).to(card)
    kc.topk(x, 10)
    torch.cuda.synchronize()
    want = 1 if n <= k3_lib[0] else 2
    for _ in range(3):   # the profiler has been seen to drop events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kc.topk(x, 10)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if ops:
            break
    assert len(ops) == want, ops
    assert all("topk_tile_kernel" in o or "topk_merge_kernel" in o
               for o in ops), ops


def test_k3_one_dimensional_row_and_leading_axes(card):
    rng = np.random.default_rng(3)
    k3_both(card, k3_rows("few levels", rng, 1, 50_000)[0], 10)
    k3_both(card, k3_rows("bm25-like", rng, 6, 9000).reshape(2, 3, 9000), 7)


def test_k3_rejects_bad_requests(card):
    x = torch.zeros((3, 100), device=card)
    for k in (0, 101):
        with pytest.raises(ValueError, match="k must be"):
            kc.topk(x, k)
    with pytest.raises(ValueError, match="contiguous"):
        kc.topk(x.t(), 2)
    with pytest.raises(TypeError):
        kc.topk(x.double(), 2)


def test_k3_enqueues_without_a_host_sync(card):
    """The wrapper reads nothing back: with synchronisation warnings
    raised to errors a call still goes through."""
    x = torch.from_numpy(k3_rows("bm25-like", np.random.default_rng(0), 8,
                                 50_000)).to(card)
    kc.topk(x, 10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, idx = kc.topk(x, 10)
        big_v, big_i = kc.topk(x, K3_SORT_CAP + 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want_v, want_i = kc.topk_plain(x, 10)
    assert torch.equal(idx.long(), want_i) and torch.equal(vals, want_v)
    assert torch.equal(big_i.long(), kc.topk_plain(x, K3_SORT_CAP + 5)[1])


# ---------------------------------------------------------------------------
# K6: the slop window on dense planes
# ---------------------------------------------------------------------------
def k6_both(card, pool, slots, w, mults, anchor, num_docs, blk_bits):
    kw = dict(anchor=anchor, num_docs=num_docs, blk_bits=blk_bits)
    before = kc.span_window.launches
    got = kc.span_window(pool, slots, w, mults, **kw)
    want = kc.span_window_plain(pool, slots, w, mults, **kw)
    torch.cuda.synchronize()
    assert kc.span_window.launches == before + 1
    assert torch.equal(got, want)  # integer counts: bit-equal
    return want


K6_SHAPES = [
    # (blk_bits, num_docs): S = 1 .. 64 and two shapes whose docs span
    # lanes of several warps (S = 512, 4096); no plane is a multiple of a
    # warp's 256 slots
    (0, 2999), (1, 2999), (2, 1001), (3, 3001), (4, 1501), (5, 777),
    (6, 301), (9, 41), (12, 5),
]


@pytest.mark.parametrize("w", list(range(1, 19)))
@pytest.mark.parametrize("blk_bits,num_docs", K6_SHAPES)
def test_k6_kernel_matches_plain(card, blk_bits, num_docs, w):
    """Every window width (two slots a word up to w = 14, one above), with
    multiplicity 1, 2 on one term and 2 on two terms, three queries of a
    group, each anchor column."""
    pool = chain_pool(blk_bits * 100 + w, num_docs, blk_bits, 8,
                      density=0.25).to(card)
    rng = np.random.default_rng(w)
    for T, mults in ((2, (1, 1)), (3, (1, 2, 1)), (3, (2, 1, 2)),
                     (1, (2,))):
        slots = np.stack([rng.permutation(8)[:T] for _ in range(3)])
        want = k6_both(card, pool, slots, w, mults, T - 1, num_docs,
                       blk_bits)
        if w >= 3 and num_docs > 1000 and max(mults) == 1:
            assert float(want.max()) > 0


@pytest.mark.parametrize("T", [2, 3, 5, 8])
def test_k6_term_counts_and_sparse_planes(card, T):
    """T = 2..8 distinct terms on sparse planes (few windows hold them
    all), every anchor."""
    num_docs = 20_001
    pool = chain_pool(T, num_docs, 3, 8, density=0.05).to(card)
    slots = np.stack([np.roll(np.arange(8), r)[:T] for r in range(4)])
    for anchor in range(T):
        k6_both(card, pool, slots, min(18, T + 3), (1,) * T, anchor,
                num_docs, 3)


def test_k6_empty_anchor_plane_and_shared_planes(card):
    """A group of 30 queries over 6 planes (every plane read by many
    queries of one launch); plane 5 is empty, so queries anchored on it
    count nothing and queries holding it match nothing."""
    num_docs = 40_001
    pool = chain_pool(6, num_docs, 3, 6, density=0.3)
    pool[5] = 0
    pool = pool.to(card)
    pairs = np.asarray([(a, b) for a in range(6) for b in range(6)
                        if a != b], np.int32)
    want = k6_both(card, pool, pairs, 4, (1, 1), 0, num_docs, 3)
    empty = (pairs == 5).any(axis=1)
    assert not want[torch.from_numpy(empty).to(card)].any()
    assert float(want.max()) > 0


@pytest.mark.parametrize("blk_bits", [0, 3, 4, 6, 9])
def test_k6_writes_into_tf_pool_rows(card, blk_bits):
    num_docs = 2001 if blk_bits < 9 else 37
    pool = chain_pool(blk_bits + 5, num_docs, blk_bits, 6,
                      density=0.3).to(card)
    tfpool = torch.full((12, num_docs), -1.0, device=card)
    slots = np.asarray([[0, 1, 2], [3, 4, 5], [5, 1, 2]], np.int32)
    rows = [11, 0, 6]
    kw = dict(anchor=0, num_docs=num_docs, blk_bits=blk_bits)
    kc.span_window(pool, slots, 5, (1, 2, 1), out=tfpool, out_rows=rows,
                   **kw)
    want = kc.span_window_plain(pool, slots, 5, (1, 2, 1), **kw)
    torch.cuda.synchronize()
    assert torch.equal(tfpool[rows], want)
    keep = [i for i in range(12) if i not in rows]
    assert bool((tfpool[keep] == -1).all())


def test_k6_last_slot_bit17_reads_across_the_doc_boundary(card):
    """Shifts run over the flat slot axis: bit 17 of a doc's last slot and
    bit 0 of the next doc's first slot are one position apart."""
    pool = torch.zeros((2, 4), dtype=torch.int32)
    pool[0, 1] = 1 << 17       # doc 0, last slot, position 35
    pool[1, 2] = 1             # doc 1, first slot, position 0
    pool = pool.to(card)
    for anchor, want in ((0, [1.0, 0.0]), (1, [0.0, 1.0])):
        got = k6_both(card, pool, [[0, 1]], 1, (1, 1), anchor, 2, 1)
        assert got[0].tolist() == want


def test_k6_unaligned_pool_rows(card):
    """Pool rows that are not 16-byte aligned take the 4-byte loads."""
    num_docs = 1001  # 1001 * 2 slots: rows of 8008 bytes, but a view at +1
    base = chain_pool(2, num_docs, 1, 4, density=0.3)
    flat = torch.zeros(4 * 2 * num_docs + 1, dtype=torch.int32)
    flat[1:] = base.reshape(-1)
    pool = flat.to(card)[1:].view(4, 2 * num_docs)
    k6_both(card, pool, [[0, 1], [2, 3]], 6, (1, 1), 0, num_docs, 1)


def test_k6_rejects_bad_requests(card):
    pool = chain_pool(1, 100, 3, 4).to(card)
    kw = dict(num_docs=100, blk_bits=3)
    with pytest.raises(ValueError, match="window"):
        kc.span_window(pool, [[0, 1]], 19, (1, 1), **kw)
    with pytest.raises(ValueError, match="multiplicities"):
        kc.span_window(pool, [[0, 1]], 5, (1, 3), **kw)
    with pytest.raises(ValueError, match="anchor"):
        kc.span_window(pool, [[0, 1]], 5, (1, 1), anchor=2, **kw)
    with pytest.raises(ValueError, match="out of range"):
        kc.span_window(pool, [[0, 4]], 5, (1, 1), **kw)


def test_slop_path_on_card_matches_cpu(card):
    """Slop phrases through the facade on the card and on the CPU: score,
    termfreqs, and three mixed batches (group, promotion, cached rows)."""
    rng = np.random.default_rng(41)
    vocab = ["red", "fox", "the", "dog"] + [f"w{i}" for i in range(20)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 60)))
            for _ in range(3000)]
    gpu = SearchArray.index(docs, device="cuda")
    cpu = SearchArray.index(docs, device="cpu")
    cases = [(["red", "fox"], 1), (["the", "red", "the"], 2),
             (["w1", "the", "fox"], 4), (["dog", "dog"], 15),
             (["red", "w2"], 3)]
    before = kc.span_window.launches
    for ph, slop in cases:
        np.testing.assert_array_equal(gpu.termfreqs(ph, slop=slop),
                                      cpu.termfreqs(ph, slop=slop))
        for _ in range(3):  # window kernel, promotion, cached row
            np.testing.assert_allclose(gpu.score(ph, slop=slop),
                                       cpu.score(ph, slop=slop), rtol=1e-6,
                                       atol=1e-7)
    qs = ["red", ["red", "fox"], "w3"] + [ph for ph, _ in cases]
    slops = [0, 0, 0] + [s for _, s in cases]
    for _ in range(3):
        want = cpu.score_batch(qs, top_k=10, slop=slops)
        for got in (gpu.score_batch(qs, top_k=10, slop=slops),
                    gpu.score_batch(qs, top_k=10, slop=slops,
                                    block=False)()):
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6,
                                       atol=1e-7)
    assert kc.span_window.launches > before


# ---------------------------------------------------------------------------
# K9: slop window coverage on the posting slices
# ---------------------------------------------------------------------------
def k9_lists(seed, sizes, num_docs, blk_bits, sparse_bits=False):
    """Doc-sorted lists of unique int32 headers over ``num_docs`` docs of
    ``1 << blk_bits`` blocks, 18-bit payloads with bits 17 and 0 often
    set, laid end to end with a PAD tail as a DeviceIndex has it."""
    rng = np.random.default_rng(seed)
    NS = num_docs << blk_bits
    hs, ps = [], []
    for n in sizes:
        h = np.unique(rng.integers(0, NS, n)).astype(np.int32)
        p = rng.integers(0, 1 << 18, len(h)) & rng.integers(0, 1 << 18,
                                                             len(h))
        if sparse_bits:
            p &= rng.integers(0, 1 << 18, len(h))
        p[rng.random(len(h)) < 0.2] |= (1 << 17) | 1
        hs.append(h)
        ps.append(p.astype(np.int32))
    ns = np.asarray([len(h) for h in hs], np.int64)
    return (torch.from_numpy(np.concatenate(hs + [np.full(16, PAD_HDR32,
                                                          np.int32)])),
            torch.from_numpy(np.concatenate(ps + [np.zeros(16, np.int32)])),
            kc.prefix_offsets(ns), ns)


def k9_both(card, hdrs, pays, offs, ns, w, mults, **kw):
    """K9 and its plain version on the same card tensors: bit-equal."""
    before = kc.span_sparse.launches
    got = kc.span_sparse(hdrs, pays, offs, ns, w, mults, **kw)
    want = kc.span_sparse_plain(hdrs, pays, offs, ns, w, mults, **kw)
    torch.cuda.synchronize()
    M = int(np.asarray(ns)[:, kw.get("anchor", 0)].sum())
    assert kc.span_sparse.launches == before + (1 if M else 0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if w <= kc.SPAN_MAX_WINDOW and max(mults) <= 2:
        # that was the 64-bit word path: the walked path gives the same
        walked = kc._span_sparse(hdrs, pays, offs, ns, w, mults,
                                 walked=True, **kw)
        assert torch.equal(walked[0], want[0])
        assert torch.equal(walked[1], want[1])
    return got


@pytest.mark.parametrize("w", list(range(1, 19)))
@pytest.mark.parametrize("mults,anchor", [((1, 1), 0), ((2,), 0),
                                          ((2, 1), 1), ((1, 2, 2), 2)])
def test_k9_word_path_every_window(card, mults, anchor, w):
    """Dense lists (most headers have both neighbours) at every window the
    word path takes, with and without a block window."""
    sizes = (300_000, 250_000, 120_000)[:len(mults)]
    hdrs, pays, offs, ns = k9_lists(w * 5 + len(mults), sizes, 20_000, 4,
                                    sparse_bits=w > 6)
    hdrs, pays = hdrs.to(card), pays.to(card)
    for mb in ({}, dict(min_blk=1, max_blk=3)):
        _, counts = k9_both(card, hdrs, pays, [offs], [ns], w, mults,
                            anchor=anchor, blk_bits=4, **mb)
        assert counts.sum() > 0


@pytest.mark.parametrize("window", [None, (0, 0), (1, 5)])
@pytest.mark.parametrize("w", [1, 3, 18, 19, 40, 200])
@pytest.mark.parametrize("sizes,mults,anchor", [
    ((0, 1000), (1, 1), 0), ((1000, 0), (1, 1), 0), ((1, 1), (1, 1), 1),
    ((255, 257), (1, 1), 0), ((4000, 5000), (1, 2), 0),
    ((300, 200_000), (1, 1), 0), ((200_000, 300), (2, 1), 1),
    ((150_000,), (2,), 0), ((60_000,), (3,), 0),
    ((30_000, 250_000, 90_000), (1, 1, 2), 0),
    ((500_000, 400_000), (1, 1), 1)])
def test_k9_kernel_matches_plain(card, sizes, mults, anchor, w, window):
    num_docs = max(50, max(sizes) // 3)
    hdrs, pays, offs, ns = k9_lists(sum(sizes) + w, sizes, num_docs, 3,
                                    sparse_bits=w > 30)
    mb = dict(min_blk=window[0], max_blk=window[1]) if window else {}
    _, counts = k9_both(card, hdrs.to(card), pays.to(card), [offs], [ns], w,
                        mults, anchor=anchor, blk_bits=3, **mb)
    if min(sizes) >= 4000 and w >= 3 and window != (0, 0):
        assert counts.sum() > 0


@pytest.mark.parametrize("blk_bits", [0, 1, 2, 8, 14])
@pytest.mark.parametrize("w", [2, 18, 19, 37])
def test_k9_neighbourhoods_stay_inside_their_document(card, blk_bits, w):
    """Dense lists, so nearly every header has both neighbours: a word of
    a document's first or last block must not read the next document's."""
    num_docs = max(3, 40_000 >> blk_bits)
    total = num_docs << blk_bits
    hdrs, pays, offs, ns = k9_lists(blk_bits * 100 + w,
                                    (total * 2, total * 2, total // 3),
                                    num_docs, blk_bits)
    hdrs, pays = hdrs.to(card), pays.to(card)
    for anchor in (0, 2):
        _, counts = k9_both(card, hdrs, pays, [offs], [ns], w, (1, 1, 1),
                            anchor=anchor, blk_bits=blk_bits)
        assert counts.sum() > 0


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 8, 9, 12, 40])
def test_k9_term_counts_on_both_sides_of_the_local_state(card, T):
    """Up to sa_span_sparse_local_terms() distinct terms a thread's state
    on the walked path is in registers (the kernel instantiated for T),
    above it in the wrapper's scratch buffer; the first four terms are
    staged in shared memory, the rest read in device memory."""
    assert kc._get_lib().sa_span_sparse_local_terms() == 4
    rng = np.random.default_rng(T)
    sizes = tuple(int(x) for x in rng.integers(20_000, 60_000, T))
    hdrs, pays, offs, ns = k9_lists(T, sizes, 2000, 3)
    hdrs, pays = hdrs.to(card), pays.to(card)
    mults = tuple(int(x) for x in rng.integers(1, 3, T))
    for w in (T + 2, 3 * T + 20):
        _, counts = k9_both(card, hdrs, pays, [offs], [ns], w, mults,
                            anchor=T // 2, blk_bits=3)
    assert counts.sum() > 0


@pytest.mark.parametrize("w,mults", [(4, (1, 1, 2)), (25, (1, 1, 2)),
                                     (6, (1, 3, 1))])
def test_k9_stage_overflow_and_more_tiles_than_the_grid(card, w, mults):
    """A 3M-word anchor list (more tiles than the card holds blocks), a
    300-word anchor whose terms' ranges overflow every staged window, and
    a query whose terms have no word in its range, in one launch."""
    sizes = (3_000_000, 2_000_000, 2_500_000, 300, 0)
    hdrs, pays, offs, ns = k9_lists(w, sizes, 1_000_000, 3)
    hdrs, pays = hdrs.to(card), pays.to(card)
    cols = np.asarray([[0, 1, 2], [3, 1, 2], [4, 0, 1], [1, 4, 3]])
    for window in (None, (1, 6)):
        mb = (dict(min_blk=window[0], max_blk=window[1]) if window else {})
        _, counts = k9_both(card, hdrs, pays, offs[cols], ns[cols], w, mults,
                            blk_bits=3, key_stride=1 << 20, **mb)
        assert counts.sum() > 0


def test_k9_batched_form_with_empty_slices_and_unaligned_views(card):
    sizes = (3000, 200_000, 0, 70_000, 256, 5, 2048, 1)
    hdrs, pays, offs, ns = k9_lists(9, sizes, 60_000, 3)
    pad = torch.zeros(3, dtype=torch.int32)
    hdrs = torch.cat([pad, hdrs]).to(card)[3:]
    pays = torch.cat([pad, pays]).to(card)[3:]
    cols = np.asarray([[1, 0], [2, 3], [3, 2], [4, 6], [5, 7], [7, 1],
                       [6, 6]])   # query 1 has no anchor words, query 2
    stride = 60_416               # no words of its other term
    for window in (None, (2, 6)):
        mb = (dict(min_blk=window[0], max_blk=window[1]) if window else {})
        keys, counts = k9_both(card, hdrs, pays, offs[cols], ns[cols], 5,
                               (1, 1), blk_bits=3, key_stride=stride, **mb)
        assert bool((keys[1:] >= keys[:-1]).all())
        got = kc.segment_sum(keys, counts, num_docs=len(cols) * stride)
        want = kc.segment_sum_plain(keys, counts,
                                    num_docs=len(cols) * stride)
        assert torch.equal(got, want)
        rows = got.reshape(len(cols), stride)
        assert not rows[1].any() and not rows[2].any() and rows[0].any()


def test_k9_reads_nothing_past_the_last_list(card):
    """The last list of the planes ends at the PAD tail: a search for a
    header above its last one must stop at the list's length."""
    hdrs = torch.tensor([0, 1, 2, 5, 6, 7] + [PAD_HDR32] * 8,
                        dtype=torch.int32, device=card)
    pays = torch.tensor([1 << 17, 1, 1 << 17, 7, 1, 1 << 9] + [0] * 8,
                        dtype=torch.int32, device=card)
    for blk_bits in (0, 1, 3):
        for w in (1, 2, 18, 30):
            k9_both(card, hdrs, pays, [[0, 3]], [[3, 3]], w, (1, 1),
                    anchor=1, blk_bits=blk_bits)
            k9_both(card, hdrs, pays, [[0, 3]], [[3, 3]], w, (1, 1),
                    anchor=0, blk_bits=blk_bits)


def test_k9_enqueues_without_a_host_sync(card):
    hdrs, pays, offs, ns = k9_lists(5, (40_000, 50_000), 9000, 3)
    hdrs, pays = hdrs.to(card), pays.to(card)
    kc.span_sparse(hdrs, pays, [offs], [ns], 4, (1, 1), blk_bits=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keys, counts = kc.span_sparse(hdrs, pays, [offs], [ns], 4, (1, 1),
                                      blk_bits=3, key_stride=9216)
        kc.segment_sum(keys, counts, num_docs=9216)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_k9_rejects_bad_requests(card):
    hdrs, pays, offs, ns = k9_lists(2, (100, 100), 50, 3)
    hdrs, pays = hdrs.to(card), pays.to(card)
    with pytest.raises(ValueError, match="window"):
        kc.span_sparse(hdrs, pays, [offs], [ns], 0, (1, 1), blk_bits=3)
    with pytest.raises(ValueError, match="past"):
        kc.span_sparse(hdrs, pays, [offs], [ns + 200], 3, (1, 1), blk_bits=3)
    with pytest.raises(ValueError):
        kc.span_sparse(hdrs, pays.cpu(), [offs], [ns], 3, (1, 1), blk_bits=3)


def test_sparse_slop_path_on_card_matches_cpu(card, monkeypatch):
    """Slop phrases the dense window cannot take (a position window, a
    wide window, a term three times) and a corpus that is not
    dense-eligible, through the facade and edismax on the card and on the
    CPU."""
    import pandas as pd

    from searcharray_tpu_torch import edismax, edismax_batch
    from searcharray_tpu_torch.search import dense

    rng = np.random.default_rng(33)
    vocab = ["red", "fox", "the", "dog"] + [f"w{i}" for i in range(12)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 70)))
            for _ in range(5000)]
    cpu = SearchArray.index(docs, device="cpu")
    gpu = SearchArray.index(docs, device="cuda")
    before = kc.span_sparse.launches
    for q, slop, win in ((["red", "fox"], 2, dict(min_posn=18, max_posn=53)),
                         (["red", "fox", "dog"], 20, {}),
                         (["the", "the", "the"], 4, {}),
                         (["the", "w1", "the", "the"], 30, {})):
        np.testing.assert_array_equal(gpu.termfreqs(q, slop=slop, **win),
                                      cpu.termfreqs(q, slop=slop, **win))
        np.testing.assert_allclose(gpu.score(q, slop=slop, **win),
                                   cpu.score(q, slop=slop, **win),
                                   rtol=1e-6, atol=1e-7)
    qs = [["red", "fox"], ["the", "the"], "dog", ["the", "red", "fox", "w3"],
          ["fox", "red", "fox", "fox"], ["w1", "the"], ["w1", "the"]]
    sl = [2, 1, 0, 20, 3, 18, 0]
    frames = [pd.DataFrame({"title": SearchArray.index(
        [" ".join(d.split()[:8]) for d in docs], device=d_), "body": a})
        for d_, a in (("cpu", cpu), ("cuda", gpu))]
    kw = dict(qf=["title^2", "body"], mm="2<75%", tie=0.1,
              pf=["title", "body"], pf2=["body"], ps=20, ps2=1)
    eq = ["the red fox", "dog w3", "w1 the w2 fox"]
    for dense_ok in (True, False):
        if not dense_ok:
            monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
        for block in (True, False):
            ws, wi = cpu.score_batch(qs, top_k=10, slop=sl)
            out = gpu.score_batch(qs, top_k=10, slop=sl, block=block)
            gs, gi = out if block else out()
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
        want, wexp = edismax_batch(frames[0], eq, **kw)
        got, gexp = edismax_batch(frames[1], eq, **kw)
        assert gexp == wexp
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for q in eq:
            (ws, wi), _ = edismax(frames[0], q, top_k=5, **kw)
            (gs, gi), _ = edismax(frames[1], q, top_k=5, **kw)
            np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-6)
    assert kc.span_sparse.launches > before


# ---------------------------------------------------------------------------
# K8a and K8b: candidate rows and mini-planes
# ---------------------------------------------------------------------------
K8A_TILE = 2048   # words of a K8a tile (csrc/cand_rows.cu)


def cand_slices(seed, sizes, num_docs, blk_bits, near=0.5):
    """Doc-sorted slices of unique headers laid end to end (a PAD tail
    behind them): a fraction ``near`` of the words of every slice after
    the first lie in the first slice's docs.  (hdrs, pays, offs)."""
    rng = np.random.default_rng(seed)
    S = 1 << blk_bits
    hdrs, pays, offs, at = [], [], [], 0
    for n in sizes:
        pick = np.asarray([], np.int64)
        if hdrs and len(hdrs[0]):
            m = int(n * near)
            pick = np.unique(rng.choice(np.unique(hdrs[0] >> blk_bits), m)
                             * S + rng.integers(0, S, m))
        rest = rng.choice(num_docs * S, size=min(num_docs * S, 2 * n + 8),
                          replace=False)
        rest = np.setdiff1d(rest, pick)[: n - len(pick)]
        flat = np.sort(np.concatenate([pick, rest]))
        hdrs.append(flat.astype(np.int32))
        pays.append(rng.integers(1, 1 << 18, len(flat)).astype(np.int32))
        offs.append(at)
        at += len(flat)
    hdrs.append(np.full(64, PAD_HDR32, np.int32))
    pays.append(np.zeros(64, np.int32))
    return (torch.from_numpy(np.concatenate(hdrs)),
            torch.from_numpy(np.concatenate(pays)), offs,
            [len(h) for h in hdrs[:-1]])


def k8a_both(card, hdrs, pays, offs, ns, kc_, num_docs, blk_bits, with_tf):
    kw = dict(num_docs=num_docs, blk_bits=blk_bits, with_tf=with_tf)
    before = kc.cand_rows.launches
    got = kc.cand_rows(hdrs.to(card), pays.to(card), offs, ns, kc_, **kw)
    want = kc.cand_rows_plain(hdrs, pays, np.asarray(offs), np.asarray(ns),
                              kc_, **kw)
    torch.cuda.synchronize()
    assert kc.cand_rows.launches == before + 1
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:   # integers, and tf sums of small integers
            assert torch.equal(g.cpu(), w)
    return want


@pytest.mark.parametrize("with_tf", [True, False])
@pytest.mark.parametrize("sizes,num_docs,kc_", [
    ([0], 100, 4096), ([1], 100, 4096), ([1, 0, 1], 5, 8),
    ([K8A_TILE - 1, K8A_TILE, K8A_TILE + 1], 700, 4096),
    ([5 * K8A_TILE + 3], 2_000, 16_384), ([65_000], 40_000, 65_536),
    ([3000, 20, 3000, 1], 900, 1024), ([400], 1000, 16)])
def test_k8a_kernel_matches_plain(card, sizes, num_docs, kc_, with_tf):
    """Runs of one doc across tile edges (few docs, many blocks each), a
    row table exactly full, one too small (runs dropped), empty slices."""
    hdrs, pays, offs, ns = cand_slices(sum(sizes) + num_docs, sizes,
                                       num_docs, 3, near=0.0)
    rows, _ = k8a_both(card, hdrs, pays, offs, ns, kc_, num_docs, 3, with_tf)
    distinct = [len(np.unique(hdrs[o: o + n].numpy() >> 3))
                for o, n in zip(offs, ns)]
    for r, d in zip(rows, distinct):
        assert int((r < num_docs).sum()) == min(d, kc_)


@pytest.mark.parametrize("with_tf", [True, False])
def test_k8a_runs_across_many_tiles_and_many_queries(card, with_tf):
    """Docs of thousands of words (blk_bits 14), so one run spans several
    tiles, and a chunk of 70 queries, empty ones between them, whose tiles
    share one launch."""
    hdrs, pays, offs, ns = cand_slices(5, [3 * K8A_TILE + 5, 40, 0], 3, 14,
                                       near=0.0)
    rows, _ = k8a_both(card, hdrs, pays, offs, ns, 8, 3, 14, with_tf)
    docs, words = np.unique(hdrs[: ns[0]].numpy() >> 14, return_counts=True)
    assert int((rows[0] < 3).sum()) == len(docs) and words.max() > K8A_TILE
    sizes = [(i * 977) % 5000 if i % 4 else 0 for i in range(70)]
    hdrs, pays, offs, ns = cand_slices(6, sizes, 3000, 3, near=0.0)
    k8a_both(card, hdrs, pays, offs, ns, 4096, 3000, 3, with_tf)


def test_k8a_full_table_and_pad_only_table(card):
    # every doc once per block: a table of exactly the distinct docs
    n_docs, bb = 3000, 3
    h = (np.repeat(np.arange(n_docs), 3) << bb | np.tile([0, 2, 5], n_docs))
    hdrs = torch.from_numpy(np.concatenate(
        [h, [PAD_HDR32] * 8]).astype(np.int32))
    pays = torch.ones_like(hdrs)
    rows, tf = k8a_both(card, hdrs, pays, [0, 0], [len(h), 0], n_docs,
                        n_docs, bb, True)
    assert torch.equal(rows[0], torch.arange(n_docs, dtype=torch.int32))
    assert bool((rows[1] == n_docs).all()) and bool((tf[1] == 0).all())
    assert bool((tf[0] == 3).all())


@pytest.mark.parametrize("blk_bits,num_docs", [(3, 20_000), (0, 50_000),
                                               (12, 300), (14, 80)])
def test_k8b_kernel_matches_plain(card, blk_bits, num_docs):
    """Pool and own-slice terms in one launch, mini misses (half of each
    term's words lie outside the rows), sentinel rows past the
    candidates, S = 8 and docs wider than a tile."""
    S = 1 << blk_bits
    sizes = [min(900, num_docs * S // 4), min(4000, num_docs * S // 3),
             min(2500, num_docs * S // 3), 1]
    hdrs, pays, offs, ns = cand_slices(blk_bits, sizes, num_docs, blk_bits)
    kc_ = 1 << max(3, ns[0].bit_length())
    rows, _ = kc.cand_rows(hdrs, pays, [offs[0]] * 2, [ns[0], ns[0] // 2],
                           kc_, num_docs=num_docs, blk_bits=blk_bits,
                           with_tf=False)
    pool = torch.zeros((3, num_docs * S), dtype=torch.int32)
    kc.plane_fill(hdrs, pays, offs[1:3], ns[1:3], [1, 2], pool)
    slots = [[-1, 1, -1, -1], [2, -1, 1, -1]]
    qoffs, qns = [offs, offs], [ns, ns]
    want = kc.cand_minis(rows, slots, qoffs, qns, pool=pool, hdrs=hdrs,
                         pays=pays, num_docs=num_docs, blk_bits=blk_bits)
    before = kc.cand_minis.launches
    got = kc.cand_minis(rows.to(card), slots, qoffs, qns, pool=pool.to(card),
                        hdrs=hdrs.to(card), pays=pays.to(card),
                        num_docs=num_docs, blk_bits=blk_bits)
    torch.cuda.synchronize()
    assert kc.cand_minis.launches == before + 1
    assert got.shape == (8, kc_ * S)
    assert torch.equal(got.cpu(), want)   # everywhere, sentinel rows too
    assert bool((rows[1] == num_docs).any())   # the sentinel rows
    assert bool(want[2].any()) and bool(want[0].any())


@pytest.mark.parametrize("blk_bits", [0, 1, 2, 3, 4, 5])
def test_k8b_slot_widths_and_tile_edges(card, blk_bits):
    """S = 1 to 32 (scalar copies below 4 slots, 16-byte ones from 4), Kc
    not a multiple of the tile, sentinel rows, and an own slice with no
    word in most tiles' rows (its docs all below 1,000, the rows mostly
    above), one with words but no hit, and an empty one."""
    num_docs, S = 4000, 1 << blk_bits
    rng = np.random.default_rng(blk_bits)
    low = np.sort(rng.choice(1000, 300, replace=False))
    words = np.unique(low[rng.integers(0, 300, 900)] * S
                      + rng.integers(0, S, 900))
    miss = np.unique(rng.choice(np.arange(1000, 1200), 50) * S)
    fill = np.unique(rng.integers(0, num_docs * S, 6000))
    parts = [words, miss, fill]
    hdrs = np.concatenate(parts + [np.full(64, PAD_HDR32)]).astype(np.int32)
    pays = rng.integers(1, 1 << 18, len(hdrs)).astype(np.int32)
    offs = np.cumsum([0] + [len(p) for p in parts])[:3].tolist()
    ns = [len(p) for p in parts]
    hdrs, pays = torch.from_numpy(hdrs), torch.from_numpy(pays)
    pool = torch.zeros((2, num_docs * S), dtype=torch.int32)
    kc.plane_fill(hdrs, pays, [offs[2]], [ns[2]], [1], pool)
    kc_ = 3001
    rows = np.full((2, kc_), num_docs, np.int64)   # sentinel tails
    rows[0, :2000] = np.sort(np.concatenate([
        low[:40], rng.choice(np.arange(1200, num_docs), 1960,
                             replace=False)]))
    rows[1, :2900] = np.sort(rng.choice(num_docs, 2900, replace=False))
    rows = torch.from_numpy(rows.astype(np.int32))
    slots = [[-1, -1, 1, -1], [1, -1, -1, -1]]
    qoffs = [[offs[0], offs[1], 0, 0], [0, offs[1], offs[0], offs[2]]]
    qns = [[ns[0], ns[1], 0, 0], [0, ns[1], ns[0], ns[2]]]
    kw = dict(num_docs=num_docs, blk_bits=blk_bits)
    want = kc.cand_minis(rows, slots, qoffs, qns, pool=pool, hdrs=hdrs,
                         pays=pays, **kw)
    before = kc.cand_minis.launches
    got = kc.cand_minis(rows.to(card), slots, qoffs, qns, pool=pool.to(card),
                        hdrs=hdrs.to(card), pays=pays.to(card), **kw)
    torch.cuda.synchronize()
    assert kc.cand_minis.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert bool(want[0].any()) and not bool(want[1].any())
    assert not bool(want[3].any()) and bool(want[7].any())


def test_k8b_shared_table_and_pad_only_rows(card):
    num_docs, bb = 5000, 3
    hdrs, pays, offs, ns = cand_slices(8, [700, 2000], num_docs, bb)
    pool = torch.zeros((2, num_docs << bb), dtype=torch.int32)
    kc.plane_fill(hdrs, pays, [offs[1]], [ns[1]], [1], pool)
    for rows in (torch.full((4096,), num_docs, dtype=torch.int32),
                 kc.cand_rows(hdrs, pays, [offs[0]], [ns[0]], 4096,
                              num_docs=num_docs, blk_bits=bb)[0][0]):
        args = ([[1, -1], [-1, 1], [-1, -1]], [offs] * 3, [ns] * 3)
        kw = dict(num_docs=num_docs, blk_bits=bb)
        want = kc.cand_minis(rows, *args, pool=pool, hdrs=hdrs, pays=pays,
                             **kw)
        got = kc.cand_minis(rows.to(card), *args, pool=pool.to(card),
                            hdrs=hdrs.to(card), pays=pays.to(card), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def test_k8_enqueue_without_a_host_sync(card):
    num_docs, bb = 20_000, 3
    hdrs, pays, offs, ns = cand_slices(9, [3000, 9000], num_docs, bb)
    hdrs, pays = hdrs.to(card), pays.to(card)
    pool = torch.zeros((2, num_docs << bb), dtype=torch.int32, device=card)
    kc.plane_fill(hdrs, pays, [offs[1]], [ns[1]], [1], pool)
    kw = dict(num_docs=num_docs, blk_bits=bb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows, tf = kc.cand_rows(hdrs, pays, [offs[0]], [ns[0]], 4096, **kw)
        minis = kc.cand_minis(rows, [[-1, 1]], [offs], [ns], pool=pool,
                              hdrs=hdrs, pays=pays, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = kc.cand_minis(rows.cpu(), [[-1, 1]], [offs], [ns], pool=pool.cpu(),
                         hdrs=hdrs.cpu(), pays=pays.cpu(), **kw)
    assert torch.equal(minis.cpu(), want)


def test_candidate_path_on_card_matches_cpu(card, monkeypatch):
    """The forced candidate engine through the facade, and rows=, on the
    card and on the CPU: ranked indices equal, K8a and K8b launched."""
    from searcharray_tpu_torch.search import candidates as cand

    for name, value in (("CAND_MIN_DOCS", 0), ("CAND_TERM_MIN_DOCS", 0),
                        ("CAND_MAX_FRAC", 0), ("MINI_MAX_WORDS", 4096)):
        monkeypatch.setattr(cand, name, value)
    rng = np.random.default_rng(44)
    vocab = ["hot1", "hot2"] + [f"r{i}" for i in range(200)]
    probs = np.concatenate([[0.3, 0.2], np.full(200, 0.5 / 200)])
    docs = [" ".join(rng.choice(vocab, size=rng.integers(4, 60), p=probs))
            for _ in range(20_000)]
    cpu = SearchArray.index(docs, device="cpu")
    gpu = SearchArray.index(docs, device="cuda")
    qs = ["r3", ["r3", "hot1"], ["hot2", "r7", "hot1"], ["r1", "r1"], "r9",
          ["r5", "r6"], "r3"]
    before = (kc.cand_rows.launches, kc.cand_minis.launches)
    for slop in (0, 2):
        for block in (True, False):
            ws, wi = cpu.score_batch(qs, top_k=10, slop=slop)
            out = gpu.score_batch(qs, top_k=10, slop=slop, block=block)
            gs, gi = out if block else out()
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gpu.score_batch(qs, slop=slop),
                                   cpu.score_batch(qs, slop=slop),
                                   rtol=1e-6, atol=1e-7)
    rows = np.arange(1, 20_000, 5)
    np.testing.assert_allclose(
        gpu.score_batch_device(qs, rows=rows).cpu().numpy(),
        cpu.score_batch_device(qs, rows=rows).numpy(), rtol=1e-6, atol=1e-7)
    assert kc.cand_rows.launches > before[0]
    assert kc.cand_minis.launches > before[1]


def test_k8a_no_query_launches_nothing(card):
    before = kc.cand_rows.launches
    rows, tf = kc.cand_rows(torch.zeros(8, dtype=torch.int32, device=card),
                            torch.zeros(8, dtype=torch.int32, device=card),
                            [], [], 16, num_docs=50, blk_bits=3)
    assert rows.shape == tf.shape == (0, 16)
    assert kc.cand_rows.launches == before


@pytest.mark.parametrize("with_tf", [True, False])
@pytest.mark.parametrize("sizes,num_docs,blk_bits,kc_", [
    ([3000, 40, 0], 900, 3, 0),                       # Kc = 0
    ([K8A_TILE * 3 + 7, 5], 2, 14, 8),                # runs over tiles
    ([K8A_TILE + 300, 0, 2 * K8A_TILE, 0, 9], 4, 12, 64),
    ([50_000, 50_000], 30_000, 3, 16_384),            # runs dropped
])
def test_k8a_single_kernel_edges(card, sizes, num_docs, blk_bits, kc_,
                                 with_tf):
    """The shapes of tests/test_torch_cand_tiles.py at the kernel's own
    tile: no table, runs that cross one tile and several (docs
    of thousands of words), empty slices between, tables too small."""
    hdrs, pays, offs, ns = cand_slices(len(sizes) + kc_, sizes, num_docs,
                                       blk_bits, near=0.0)
    k8a_both(card, hdrs, pays, offs, ns, kc_, num_docs, blk_bits, with_tf)


def test_k8a_is_one_kernel_within_the_resident_grid(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    assert kc.CAND_ROWS_KERNELS_PER_LAUNCH == 1
    hdrs, pays, offs, ns = cand_slices(12, [30_000, 9_000, 60_000], 50_000,
                                       3, near=0.3)
    hdrs, pays = hdrs.to(card), pays.to(card)
    kw = dict(num_docs=50_000, blk_bits=3)
    kc.cand_rows(hdrs, pays, offs, ns, 65_536, **kw)   # scratch grown
    torch.cuda.synchronize()
    for _ in range(4):   # the profiler has been seen to drop events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                kc.cand_rows(hdrs, pays, offs, ns, 65_536, **kw)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "cand_rows" in e.name]
        if len(kernels) == 3:
            break
    assert len(kernels) == 3
    assert len({e.name for e in kernels}) == 1
    lib = kc._get_lib()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    grid = lib.sa_cand_rows_grid(3, sum(-(-n // K8A_TILE) for n in ns),
                                 65_536, card.index or 0)
    assert 1 <= grid <= 16 * sms


# ---------------------------------------------------------------------------
# K10: the similarity
# ---------------------------------------------------------------------------
SIM_KINDS = ["bm25", "bm25_legacy", "bm25_impact", "classic"]


def k10_both(card, kind, tf, dl, idf, avgdl=31.7, out_self=False):
    before = kc.similarity.launches
    t = tf.to(card)
    i = idf.to(card) if torch.is_tensor(idf) else idf
    got = kc.similarity(kind, t, dl.to(card), i, avgdl, 1.2, 0.75,
                        out=t if out_self else None)
    want = kc.similarity_plain(kind, tf.to(card), dl.to(card),
                               i[:, None] if torch.is_tensor(i)
                               and tf.dim() == 2 else i, avgdl, 1.2, 0.75)
    torch.cuda.synchronize()
    assert kc.similarity.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.parametrize("kind", SIM_KINDS)
@pytest.mark.parametrize("shape", [(1, 1000), (63, 100_003), (5, 4096),
                                   (17, 33), (40, 1_000_000)])
@pytest.mark.parametrize("lens", ["row", "view", "full"])
@pytest.mark.parametrize("per_row_idf", [False, True])
def test_k10_matches_plain(card, kind, shape, lens, per_row_idf):
    rng = np.random.default_rng(sum(shape))
    Q, N = shape
    tf = torch.from_numpy(rng.integers(0, 20, shape).astype(np.float32))
    dl = rng.integers(1, 400, N if lens != "full" else shape)
    dl = torch.from_numpy(dl.astype(np.float32))
    if lens == "view":
        dl = dl[None, :]
    idf = (torch.from_numpy(rng.uniform(0.5, 9, Q).astype(np.float32))
           if per_row_idf else float(np.float32(rng.uniform(0.5, 9))))
    k10_both(card, kind, tf, dl, idf)


@pytest.mark.parametrize("kind", SIM_KINDS)
def test_k10_one_row_strided_rows_and_in_place(card, kind):
    rng = np.random.default_rng(3)
    dl = torch.from_numpy(rng.integers(1, 90, 999).astype(np.float32))
    one = torch.from_numpy(rng.integers(0, 9, 999).astype(np.float32))
    k10_both(card, kind, one, dl, 2.5)                 # [N], 4-byte path
    big = torch.from_numpy(rng.integers(0, 9, (6, 1024)).astype(np.float32))
    k10_both(card, kind, big[:, :999], dl, 2.5)        # strided rows
    got = k10_both(card, kind, big, dl.new_ones(1024), 1.5, out_self=True)
    assert got.data_ptr() != 0


@pytest.mark.parametrize("kind", ["bm25", "bm25_legacy", "bm25_impact"])
def test_k10_and_k1_fuse_as_the_plain_form_on_near_ties(card, kind):
    """Every (tf, dl) of a 100 x 600 grid, which holds near-ties whose
    per-op and two-FMA scores order them differently: K10 and K1's
    epilogue equal the plain (two-FMA) form bit for bit, and differ from
    the per-op form."""
    tf, dl = torch.meshgrid(torch.arange(1, 101, dtype=torch.float32),
                            torch.arange(1, 601, dtype=torch.float32),
                            indexing="ij")
    got = k10_both(card, kind, tf.reshape(1, -1), dl.reshape(-1), 6.25,
                   avgdl=21.29).cpu()[0]
    x = dl.reshape(-1) / torch.tensor(21.29)
    perop = tf.reshape(-1) + 1.2 * (0.25 + 0.75 * x)
    assert not torch.equal(got, {"bm25": tf.reshape(-1) / perop * 6.25,
                                 "bm25_legacy": 6.25 * (tf.reshape(-1) * 2.2
                                                        / perop),
                                 "bm25_impact": tf.reshape(-1) / perop}[kind])
    # K1 on a slice whose doc d has min(tf(d), 18) set bits (one posting
    # word a doc): the grid's pairs up to tf 18 through the fused epilogue
    n = tf.numel()
    tfs = tf.reshape(-1).clamp(max=18).to(torch.int64).numpy()
    pays = torch.from_numpy(((1 << tfs) - 1).astype(np.int32))
    hdrs = (torch.arange(n, dtype=torch.int32) << 3)
    tf18 = kc.popcount_i32(pays).to(torch.float32)
    want = kc.similarity_plain(kind, tf18, dl.reshape(-1), 6.25, 21.29, 1.2,
                               0.75)
    got1 = kc.score_term(hdrs.to(card), pays.to(card),
                         dl.reshape(-1).to(card), 6.25, 21.29, num_docs=n,
                         blk_bits=3, kind=kind)
    assert torch.equal(got1.cpu(), want)


# ---------------------------------------------------------------------------
# K11: edismax's composition
# ---------------------------------------------------------------------------
def k11_stacks(seed, Ts, n, width=None):
    """Score stacks f32 [T_f, n], half of them 0, as row views of wider
    stacks where ``width`` is given (strided rows, as edismax_batch
    passes)."""
    rng = np.random.default_rng(seed)
    out = []
    for T in Ts:
        s = rng.gamma(1.5, 2.0, size=(T, width or n)).astype(np.float32)
        s[rng.random(s.shape) < 0.5] = 0
        out.append(torch.from_numpy(s)[:, :n])
    return out


@pytest.mark.parametrize("F", [1, 2, 3])
@pytest.mark.parametrize("tie", [0.0, 0.1])
@pytest.mark.parametrize("msm", [1, 3])
@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("n,width", [(100_003, None), (4099, 4160)])
def test_k11_term_centric_matches_plain(card, F, tie, msm, chain, n, width):
    st = k11_stacks(F * 31 + msm, [4] * F, n, width)
    boosts = [1.3, 0.7, 2.9][:F]
    want = kc.compose_plain(st, boosts, tie, msm, term_centric=True,
                            chain=chain)
    before = kc.compose.launches
    got = kc.compose([s.to(card) for s in st], boosts, tie, msm,
                     term_centric=True, chain=chain)
    torch.cuda.synchronize()
    assert kc.compose.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("Ts", [(4,), (4, 3), (4, 2, 3), (3, 0)])
@pytest.mark.parametrize("tie", [0.0, 0.1])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("n,width", [(100_003, None), (4099, 4160)])
def test_k11_field_centric_matches_plain(card, Ts, tie, mask, n, width):
    st = k11_stacks(len(Ts) * 7 + mask, Ts, n, width)
    boosts = [1.3, 0.7, 2.9][:len(Ts)]
    msms = [min(2, t) if mask else min(1, t) for t in Ts]
    want = kc.compose_plain(st, boosts, tie, msms, term_centric=False)
    got = kc.compose([s.to(card) for s in st], boosts, tie, msms,
                     term_centric=False)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_k11_writes_into_a_row_and_takes_no_terms(card):
    st = [s.to(card) for s in k11_stacks(5, [0, 0], 777)]
    out = torch.full((3, 777), -1.0, device=card)
    kc.compose(st, [2.0, 1.0], 0.1, 0, term_centric=True, out=out[1])
    assert bool((out[1] == 0).all() and (out[0] == -1).all()
                and (out[2] == -1).all())
    with pytest.raises(ValueError):
        kc.compose([st[0], st[1].cpu()], [1.0, 1.0], 0.0, 1,
                   term_centric=True)


# ---------------------------------------------------------------------------
# doc-axis sharding on one card: a 4 x 2 mesh of cuda:0 against the
# unsharded port on the same card, bit for bit
# ---------------------------------------------------------------------------
def sharded_docs(seed, n, long_doc=False):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta"] + [f"w{i}" for i in range(60)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 40)))
            for _ in range(n)]
    for d in (0, n // 4 - 1, n // 4, n // 2, n - 1):
        docs[d] = "tie tie alpha"
    if long_doc:   # blk_bits 12: no shard is dense-eligible past its pool
        docs[n // 3] = " ".join(rng.choice(vocab, size=70_000))
    return docs


SHARDED_QUERIES = (["alpha", "w3", "tie", ["alpha", "beta"], ["tie", "alpha"],
                    ["w1", "w2", "w3"], ["beta", "beta"], "nope",
                    ["alpha", "beta"], ["gamma", "delta"]],
                   [0, 0, 0, 0, 0, 0, 0, 0, 2, 3])


@pytest.mark.parametrize("n,long_doc", [(4000, False), (1001, True),
                                        (3, False)])
@pytest.mark.parametrize("forced", [False, True])
def test_sharded_engine_on_card_matches_unsharded(card, monkeypatch, n,
                                                  long_doc, forced):
    from searcharray_tpu_torch.index.builder import build_index
    from searcharray_tpu_torch.parallel import sharded as tsh
    from searcharray_tpu_torch.search import candidates as tcand

    docs = (sharded_docs(7, n, long_doc) if n > 3
            else ["alpha beta", "tie alpha", "beta alpha alpha"])
    if forced:
        for name in ("CAND_MIN_DOCS", "CAND_TERM_MIN_DOCS", "CAND_MAX_FRAC"):
            monkeypatch.setattr(tcand, name, 0)
    single = SearchArray.index(docs, device=card, autowarm=False)
    mesh = tsh.default_mesh(devices=[card] * 8)
    sh = tsh.ShardedIndex.build(build_index(docs), mesh=mesh)
    assert all(d.device.type == "cuda" for d in sh.device_indexes())
    queries, slops = SHARDED_QUERIES
    qt = [single._resolve_tids(q) for q in queries]
    got = sh.score_batch_device(qt, slop=slops)
    assert got.device.type == "cuda"
    want = batch.score_batch_fused(single.dev, qt, slop=slops,
                                   as_device=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    k = min(10, n)
    merges, k3 = tsh.TOPK_MERGES[0], kc.topk.launches
    vals, idx = sh.topk(qt, k, slop=slops)
    assert kc.topk.launches - k3 > 0 and tsh.TOPK_MERGES[0] == merges + 1
    wv, wi = batch.score_batch_fused(single.dev, qt, slop=slops, top_k=k)
    assert np.array_equal(vals.cpu().numpy().view(np.int32), wv.view(np.int32))
    # indices equal where the k-th score is above 0: below it the zero
    # tail ties (a candidate group fills it next to its candidates)
    full = wv[:, -1] > 0
    assert full.any()
    assert np.array_equal(idx.cpu().numpy()[full], wi[full])
    # rows= in the caller's (unsorted) order, each shard scoring its own
    rows = np.random.default_rng(1).permutation(n)[: max(1, n // 3)]
    got_r = sh.score_batch_device(qt, rows=rows)
    want_r = batch.score_batch_fused(single.dev, qt, as_device=True)[
        :, torch.as_tensor(rows, device=card)]
    assert torch.equal(got_r.view(torch.int32), want_r.view(torch.int32))


def test_sharded_engine_across_cards_matches_unsharded(card):
    """``default_mesh()`` over every card of a host with two or more: the
    shards' blocks and candidates cross to the card of mesh entry
    (0, 0), where the results equal the unsharded port's bit for bit."""
    from searcharray_tpu_torch.index.builder import build_index
    from searcharray_tpu_torch.parallel import sharded as tsh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    docs = sharded_docs(11, 6000)
    card_index = torch.cuda.current_device()
    single = SearchArray.index(docs, device=card, autowarm=False)
    mesh = tsh.default_mesh()
    sh = tsh.ShardedIndex.build(build_index(docs), mesh=mesh)
    assert len({str(d.device) for d in sh.device_indexes()}) == (
        torch.cuda.device_count())
    queries, slops = SHARDED_QUERIES
    qt = [single._resolve_tids(q) for q in queries]
    got = sh.score_batch_device(qt, slop=slops)
    want = batch.score_batch_fused(single.dev, qt, slop=slops,
                                   as_device=True)
    assert torch.equal(got.cpu().view(torch.int32),
                       want.cpu().view(torch.int32))
    vals, idx = sh.topk(qt, 10, slop=slops)
    wv, wi = batch.score_batch_fused(single.dev, qt, slop=slops, top_k=10)
    assert np.array_equal(idx.cpu().numpy(), wi)
    assert np.array_equal(vals.cpu().numpy().view(np.int32),
                          wv.view(np.int32))
    # rows= takes slop 0: its reference is the batch at slop 0
    rows = np.random.default_rng(2).permutation(6000)[:1500]
    want_r = batch.score_batch_fused(single.dev, qt, as_device=True).cpu()
    assert torch.equal(
        sh.score_batch_device(qt, rows=rows).cpu().view(torch.int32),
        want_r[:, torch.as_tensor(rows)].view(torch.int32))
    # a launch on another card leaves the current device where it was
    assert torch.cuda.current_device() == card_index


# ---------------------------------------------------------------------------
# concurrent queries: threads on one index, on the default stream or each
# on a stream of its own, against the same calls made serially
# ---------------------------------------------------------------------------
def threaded_docs(seed=13, n=30_000):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    return [" ".join(rng.choice(vocab, size=rng.integers(2, 60), p=probs))
            for _ in range(n)]


THREAD_QUERIES = ([[f"w{i // 10}", f"w{i % 10 + 10}"] for i in range(100)]
                  + [f"w{i}" for i in range(100)])
THREAD_SLOPS = [0, 2] * 50 + [0] * 100
JOIN_TIMEOUT_S = 300


def rotated_request(i):
    r = 20 * i
    return (THREAD_QUERIES[r:] + THREAD_QUERIES[:r],
            THREAD_SLOPS[r:] + THREAD_SLOPS[:r])


def run_threads(fn, n):
    import threading

    out, errors = [None] * n, []
    start = threading.Barrier(n)

    def worker(i):
        try:
            start.wait()
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 (reported by the caller)
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    return out, errors


@pytest.mark.parametrize("streams", ["shared", "per_thread"])
def test_threads_serve_the_mixed_request_as_serial_calls(card, monkeypatch,
                                                          streams):
    """8 threads x 3 mixed requests (exact and slop-2 phrases, terms) on a
    shrunk pool, ranked, as full score rows and with ``block=False``;
    with ``per_thread`` each thread launches on its own
    ``torch.cuda.Stream``, so only the maps' event orders a fill that
    evicts a row after the other streams' reads of it.  There, the odd
    threads' streams sleep on the card (~10 ms) after each pool fill, so
    such a holder's reads run long after it released the maps and an
    even thread's fills are enqueued on a stream with nothing before
    them: without the event, those fills overwrite rows before they are
    read."""
    from searcharray_tpu_torch.search import dense

    monkeypatch.setattr(dense, "TF_POOL_MAX_SLOTS", 24)
    monkeypatch.setattr(dense, "PLANE_POOL_MAX_SLOTS", 12)
    docs = threaded_docs()
    arr = SearchArray.index(docs, device=card, autowarm=False)
    ref = SearchArray.index(docs, device=card, autowarm=False)
    fill_rows = dense.fill_rows
    own = [torch.cuda.Stream(card) for _ in range(8)]
    slow = {own[i].cuda_stream for i in range(1, 8, 2)}

    def slow_reads(dev, fill):
        fill_rows(dev, fill)
        if torch.cuda.current_stream(dev.device).cuda_stream in slow:
            torch.cuda._sleep(20_000_000)

    def calls(a, i):
        qq, sl = rotated_request(i)
        ranked = [a.score_batch(qq, top_k=10, slop=sl) for _ in range(2)]
        collect = a.score_batch(qq, top_k=10, slop=sl, block=False)
        full = a.score_batch_device(qq, slop=sl)
        return ranked + [collect()], full.cpu().numpy()

    want = [calls(ref, i) for i in range(8)]
    monkeypatch.setattr(dense, "fill_rows", slow_reads)

    def threaded(i):
        if streams == "shared":
            return calls(arr, i)
        s = own[i]
        with torch.cuda.stream(s):
            got = calls(arr, i)
        s.synchronize()
        return got

    got, errors = run_threads(threaded, 8)
    assert not errors, errors
    for i in range(8):
        (g_ranked, g_full), (w_ranked, w_full) = got[i], want[i]
        for (gs, gi), (ws, wi) in zip(g_ranked, w_ranked):
            assert np.array_equal(gi, wi), i
            assert np.array_equal(gs.view(np.int32), ws.view(np.int32)), i
        assert np.array_equal(g_full.view(np.int32), w_full.view(np.int32)), i
    maps = arr.dev.maps
    assert maps.holds > 0 and maps.tf_cap == 24 and maps.plane_cap == 12
