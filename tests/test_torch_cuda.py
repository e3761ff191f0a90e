"""The CUDA kernels K1 and K2 against their plain PyTorch versions, and
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
