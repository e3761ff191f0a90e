"""Port parity: K1 (fused term scoring) and single-term scoring against the
JAX package, on one index built by the JAX package and carried into the
port with from_numpy_state.

On the CPU the K1 wrapper runs its plain PyTorch version; the JAX side
runs score_term_pallas in interpret mode, as tests/test_pallas_score.py
does.  tests/test_torch_cuda.py compares the CUDA kernel with the plain
version on a card.
"""
import numpy as np
import pytest
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.ops.kernels import take_term_planes as j_take
from searcharray_tpu.ops.pallas.score import block_bounds, score_term_pallas
from searcharray_tpu.search import scoring as jscoring
from searcharray_tpu_torch.index.device import from_numpy_state
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.search import scoring

TERMS = ["alpha", "w0", "w44"]
RTOL, ATOL = 1e-6, 1e-7


def make_docs(n=700, seed=11):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta"] + [f"w{i}" for i in range(50)]
    return [" ".join(rng.choice(vocab, size=rng.integers(1, 30)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def pair():
    """(JAX SearchArray, port DeviceIndex on the CPU) over one index."""
    jarr = JSearchArray.index(make_docs())
    b = jarr._built
    tdev = from_numpy_state({
        "data": b.postings.data, "offsets": b.postings.offsets,
        "lengths": b.postings.lengths, "doc_lens": b.doc_lens,
        "doc_freqs": b.doc_freqs, "avg_doc_length": b.avg_doc_length,
        "terms": [b.vocab.get_term(i) for i in range(len(b.vocab))],
    }, "cpu")
    return jarr, tdev


def assert_scores(got, want, kind):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if kind == "none":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.array(a).view(np.int32))


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("kind", ["none", "bm25", "bm25_legacy",
                                  "bm25_impact"])
def test_plain_k1_matches_pallas(pair, term, kind):
    jarr, tdev = pair
    jdev = jarr.dev
    tid = jarr.term_dict.get_term_id(term)
    off, n, bucket = jdev.term_span(tid)
    h, p = j_take(jdev.hdrs, jdev.pays, off, n, bucket=bucket,
                  blk_bits=jdev.blk_bits)
    bounds = block_bounds(h, jdev.blk_bits, jdev.corpus_size, 128)
    idf = jscoring.host_idf("bm25", [jarr.docfreq(term)], jdev.corpus_size,
                            jdev.avg_doc_length)
    want = score_term_pallas(
        h, p, jdev.doc_lens, bounds, float(idf), float(jdev.avg_doc_length),
        num_docs=jdev.corpus_size, blk_bits=jdev.blk_bits, kind=kind,
        doc_block=128, max_words_per_block=int(np.max(np.diff(bounds))),
        interpret=True)
    got = kc.score_term(_t(h), _t(p), tdev.doc_lens, idf,
                        tdev.avg_doc_length, num_docs=tdev.corpus_size,
                        blk_bits=tdev.blk_bits, kind=kind)
    assert_scores(got, want, kind)


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("kind", ["none", "bm25", "bm25_legacy",
                                  "bm25_impact", "classic"])
def test_score_term_dense_matches_jax(pair, term, kind):
    jarr, tdev = pair
    tid = jarr.term_dict.get_term_id(term)
    want = jscoring.score_term_dense(jarr.dev, tid, kind=kind)
    got = scoring.score_term_dense(tdev, tid, kind=kind)
    assert_scores(got, want, kind)


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("window", [(0, 17), (18, 35), (None, 17), (36, None)])
@pytest.mark.parametrize("kind", ["none", "bm25", "classic"])
def test_windowed_scoring_matches_jax(pair, term, window, kind):
    jarr, tdev = pair
    tid = jarr.term_dict.get_term_id(term)
    lo, hi = window
    want = jscoring.score_term_dense(jarr.dev, tid, kind=kind, min_posn=lo,
                                     max_posn=hi)
    got = scoring.score_term_dense(tdev, tid, kind=kind, min_posn=lo,
                                   max_posn=hi)
    assert_scores(got, want, kind)


@pytest.mark.parametrize("window", [(5, None), (None, 20), (18, 34)])
def test_window_must_align_to_blocks(pair, window):
    jarr, tdev = pair
    tid = jarr.term_dict.get_term_id("alpha")
    with pytest.raises(ValueError):
        jscoring.score_term_dense(jarr.dev, tid, min_posn=window[0],
                                  max_posn=window[1])
    with pytest.raises(ValueError):
        scoring.score_term_dense(tdev, tid, min_posn=window[0],
                                 max_posn=window[1])


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("window", [None, (18, 35)])
def test_take_term_planes_matches_jax(pair, term, window):
    jarr, tdev = pair
    tid = jarr.term_dict.get_term_id(term)
    off, n, bucket = tdev.term_span(tid)
    lo, hi = (None, None) if window is None else (
        window[0] // 18, window[1] // 18)
    jh, jp = j_take(jarr.dev.hdrs, jarr.dev.pays, off, n, lo, hi,
                    bucket=bucket, blk_bits=tdev.blk_bits)
    th, tp = K.take_term_planes(tdev.hdrs, tdev.pays, off, n, lo, hi,
                                bucket=bucket, blk_bits=tdev.blk_bits)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).view(np.int32))


def test_popcount_i32_matches_numpy():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 31, 20000, dtype=np.int64).astype(np.int32)
    got = kc.popcount_i32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(x))


def test_k1_writes_into_out_row(pair):
    jarr, tdev = pair
    h, p = scoring.term_planes(tdev, jarr.term_dict.get_term_id("alpha"))
    pool = torch.full((3, tdev.corpus_size), -1.0)
    got = kc.score_term(h, p, tdev.doc_lens, 0.0, 1.0,
                        num_docs=tdev.corpus_size, blk_bits=tdev.blk_bits,
                        kind="none", out=pool[1])
    assert got.data_ptr() == pool[1].data_ptr()
    np.testing.assert_array_equal(
        pool[1].numpy(), np.asarray(jscoring.termfreqs_dense(
            jarr.dev, jarr.term_dict.get_term_id("alpha"))))
    assert bool((pool[0] == -1).all() and (pool[2] == -1).all())


@pytest.mark.parametrize("case", ["dtype", "length", "strided", "kind",
                                  "out"])
def test_k1_wrapper_rejects_bad_input(pair, case):
    _, tdev = pair
    h, p = scoring.term_planes(tdev, 0)
    kw = dict(num_docs=tdev.corpus_size, blk_bits=tdev.blk_bits,
              kind="bm25")
    dl = tdev.doc_lens
    if case == "dtype":
        h, exc = h.to(torch.int64), TypeError
    elif case == "length":
        p, exc = p[:-1], ValueError
    elif case == "strided":
        h, p, exc = h[::2], p[::2], ValueError
    elif case == "kind":
        kw["kind"], exc = "classic", ValueError
    else:
        kw["out"], exc = torch.empty(3), ValueError
    with pytest.raises(exc):
        kc.score_term(h, p, dl, 1.0, 1.0, **kw)
