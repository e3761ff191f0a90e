"""Port parity: K2 (sorted segment-sum) and the sparse term group against
the JAX package.

On the CPU the K2 wrapper runs its plain PyTorch version; the JAX side
runs segment_sum_pallas in interpret mode, as tests/test_pallas_score.py
does, and the XLA scatter path of its batched term group.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.ops.kernels import take_term_planes as j_take
from searcharray_tpu.ops.pallas.score import segment_sum_pallas
from searcharray_tpu.search import batch as jbatch
from searcharray_tpu.search import scoring as jscoring
from searcharray_tpu_torch.index.device import from_numpy_state
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.search import batch

TERMS = ["alpha", "w0", "w44", "beta"]


def make_docs(n=700, seed=11):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta"] + [f"w{i}" for i in range(50)]
    return [" ".join(rng.choice(vocab, size=rng.integers(1, 30)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def pair():
    jarr = JSearchArray.index(make_docs())
    b = jarr._built
    tdev = from_numpy_state({
        "data": b.postings.data, "offsets": b.postings.offsets,
        "lengths": b.postings.lengths, "doc_lens": b.doc_lens,
        "doc_freqs": b.doc_freqs, "avg_doc_length": b.avg_doc_length,
        "terms": [b.vocab.get_term(i) for i in range(len(b.vocab))],
    }, "cpu")
    return jarr, tdev


def sorted_ids(seed, M=5000, N=700, pad=100):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, N, M)).astype(np.int32)
    ids[-pad:] = 2**30  # padding tail: out-of-range ids must be dropped
    vals = rng.random(M).astype(np.float32)
    return ids, vals, N


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_plain_k2_matches_pallas(seed):
    ids, vals, N = sorted_ids(seed)
    want = np.asarray(segment_sum_pallas(
        jnp.asarray(ids), jnp.asarray(vals), num_docs=N,
        max_words_per_block=4096, doc_block=256, interpret=True))
    got = kc.segment_sum(torch.from_numpy(ids), torch.from_numpy(vals),
                         num_docs=N).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_k2_empty_and_all_padding():
    ids = torch.full((16,), 2**30, dtype=torch.int32)
    out = kc.segment_sum(ids, torch.ones(16), num_docs=5)
    np.testing.assert_array_equal(out.numpy(), np.zeros(5, np.float32))
    out = kc.segment_sum(ids[:0], torch.ones(0), num_docs=3)
    np.testing.assert_array_equal(out.numpy(), np.zeros(3, np.float32))


def test_plain_k2_sums_in_the_dtype_of_the_values():
    """The float64 plain sum is the reference the card tests hold K2's
    float32 sums to."""
    ids, vals, N = sorted_ids(7)
    gi, gv = torch.from_numpy(ids), torch.from_numpy(vals)
    wide = kc.segment_sum_plain(gi, gv.double(), num_docs=N)
    assert wide.dtype == torch.float64
    ok = ids < N
    np.testing.assert_allclose(
        wide.numpy(), np.bincount(ids[ok], weights=vals[ok], minlength=N),
        rtol=1e-12)
    np.testing.assert_allclose(kc.segment_sum_plain(gi, gv, num_docs=N),
                               wide.float(), rtol=1e-6)


@pytest.mark.parametrize("case", ["dtype", "length", "values", "slots"])
def test_k2_wrapper_rejects_bad_input(case):
    ids = torch.arange(10, dtype=torch.int32)
    vals = torch.ones(10)
    exc = ValueError
    if case == "dtype":
        ids, exc = ids.to(torch.int64), TypeError
    elif case == "length":
        vals = vals[:9]
    elif case == "values":
        vals, exc = vals.to(torch.float64), TypeError
    with pytest.raises(exc):
        kc.segment_sum(ids, vals, num_docs=2**31 if case == "slots" else 10)


@pytest.mark.parametrize("terms", [["alpha"], ["alpha", "w0"], TERMS])
def test_flat_segment_sum_matches_jax(pair, terms):
    jarr, tdev = pair
    N = tdev.corpus_size
    Npad = batch._npad(N)
    assert Npad == jbatch._npad(N)
    spans = [tdev.term_span(jarr.term_dict.get_term_id(t)) for t in terms]
    bucket = max(s[2] for s in spans)
    jk, jc, tk, tc = [], [], [], []
    for off, n, _ in spans:
        h, p = j_take(jarr.dev.hdrs, jarr.dev.pays, off, n, bucket=bucket,
                      blk_bits=tdev.blk_bits)
        jk.append(np.asarray(h) >> tdev.blk_bits)
        jc.append(np.bitwise_count(np.asarray(p)).astype(np.float32))
        th, tp = K.take_term_planes(tdev.hdrs, tdev.pays, off, n,
                                    bucket=bucket, blk_bits=tdev.blk_bits)
        tk.append(th >> tdev.blk_bits)
        tc.append(kc.popcount_i32(tp).to(torch.float32))
    Qg = len(terms)
    want = np.asarray(jbatch._flat_segment_sum(
        jnp.asarray(np.stack(jk)), jnp.asarray(np.stack(jc)), Qg, Npad,
        bucket, use_pallas=False))
    got = batch._flat_segment_sum(torch.stack(tk), torch.stack(tc), Qg,
                                  Npad).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("top_k", [None, 10])
@pytest.mark.parametrize("kind", ["bm25", "bm25_legacy", "classic"])
def test_term_group_matches_jax(pair, top_k, kind):
    jarr, tdev = pair
    N = tdev.corpus_size
    tids = [jarr.term_dict.get_term_id(t) for t in TERMS]
    spans = [tdev.term_span(t) for t in tids]
    bucket = max(s[2] for s in spans)
    offs = np.asarray([s[0] for s in spans], np.int32)
    ns = np.asarray([s[1] for s in spans], np.int32)
    idfs = np.asarray([jscoring.host_idf(kind, [int(tdev.doc_freqs[t])], N,
                                         tdev.avg_doc_length) for t in tids],
                      np.float32)
    avgdl = np.float32(tdev.avg_doc_length)
    jfn = jbatch._term_group_fn(jarr.dev, len(tids), bucket, bucket, kind,
                                1.2, 0.75, top_k)
    want = np.asarray(jfn(jarr.dev.hdrs, jarr.dev.pays, jarr.dev.doc_lens,
                          avgdl, offs, ns, idfs))
    tfn = batch._term_group_fn(tdev, len(tids), bucket, kind, 1.2, 0.75,
                               top_k)
    got = tfn(tdev.hdrs, tdev.pays, tdev.doc_lens, avgdl, offs, ns,
              idfs).numpy()
    if top_k is None:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got[:, top_k:], want[:, top_k:])
        np.testing.assert_allclose(got[:, :top_k].view(np.float32),
                                   want[:, :top_k].view(np.float32),
                                   rtol=1e-6, atol=1e-7)
