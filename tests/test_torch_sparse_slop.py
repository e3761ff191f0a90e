"""Port parity for slop phrases on the posting slices (K9, reduced by K2):
K9's plain version against the JAX package's ``spans._span_impl`` on random
posting lists and through the facade (a position window, a window above 18
positions, a term three times, a corpus with one long document, a plane
pool too small), the walk the CUDA kernel makes, emulated in Python,
against the plain version, ``score_batch`` with span groups, and the
``k9_work`` arithmetic."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from searcharray_tpu import similarity as jsim
from searcharray_tpu.ops import kernels as JK
from searcharray_tpu.search import dense as jdense
from searcharray_tpu.search import spans as jspans
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import roofline as rl
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.search import batch, dense, spans
from test_slop import SLOP_CASES, simple_tokenizer
from test_torch_phrase import crafted_pair
from test_torch_slop import SIMS, carried_pair, pool_state, random_docs

LSB = 18


def random_lists(seed, T, blk_bits, num_docs, fill, dense_bits=True):
    """T doc-sorted posting lists over ``num_docs`` docs of ``1 <<
    blk_bits`` blocks, concatenated into (hdrs int32, pays int32, offs,
    ns) with a PAD tail as DeviceIndex lays them out; list t holds a
    ``fill[t]`` share of the slots."""
    rng = np.random.default_rng(seed)
    total = num_docs << blk_bits
    hs, ps, offs, ns, off = [], [], [], [], 0
    for t in range(T):
        n = min(total, max(1, int(total * fill[t])))
        h = np.sort(rng.choice(total, size=n, replace=False))
        p = rng.integers(0, 1 << 18, n) & rng.integers(0, 1 << 18, n)
        if not dense_bits:
            p &= rng.integers(0, 1 << 18, n)
        p[rng.random(n) < 0.2] |= (1 << 17) | 1
        hs.append(h)
        ps.append(p)
        offs.append(off)
        ns.append(n)
        off += n
    pad = K.bucket_of(max(ns)) + 8
    hdrs = np.concatenate(hs + [np.full(pad, K.PAD_HDR32)]).astype(np.int32)
    pays = np.concatenate(ps + [np.zeros(pad, np.int64)]).astype(np.int32)
    return hdrs, pays, offs, ns


def jax_span_freqs(hdrs, pays, offs, ns, anchor, mults, w, blk_bits,
                   num_docs, window=None):
    """The JAX package's ``_span_impl`` (kind none) on the same lists."""
    C = -(-w // LSB)
    mb = (0, 0) if window is None else window
    out = jspans._span_impl(
        jnp.asarray(hdrs), jnp.asarray(pays.view(np.uint32)),
        tuple(offs), tuple(ns), jnp.ones(num_docs, jnp.float32),
        np.float32(1.0), np.float32(1.0), *mb,
        buckets=tuple(JK.bucket_of(n) for n in ns), anchor_i=anchor,
        mults=tuple(mults), w=w, C=C, num_docs=num_docs,
        windowed=window is not None, kind="none", k1=1.2, b=0.75,
        blk_bits=blk_bits)
    return np.asarray(out)


def port_span_freqs(hdrs, pays, offs, ns, anchor, mults, w, blk_bits,
                    num_docs, window=None):
    """K9's wrapper on CPU tensors (its plain version) and K2's."""
    mb = (None, None) if window is None else window
    return spans.sparse_span_freqs(
        torch.from_numpy(hdrs), torch.from_numpy(pays), [offs], [ns], w,
        mults, anchor=anchor, blk_bits=blk_bits, key_stride=num_docs,
        min_blk=mb[0], max_blk=mb[1])[0].numpy()


# ---------------------------------------------------------------------------
# K9's plain version against _span_impl on random lists
# ---------------------------------------------------------------------------
SHAPES = [
    # (multiplicities, anchor column)
    ((1, 1), 0), ((1, 1), 1), ((2,), 0), ((3,), 0), ((1, 1, 1), 2),
    ((2, 1), 1), ((1, 3), 0), ((2, 1, 2), 1),
]
# C = ceil(w / 18): 1, 1, 1, 2, 4
WINDOWS = [1, 4, 18, 19, 60]


@pytest.mark.parametrize("blk_bits", [0, 1, 3, 8])
@pytest.mark.parametrize("w", WINDOWS)
@pytest.mark.parametrize("mults,anchor", SHAPES[1:7])
def test_neighbourhood_plain_matches_jax(mults, anchor, w, blk_bits):
    num_docs = max(6, 600 >> blk_bits)
    T = len(mults)
    rng = np.random.default_rng(w + blk_bits)
    lists = random_lists(w * 100 + blk_bits * 10 + T, T, blk_bits, num_docs,
                         rng.uniform(0.15, 0.8, T), dense_bits=w < 19)
    args = (*lists, anchor, mults, w, blk_bits, num_docs)
    want = jax_span_freqs(*args)
    before = kc.span_sparse.launches
    got = port_span_freqs(*args)
    assert kc.span_sparse.launches == before   # the CPU launches nothing
    np.testing.assert_array_equal(got, want)
    if blk_bits in (3, 8):
        # a block window: payloads outside blocks 1-2 read as empty
        np.testing.assert_array_equal(
            port_span_freqs(*args, window=(1, 2)),
            jax_span_freqs(*args, window=(1, 2)))


def test_neighbourhood_plain_counts_something():
    lists = random_lists(3, 2, 3, 50, [0.5, 0.5])
    got = port_span_freqs(*lists, 0, (1, 1), 3, 3, 50)
    assert got.sum() > 0 and got.shape == (50,)


def test_neighbourhood_stays_inside_its_document():
    """Term a at the last position of doc 0's last block, term b at
    position 0 of doc 1: one apart on the flat slot axis, which the dense
    window counts, but a neighbourhood never leaves its document (the JAX
    package's ``blk_ok``), so the sparse kernel counts nothing there."""
    hdrs = np.asarray([1, 2] + [K.PAD_HDR32] * 16, np.int32)
    pays = np.asarray([1 << 17, 1] + [0] * 16, np.int32)
    for anchor in (0, 1):
        args = (hdrs, pays, [0, 1], [1, 1], anchor, (1, 1), 5, 1, 2)
        got = port_span_freqs(*args)
        np.testing.assert_array_equal(got, jax_span_freqs(*args))
        assert got.tolist() == [0, 0]
    # one block earlier both words lie in doc 0 and the pair is counted
    hdrs[:2] = [0, 1]
    args = (hdrs, pays, [0, 1], [1, 1], 0, (1, 1), 5, 1, 2)
    got = port_span_freqs(*args)
    np.testing.assert_array_equal(got, jax_span_freqs(*args))
    assert got.tolist() == [1, 0]


@pytest.mark.parametrize("anchor", [0, 1])
def test_last_slot_bit17_sparse_span_matches_jax(anchor, monkeypatch):
    """The hand-made index whose last slot holds bit 17 ("Copied on
    purpose" in ROADMAP.md): forced onto the sparse kernel, both packages
    count nothing across the document boundary."""
    jdev, tdev = crafted_pair()
    monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
    monkeypatch.setattr(jdense, "DENSE_TERM_BYTES_LIMIT", 0)
    tids = [0, 1][::1 - 2 * anchor]
    for slop in (1, 5, 17, 30):
        want = np.asarray(jspans.span_freqs_dense(jdev, tids, slop))
        got = spans.span_freqs_dense(tdev, tids, slop).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == 0


def test_wrapper_rejects_what_it_cannot_take():
    hdrs = torch.arange(10, dtype=torch.int32)
    pays = torch.ones(10, dtype=torch.int32)
    kw = dict(blk_bits=1, key_stride=8)
    with pytest.raises(ValueError, match="window"):
        kc.span_sparse(hdrs, pays, [[0, 5]], [[5, 5]], 0, (1, 1), **kw)
    with pytest.raises(ValueError, match="multiplicity"):
        kc.span_sparse(hdrs, pays, [[0, 5]], [[5, 5]], 3, (1,), **kw)
    with pytest.raises(ValueError, match="multiplicity"):
        kc.span_sparse(hdrs, pays, [[0, 5]], [[5, 5]], 3, (1, 0), **kw)
    with pytest.raises(ValueError, match="anchor"):
        kc.span_sparse(hdrs, pays, [[0, 5]], [[5, 5]], 3, (1, 1), anchor=2,
                       **kw)
    with pytest.raises(ValueError, match="past the planes"):
        kc.span_sparse(hdrs, pays, [[0, 5]], [[5, 6]], 3, (1, 1), **kw)
    with pytest.raises(ValueError, match="min_blk and max_blk"):
        kc.span_sparse(hdrs, pays, [[0, 5]], [[5, 5]], 3, (1, 1), min_blk=0,
                       **kw)
    with pytest.raises(ValueError, match=r"\[queries, terms\]"):
        kc.span_sparse(hdrs, pays, [0, 5], [5, 5], 3, (1, 1), **kw)
    keys, counts = kc.span_sparse(hdrs, pays, np.zeros((0, 2), np.int64),
                                  np.zeros((0, 2), np.int64), 3, (1, 1),
                                  **kw)
    assert keys.numel() == 0 and counts.numel() == 0


def test_a_chunk_of_queries_uses_flat_keys():
    """Three queries in one call: each query's words at its prefix offset,
    keys offset by ``q * key_stride``, equal to one call per query."""
    hdrs, pays, offs, ns = random_lists(8, 4, 2, 40, [0.3, 0.6, 0.2, 0.5])
    th, tp = torch.from_numpy(hdrs), torch.from_numpy(pays)
    qo = [[offs[0], offs[1]], [offs[2], offs[3]], [offs[1], offs[2]]]
    qn = [[ns[0], ns[1]], [ns[2], ns[3]], [ns[1], ns[2]]]
    keys, counts = kc.span_sparse(th, tp, qo, qn, 4, (1, 2), anchor=0,
                                  blk_bits=2, key_stride=64)
    starts = kc.prefix_offsets([n[0] for n in qn])
    for q in range(3):
        k1, c1 = kc.span_sparse(th, tp, [qo[q]], [qn[q]], 4, (1, 2),
                                anchor=0, blk_bits=2, key_stride=64)
        sl = slice(int(starts[q]), int(starts[q]) + qn[q][0])
        np.testing.assert_array_equal(keys[sl].numpy(), k1.numpy() + 64 * q)
        np.testing.assert_array_equal(counts[sl].numpy(), c1.numpy())
    assert bool((keys[1:] >= keys[:-1]).all())
    freqs = spans.sparse_span_freqs(th, tp, qo, qn, 4, (1, 2), blk_bits=2,
                                    key_stride=64)
    assert freqs.shape == (3, 64) and freqs[:, 40:].sum() == 0


# ---------------------------------------------------------------------------
# the two paths of the CUDA kernel (csrc/span_sparse.cu), in Python.  The
# walk: one search per term, forward cursors, running window counts, the
# last passing start.  The word path (w <= 18, no multiplicity above 2):
# a term's three neighbouring words as one 54-bit string, the windows as
# dilations of it
# ---------------------------------------------------------------------------
def dilate(y, length, shift):
    cur = 1
    while cur < length:
        k = min(cur, length - cur)
        y |= shift(y, k)
        cur += k
    return y


def down(y, k):
    return y >> k


def up(y, k):
    return (y << k) & ((1 << 64) - 1)


def kernel_walk(hdrs, pays, offs, ns, anchor, mults, w, blk_bits,
                window=None, words=False):
    C = -(-w // LSB)
    S0, L = LSB * C - w, w + LSB
    mask = (1 << blk_bits) - 1
    lo_b, hi_b = (0, (1 << 18) - 1) if window is None else window

    def win(h, p):
        return int(p) if lo_b <= (h & mask) <= hi_b else 0

    sides = [(hdrs[o: o + n], pays[o: o + n]) for o, n in zip(offs, ns)]

    def lane_word(side, idx, target, blk):
        th, tp = side
        if idx < len(th) and th[idx] < target:
            idx += 1
        if blk < 0 or blk > mask:
            return 0, idx
        if idx < len(th) and th[idx] == target:
            return win(target, tp[idx]), idx
        return 0, idx

    counts = []
    for h, p0 in zip(*(x.tolist() for x in sides[anchor])):
        p, blk, covered = win(h, p0), h & mask, 0
        if p and words:
            ok = (1 << 64) - 1
            for t, side in enumerate(sides):
                idx = int(np.searchsorted(side[0], h - 1))
                x = 0
                for lane in range(3):
                    word, idx = lane_word(side, idx, h - 1 + lane,
                                          blk - 1 + lane)
                    x |= word << (LSB * lane)
                if mults[t] == 1:
                    ok &= dilate(x, w + 1, down)
                else:
                    pairs = 0
                    for d in range(1, w + 1):
                        pairs |= dilate(x & (x >> d), w + 1 - d, down)
                    ok &= pairs
            covered = bin(dilate(ok, w + 1, up) & (p << LSB)).count("1")
        elif p:
            st = []
            for t, side in enumerate(sides):
                idx = int(np.searchsorted(side[0], h - C))
                word, idx = lane_word(side, idx, h - C, blk - C)
                trail = [idx, word]
                end, count, lane, frm = S0 + w + 1, 0, 0, S0
                while True:
                    to = min(LSB, end - lane * LSB)
                    count += bin(word & ((1 << to) - 1)
                                 & ~((1 << frm) - 1)).count("1")
                    if end <= (lane + 1) * LSB:
                        break
                    lane, frm = lane + 1, 0
                    word, idx = lane_word(side, idx, h - C + lane,
                                          blk - C + lane)
                st.append(trail + [idx, word, count - mults[t]])
            last_ok = -1
            lane_l, bit_l, lane_e, bit_e = 0, S0, C, 1
            for si in range(L):
                if all(s[4] >= 0 for s in st):
                    last_ok = si
                b = si - w
                if b >= 0 and (p >> b) & 1 and last_ok >= b:
                    covered += 1
                if si + 1 == L:
                    break
                fl, fe = bit_l == LSB, bit_e == LSB
                if fl:
                    lane_l, bit_l = lane_l + 1, 0
                if fe:
                    lane_e, bit_e = lane_e + 1, 0
                for s, side in zip(st, sides):
                    if fl:
                        s[1], s[0] = lane_word(side, s[0], h - C + lane_l,
                                               blk - C + lane_l)
                    if fe:
                        s[3], s[2] = lane_word(side, s[2], h - C + lane_e,
                                               blk - C + lane_e)
                    s[4] += ((s[3] >> bit_e) & 1) - ((s[1] >> bit_l) & 1)
                bit_l += 1
                bit_e += 1
        counts.append(float(covered))
    return np.asarray(counts, np.float32)


@pytest.mark.parametrize("blk_bits", [0, 2, 5])
@pytest.mark.parametrize("w", [1, 3, 17, 18, 19, 35, 36, 37, 200])
@pytest.mark.parametrize("mults,anchor", SHAPES[::2])
def test_kernel_walk_matches_plain(mults, anchor, w, blk_bits):
    T = len(mults)
    rng = np.random.default_rng(w * 7 + blk_bits)
    hdrs, pays, offs, ns = random_lists(
        w * 31 + blk_bits + T, T, blk_bits, max(4, 160 >> blk_bits),
        rng.uniform(0.2, 0.9, T), dense_bits=w < 30)
    for window in (None, (0, 1), (1, 6)):
        _, want = K.span_neighbourhood_plain(
            torch.from_numpy(hdrs), torch.from_numpy(pays), offs, ns, anchor,
            mults, w, blk_bits=blk_bits,
            min_blk=None if window is None else window[0],
            max_blk=None if window is None else window[1])
        got = kernel_walk(hdrs, pays, offs, ns, anchor, mults, w, blk_bits,
                          window)
        np.testing.assert_array_equal(got, want.numpy())
        if w <= 18 and max(mults) <= 2:
            got = kernel_walk(hdrs, pays, offs, ns, anchor, mults, w,
                              blk_bits, window, words=True)
            np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("blk_bits", [0, 1, 4])
@pytest.mark.parametrize("w", list(range(1, 19)))
@pytest.mark.parametrize("mults,anchor", [((1, 1), 0), ((2,), 0),
                                          ((2, 1), 1), ((1, 2, 2), 0)])
def test_kernel_word_path_matches_plain(mults, anchor, w, blk_bits):
    """Every window the word path takes, dense lists so that most headers
    have both neighbours."""
    T = len(mults)
    hdrs, pays, offs, ns = random_lists(
        w * 13 + blk_bits + T, T, blk_bits, max(4, 120 >> blk_bits),
        [0.7, 0.9, 0.5][:T], dense_bits=w < 6)
    for window in (None, (0, 1)):
        _, want = K.span_neighbourhood_plain(
            torch.from_numpy(hdrs), torch.from_numpy(pays), offs, ns, anchor,
            mults, w, blk_bits=blk_bits,
            min_blk=None if window is None else window[0],
            max_blk=None if window is None else window[1])
        got = kernel_walk(hdrs, pays, offs, ns, anchor, mults, w, blk_bits,
                          window, words=True)
        np.testing.assert_array_equal(got, want.numpy())
        assert w < 3 or window is not None or want.sum() > 0


# ---------------------------------------------------------------------------
# the facade forced onto the sparse kernel, against the JAX facade
# ---------------------------------------------------------------------------
FORCED = ["window", "not_dense", "pool_too_small"]


def force_sparse(monkeypatch, how):
    """Send every slop query of both packages to their sparse kernels;
    returns the keyword arguments of termfreqs/score."""
    if how == "window":
        return dict(min_posn=0, max_posn=18 * 4 - 1)
    for mod in (dense, jdense):
        if how == "not_dense":
            monkeypatch.setattr(mod, "DENSE_TERM_BYTES_LIMIT", 0)
        else:
            monkeypatch.setattr(mod, "plane_capacity", lambda dev: 1)
    return {}


@pytest.mark.parametrize("how", FORCED)
@pytest.mark.parametrize("name", list(SLOP_CASES))
def test_slop_scenarios_on_the_sparse_kernel(name, how, monkeypatch):
    phrase, doc, slop, match = SLOP_CASES[name]
    jarr, tarr = carried_pair([doc, " empty ", doc + " " + doc, " empty"] * 8,
                              tokenizer=simple_tokenizer)
    kw = force_sparse(monkeypatch, how)
    toks = simple_tokenizer(phrase)
    before = pool_state(tarr.dev)
    for s in (slop, slop + 2, 9, 25):
        if s == 0:
            continue
        np.testing.assert_array_equal(tarr.termfreqs(toks, slop=s, **kw),
                                      jarr.termfreqs(toks, slop=s, **kw))
        got = tarr.score(toks, slop=s, **kw)
        np.testing.assert_allclose(got, jarr.score(toks, slop=s, **kw),
                                   rtol=1e-6, atol=0)
        if how != "window" and s < 10:   # as tests/test_slop.py has it
            assert np.all((got[::2] > 0) == match), f"slop {s}"
        assert np.all(got[1::2] == 0)
    assert pool_state(tarr.dev) == before


DENSE_SLOP = [(["a", "b"], 1), (["a", "b"], 5), (["a", "b", "c"], 3),
              (["d", "e"], 15), (["a", "c", "e"], 10)]
WIDE_SLOP = [(["a", "b"], 18), (["a", "b", "a", "a"], 12), (["c", "c", "c"], 5),
             (["d", "e", "d"], 40), (["a", "b", "c", "d", "e"], 70)]


@pytest.fixture(scope="module")
def dense_pair():
    vocab = ["a", "b", "c", "d", "e"] + [f"x{i}" for i in range(50)]
    return carried_pair(random_docs(9, 500, vocab))


@pytest.mark.parametrize("q,slop", DENSE_SLOP)
def test_dense_slop_matches_sparse_kernel(dense_pair, q, slop, monkeypatch):
    """The dense window (K6's plain version) and the sparse kernel (K9's)
    agree on the shapes both take, as the JAX package's own test holds its
    two routes; every similarity against the JAX facade."""
    jarr, tarr = dense_pair
    dense_freqs = tarr.termfreqs(q, slop=slop)
    monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
    monkeypatch.setattr(jdense, "DENSE_TERM_BYTES_LIMIT", 0)
    sparse_freqs = tarr.termfreqs(q, slop=slop)
    np.testing.assert_array_equal(sparse_freqs, dense_freqs)
    np.testing.assert_array_equal(sparse_freqs, jarr.termfreqs(q, slop=slop))
    assert sparse_freqs.sum() > 0
    for sim in SIMS:
        np.testing.assert_allclose(
            tarr.score(q, similarity=getattr(tsim, sim)(), slop=slop),
            jarr.score(q, similarity=getattr(jsim, sim)(), slop=slop),
            rtol=1e-6, atol=0)


@pytest.mark.parametrize("sim", SIMS + ["custom"])
@pytest.mark.parametrize("q,slop", WIDE_SLOP)
def test_wide_and_repeated_slop_matches_jax(dense_pair, q, slop, sim):
    """w > 18 and a term three times: the sparse kernel's queries on a
    dense-eligible corpus, all five similarity kinds."""
    jarr, tarr = dense_pair
    assert not spans.takes_dense_span(
        tarr.dev, [tarr.term_dict.get_term_id(t) for t in q], slop)
    before = pool_state(tarr.dev)
    got = tarr.termfreqs(q, slop=slop)
    np.testing.assert_array_equal(got, jarr.termfreqs(q, slop=slop))
    assert got.sum() > 0
    if sim == "custom":
        def ts(term_freqs, doc_freqs, doc_lens, avg_doc_lens, num_docs):
            return term_freqs * doc_freqs.sum() + doc_lens / avg_doc_lens
        js = ts
    else:
        ts, js = getattr(tsim, sim)(), getattr(jsim, sim)()
    np.testing.assert_allclose(tarr.score(q, similarity=ts, slop=slop),
                               jarr.score(q, similarity=js, slop=slop),
                               rtol=1e-6, atol=0)
    assert pool_state(tarr.dev) == before


def test_a_long_document_corpus_takes_the_sparse_kernel():
    """One document of ~50k tokens: 12 block bits, no dense plane within
    the per-plane limit patched down to its size class, so every slop
    query is the sparse kernel's, in both packages."""
    rng = np.random.default_rng(4)
    vocab = ["a", "b", "c"] + [f"x{i}" for i in range(30)]
    docs = random_docs(31, 300, vocab)
    docs[5] = " ".join(rng.choice(vocab, size=50_000))
    jarr, tarr = carried_pair(docs)
    assert tarr.dev.blk_bits == jarr.dev.blk_bits == 12
    with pytest.MonkeyPatch.context() as m:
        m.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 1 << 20)
        m.setattr(jdense, "DENSE_TERM_BYTES_LIMIT", 1 << 20)
        assert not dense.dense_eligible(tarr.dev)
        for q, slop in ((["a", "b"], 2), (["a", "b", "a"], 3),
                        (["c", "x1", "x2"], 20)):
            got = tarr.termfreqs(q, slop=slop)
            np.testing.assert_array_equal(got, jarr.termfreqs(q, slop=slop))
            assert got[5] > 0
            np.testing.assert_allclose(tarr.score(q, slop=slop),
                                       jarr.score(q, slop=slop), rtol=1e-6,
                                       atol=0)
        qs = ["a", ["a", "b"], ["a", "b"], ["c", "x1", "x2"], ["b", "c"]]
        sl = [0, 2, 0, 20, 2]
        ws, wi = jarr.score_batch(qs, slop=sl, top_k=8)
        gs, gi = tarr.score_batch(qs, slop=sl, top_k=8)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    assert tarr.dev.plane_pool is None


# ---------------------------------------------------------------------------
# score_batch with span groups
# ---------------------------------------------------------------------------
MIXED = ["a", ["a", "b"], ["a", "b"], ["c", "d", "e"], ["a", "b", "a", "a"],
         "x3", ["a", "b"], ["e", "d"], ["a", "nope"], ["b", "b", "b"],
         ["d", "c"], ["c", "d"], ["a", "b"]]
MIXED_SLOP = [0, 0, 2, 2, 3, 2, 20, 15, 30, 4, 18, 18, 20]


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("sim", SIMS)
def test_score_batch_mixing_dense_and_sparse_slop_matches_jax(block, sim):
    """One request whose slop list sends some phrases to the dense window
    groups and some to the span groups (w > 18, a term three times), a
    repeated (query, slop) pair and a vocabulary miss among them: ranked
    indices equal under the smallest-index rule, three calls."""
    vocab = ["a", "b", "c", "d", "e"] + [f"x{i}" for i in range(50)]
    jarr, tarr = carried_pair(random_docs(21, 400, vocab))
    groups = batch._classify(
        tarr.dev, [tarr._resolve_tids(tarr._check_token_arg(q))
                   for q in MIXED], "bm25", slop=MIXED_SLOP)
    kinds = [k[0] for k in groups]
    assert kinds.count("span") == 4 and "dspan" in kinds
    # two queries share the group (2 terms, w = 19), and the repeated
    # (query, slop) pair is one group (2 terms, w = 21) until it is deduped
    assert sorted(len(g) for k, g in groups.items() if k[0] == "span") == [
        1, 1, 2, 2]
    tarr.dev.maps.phrase_hits.clear()
    for _ in range(3):
        ws, wi = jarr.score_batch(MIXED, similarity=getattr(jsim, sim)(),
                                  top_k=10, slop=MIXED_SLOP)
        out = tarr.score_batch(MIXED, similarity=getattr(tsim, sim)(),
                               top_k=10, slop=MIXED_SLOP, block=block)
        gs, gi = out if block else out()
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        tarr.score_batch(MIXED, slop=MIXED_SLOP),
        jarr.score_batch(MIXED, slop=MIXED_SLOP), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tarr.score_batch(MIXED, slop=25),
                               jarr.score_batch(MIXED, slop=25), rtol=1e-6,
                               atol=0)


def test_span_rows_are_ranked_by_one_topk_call(dense_pair, monkeypatch):
    _, tarr = dense_pair
    calls = []
    pack = dense.pack_topk
    monkeypatch.setattr(dense, "pack_topk",
                        lambda x, k: calls.append(tuple(x.shape)) or pack(x, k))
    qs = [["a", "b"], ["c", "d"], ["a", "b", "c"], ["e", "e", "e"]]
    tarr.score_batch(qs, slop=[20, 20, 30, 2], top_k=5)
    assert calls == [(4, len(tarr))]   # three span groups, one ranking


def test_score_batch_as_device_fans_duplicates_out(dense_pair):
    jarr, tarr = dense_pair
    qs = [["a", "b"], "c", ["a", "b"], ["d", "e"], ["nope"], ["a", "b"]]
    sl = [20, 0, 20, 3, 0, 2]
    tids = [tarr._resolve_tids(tarr._check_token_arg(q)) for q in qs]
    out = batch.score_batch_fused(tarr.dev, tids, slop=sl, as_device=True)
    assert isinstance(out, torch.Tensor) and out.shape == (6, len(tarr))
    np.testing.assert_allclose(out.numpy(), jarr.score_batch(qs, slop=sl),
                               rtol=1e-6, atol=0)
    assert torch.equal(out[0], out[2]) and not out[4].any()
    with pytest.raises(ValueError, match="exclusive"):
        batch.score_batch_fused(tarr.dev, tids, slop=sl, as_device=True,
                                top_k=3)


def test_topk_with_a_wide_slop_matches_jax(dense_pair):
    jarr, tarr = dense_pair
    for q, slop in WIDE_SLOP[:3]:
        ws, wi = jarr.topk(q, k=7, slop=slop)
        gs, gi = tarr.topk(q, k=7, slop=slop)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    jv, tv = jarr[50:400:3], tarr[50:400:3]
    for q, slop in WIDE_SLOP[:3]:
        np.testing.assert_array_equal(tv.termfreqs(q, slop=slop),
                                      jv.termfreqs(q, slop=slop))


# ---------------------------------------------------------------------------
# k9_work
# ---------------------------------------------------------------------------
def test_k9_work_counts_the_neighbourhoods_and_the_window_steps():
    # 100 anchor words against a list of 1000, w = 3 (C = 1): of the other
    # list at most 3 words per anchor word are touched
    w = rl.k9_work([[100, 1000]], 0, 3, mults=(3, 1))
    assert w["bytes"] == 16 * 100 + 8 * 300
    steps = 100 * (3 + 18)
    probes = 100 * 7 + 100 * 10   # ceil(log2(n + 1)) per term
    assert w["ops"] == (rl.K9_OPS_PER_WORD * 100
                        + rl.K7_OPS_PER_PROBE * probes
                        + steps * (2 * rl.K9_OPS_PER_STEP
                                   + rl.K9_OPS_PER_START))
    assert w["bound_by"] == "operations"
    # a short other list is read whole, once
    assert rl.k9_work([[100, 40]], 0, 3)["bytes"] == 16 * 100 + 8 * 40
    # the anchor in the second column; a wide window reaches 2C + 1 = 5
    # headers a word
    assert rl.k9_work([[5000, 10]], 1, 30)["bytes"] == 16 * 10 + 8 * 50
    # half the anchor words have no position inside the block window
    half = rl.k9_work([[100, 1000]], 0, 3, live=50, mults=(3, 1))
    assert half["bytes"] == w["bytes"]
    assert half["ops"] == (rl.K9_OPS_PER_WORD * 100
                           + rl.K7_OPS_PER_PROBE * probes // 2
                           + steps // 2 * (2 * rl.K9_OPS_PER_STEP
                                           + rl.K9_OPS_PER_START))
    # queries add up
    both = rl.k9_work([[100, 1000], [7, 9]], 0, 3)
    parts = [rl.k9_work([[100, 1000]], 0, 3), rl.k9_work([[7, 9]], 0, 3)]
    assert both["bytes"] == sum(p["bytes"] for p in parts)
    assert both["ops"] == sum(p["ops"] for p in parts)
    assert rl.total(parts)["bound_ms"] == pytest.approx(both["bound_ms"])
    with pytest.raises(ValueError):
        rl.k9_work([[100, 1000]], 0, 3, mults=(1,))


def test_k9_work_counts_dilations_where_the_window_fits_one_word():
    # w <= 18 and no term more than twice: per live anchor word the three
    # words of each term joined to one 54-bit string, and K6's dilation
    # count on two registers; the same bytes as any other shape
    walked = rl.k9_work([[100, 1000]], 0, 3, mults=(3, 1))
    probes = 100 * 7 + 100 * 10
    for mults in ((1, 1), (2, 1), (1, 2)):
        got = rl.k9_work([[100, 1000]], 0, 3, mults=mults)
        per_word = 2 * rl.k6_ops_per_slot(3, mults) + 2 * rl.K9_OPS_PER_JOIN
        assert rl.k9_ops_per_live_word(3, mults) == per_word
        assert got["bytes"] == walked["bytes"]
        assert got["ops"] == (rl.K9_OPS_PER_WORD * 100
                              + rl.K7_OPS_PER_PROBE * probes + 100 * per_word)
    # all multiplicities 1 is the default, and far below the walk's count
    one = rl.k9_work([[100, 1000]], 0, 3)
    assert one == rl.k9_work([[100, 1000]], 0, 3, mults=(1, 1))
    assert one["ops"] < walked["ops"] // 3
    # only the live words pay for their windows
    live = rl.k9_work([[100, 1000]], 0, 3, live=50)
    assert live["ops"] == (rl.K9_OPS_PER_WORD * 100
                           + rl.K7_OPS_PER_PROBE * probes // 2
                           + 50 * rl.k9_ops_per_live_word(3, (1, 1)))
    # one position past the word, or a third occurrence: the walk's steps
    assert rl.k9_ops_per_live_word(19, (1, 1)) == 37 * (
        2 * rl.K9_OPS_PER_STEP + rl.K9_OPS_PER_START)
    assert rl.k9_ops_per_live_word(18, (1, 3)) == 36 * (
        2 * rl.K9_OPS_PER_STEP + rl.K9_OPS_PER_START)


@pytest.mark.parametrize("w,steps", [(1, 19), (18, 36), (19, 37), (200, 218)])
def test_k9_work_grows_with_the_window(w, steps):
    # a term named three times has no word form at any w: w + 18 steps
    got = rl.k9_work([[10, 10, 10]], 2, w, mults=(1, 1, 3))
    fixed = rl.K9_OPS_PER_WORD * 10 + rl.K7_OPS_PER_PROBE * 3 * 10 * 4
    assert got["ops"] == fixed + 10 * steps * (3 * rl.K9_OPS_PER_STEP
                                               + rl.K9_OPS_PER_START)
    # with every term once the walk is needed only past 18 positions
    once = rl.k9_work([[10, 10, 10]], 2, w)
    if w <= 18:
        assert once["ops"] == fixed + 10 * (
            2 * rl.k6_ops_per_slot(w, (1, 1, 1)) + 3 * rl.K9_OPS_PER_JOIN)
        assert once["ops"] < got["ops"]
    else:
        assert once["ops"] == got["ops"]
