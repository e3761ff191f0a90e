"""tests/test_search.py's public cases against the port on the CPU.

The term-level search API (termfreqs, docfreq, doclengths, score and its
composition, position windows, top-k, pickling, stores, the row scalar,
``__setitem__``), each held to the JAX test's own expectation and, where
that expectation is a computed one (a hand-written BM25, a full sort, a
fresh rebuild), also to the JAX package's answer on the same corpus:
scores bit for bit, freqs exactly.  Where the JAX test reaches a private
name the port has a counterpart for, the counterpart is used: an index
attaches through ``_IndexState``, and the per-block word maxima the JAX
package derives at attach are the store's ``block_word_max``."""
import pickle

import numpy as np
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.index import device as jdevice
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.pandas_ext.array import _IndexState
from searcharray_tpu_torch.search.similarity import (
    classic_similarity,
    compute_idf,
)

CORPUS = ["foo bar bar baz", "data2", "data3 bar", "bunny funny wunny"]


def index(docs, **kw):
    return SearchArray.index(docs, device="cpu", **kw)


def attached(built, tokenizer):
    """An array over ``built`` (the port's ``_attach`` takes an index
    state, the JAX package's a built index)."""
    arr = SearchArray([], tokenizer=tokenizer, device="cpu")
    arr._attach(_IndexState(built, "cpu"))
    return arr


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def same_scores(got, want, what=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=str(what))


@pytest.fixture
def docs():
    return index(CORPUS * 25)


@pytest.fixture(scope="module")
def jdocs():
    return JSearchArray.index(CORPUS * 25)


def test_termfreqs(docs, jdocs):
    assert np.array_equal(docs.termfreqs("bar"), [2, 0, 1, 0] * 25)
    assert np.array_equal(docs.termfreqs("foo"), [1, 0, 0, 0] * 25)
    assert np.array_equal(docs.termfreqs("nope"), [0, 0, 0, 0] * 25)
    for q in ("bar", "foo", "nope"):
        np.testing.assert_array_equal(docs.termfreqs(q), jdocs.termfreqs(q))


def test_docfreq(docs):
    assert docs.docfreq("bar") == 50
    assert docs.docfreq("foo") == 25
    assert docs.docfreq("nope") == 0
    with pytest.raises(TypeError):
        docs.docfreq(["foo"])


def test_doclengths(docs):
    assert np.array_equal(docs.doclengths(), [4, 1, 2, 3] * 25)
    assert docs.avg_doc_length == pytest.approx(2.5)


def test_score_matches_manual_bm25(docs, jdocs):
    scores = docs.score("bar")
    tf = np.array([2, 0, 1, 0] * 25, dtype=np.float32)
    dl = np.array([4, 1, 2, 3] * 25, dtype=np.float32)
    idf = compute_idf(100, np.asarray([50.0]))
    expected = tf / (tf + 1.2 * (1 - 0.75 + 0.75 * dl / 2.5)) * idf
    assert np.allclose(scores, expected, rtol=1e-6)
    same_scores(scores, jdocs.score("bar"))


def test_score_or_composition(docs):
    s = docs.score("foo") + docs.score("bar")
    assert s[0] > docs.score("foo")[0]
    assert np.all(s[1::4] == 0)


def test_score_custom_similarity(docs, jdocs):
    from searcharray_tpu.search.similarity import (
        classic_similarity as jclassic,
    )

    scores = docs.score("bar", similarity=classic_similarity())
    tf = np.sqrt(np.array([2, 0, 1, 0] * 25, dtype=np.float32))
    idf = np.float32(np.log((100 + 1) / (50 + 1)) + 1)
    dl = np.array([4, 1, 2, 3] * 25, dtype=np.float32)
    with np.errstate(divide="ignore"):
        expected = np.where(tf > 0, idf * tf / np.sqrt(dl), 0)
    nz = tf > 0
    assert np.allclose(scores[nz], expected[nz], rtol=1e-6)
    np.testing.assert_allclose(
        scores, jdocs.score("bar", similarity=jclassic()), rtol=1e-6)


def test_score_on_slice(docs, jdocs):
    sliced = docs[::2]
    full = docs.score("bar")
    assert np.allclose(sliced.score("bar"), full[::2])
    same_scores(sliced.score("bar"), jdocs[::2].score("bar"))


def test_score_missing_term(docs):
    assert np.all(docs.score("nonexistent") == 0)


def test_score_phrase_uses_summed_idf(docs, jdocs):
    scores = docs.score(["foo", "bar"])
    tf = np.array([1, 0, 0, 0] * 25, dtype=np.float32)
    dl = np.array([4, 1, 2, 3] * 25, dtype=np.float32)
    idf = compute_idf(100, np.asarray([25.0, 50.0]))
    expected = tf / (tf + 1.2 * (1 - 0.75 + 0.75 * dl / 2.5)) * idf
    assert np.allclose(scores, expected, rtol=1e-6)
    same_scores(scores, jdocs.score(["foo", "bar"]))


# ---------------------------------------------------------------------------
# min/max position windows (reference: test_minmax_posns.py)
# ---------------------------------------------------------------------------
WINDOW_CORPUS = [
    "foo bar bar baz" + " ".join(["boz"] * 25) + " foo bar",
    "data2",
    "data3 bar",
    "bunny funny wunny",
]


@pytest.mark.parametrize(
    "min_posn,max_posn,expected",
    [
        (0, 17, [1, 0, 0, 0]),
        (0, None, [2, 0, 0, 0]),
        (18, None, [1, 0, 0, 0]),
    ],
)
def test_minmax_phrase_windows(min_posn, max_posn, expected):
    docs = index(WINDOW_CORPUS * 25)
    got = docs.termfreqs(["foo", "bar"], min_posn=min_posn, max_posn=max_posn)
    assert np.array_equal(got, expected * 25)
    want = JSearchArray.index(WINDOW_CORPUS * 25).termfreqs(
        ["foo", "bar"], min_posn=min_posn, max_posn=max_posn)
    np.testing.assert_array_equal(got, want)


def test_minmax_same_term_window():
    corpus = [
        "foo foo baz baz" + " ".join(["boz"] * 25) + " foo foo",
        "data2",
        "data3 bar",
        "bunny funny wunny",
    ]
    docs = index(corpus * 25)
    got = docs.termfreqs(["foo", "foo"], min_posn=0, max_posn=17)
    assert np.array_equal(got, [1, 0, 0, 0] * 25)


def test_minmax_single_term_window():
    docs = index(WINDOW_CORPUS * 25)
    got = docs.termfreqs("bar", min_posn=0, max_posn=17)
    assert np.array_equal(got, [2, 0, 1, 0] * 25)
    got = docs.termfreqs("bar", min_posn=18, max_posn=None)
    assert np.array_equal(got, [1, 0, 0, 0] * 25)


def test_minmax_invalid_bounds():
    docs = index(WINDOW_CORPUS)
    with pytest.raises(ValueError):
        docs.termfreqs("bar", min_posn=5, max_posn=17)
    with pytest.raises(ValueError):
        docs.termfreqs("bar", min_posn=0, max_posn=20)


def test_index_does_not_mutate_on_query(docs):
    before = docs.copy()
    docs.termfreqs(["foo", "bar"])
    docs.score("bar")
    docs.termfreqs(["foo", "bar"], slop=2)
    assert np.all(docs == before)


def test_pickle_roundtrip():
    docs = index(CORPUS * 25)
    restored = pickle.loads(pickle.dumps(docs))
    assert np.allclose(restored.score("bar"), docs.score("bar"))
    assert np.array_equal(restored.termfreqs(["foo", "bar"]),
                          docs.termfreqs(["foo", "bar"]))
    assert restored.device == "cpu"


def test_memmap_pickle_roundtrip(tmp_path):
    docs = index(CORPUS * 25, data_dir=str(tmp_path))
    expected = docs.score("bar")
    restored = pickle.loads(pickle.dumps(docs))
    assert np.allclose(restored.score("bar"), expected)


def test_save_load_index(tmp_path):
    from searcharray_tpu_torch.index.store import load_index, save_index

    docs = index(CORPUS * 25)
    save_index(docs._built, str(tmp_path / "idx"))
    restored = attached(load_index(str(tmp_path / "idx")), docs.tokenizer)
    assert np.allclose(restored.score("bar"), docs.score("bar"))
    assert np.array_equal(restored.termfreqs(["foo", "bar"]),
                          docs.termfreqs(["foo", "bar"]))


def test_save_load_derived_attach(tmp_path):
    """A v3 store carries the precomputed device-attach planes; loading
    uses them verbatim (no re-derivation) and scores identically.  The
    per-block word maxima the store keeps for the JAX package equal the
    ones the JAX package derives."""
    from searcharray_tpu_torch.index.device import (
        DeviceIndex,
        derive_attach_arrays,
    )
    from searcharray_tpu_torch.index.store import load_index, save_index

    docs = index(CORPUS * 25)
    save_index(docs._built, str(tmp_path / "idx"))
    built = load_index(str(tmp_path / "idx"))
    assert built.derived is not None
    dev = DeviceIndex(built, "cpu")
    assert dev._usable_derived(built) is not None
    want = derive_attach_arrays(docs._built)
    assert np.array_equal(dev.hdrs.numpy(), want["hdr32"])
    assert np.array_equal(dev.pays.numpy(), want["pay32"].view(np.int32))
    jwant = jdevice.derive_attach_arrays(docs._built)
    assert np.array_equal(built.derived["block_word_max"],
                          jwant["block_word_max"])
    restored = attached(built, docs.tokenizer)
    assert np.allclose(restored.score(["foo", "bar"]),
                       docs.score(["foo", "bar"]))


def test_stale_derived_falls_back(tmp_path):
    """Derived arrays whose layout constants mismatch are ignored."""
    from searcharray_tpu_torch.index.device import DeviceIndex
    from searcharray_tpu_torch.index.store import load_index, save_index

    docs = index(CORPUS * 25)
    save_index(docs._built, str(tmp_path / "idx"))
    built = load_index(str(tmp_path / "idx"))
    built.derived["blk_bits"] = built.derived["blk_bits"] + 1  # stale
    dev = DeviceIndex(built, "cpu")  # falls back to recompute
    assert dev._usable_derived(built) is None
    restored = attached(built, docs.tokenizer)
    assert np.allclose(restored.score("bar"), docs.score("bar"))


def test_built_index_pickle_drops_derived(tmp_path):
    from searcharray_tpu_torch.index.store import load_index, save_index

    docs = index(CORPUS * 25)
    save_index(docs._built, str(tmp_path / "idx"))
    built = load_index(str(tmp_path / "idx"))
    assert built.derived is not None
    clone = pickle.loads(pickle.dumps(built))
    assert clone.derived is None  # memmap-backed arrays never pickle


def test_topk_matches_full_sort(docs, jdocs):
    scores, idx = docs.topk("bar", k=7)
    full = docs.score("bar")
    want_order = np.argsort(full)[::-1][:7]
    assert np.allclose(np.sort(scores)[::-1], np.sort(full[want_order])[::-1])
    assert np.allclose(full[idx], scores)
    js, ji = jdocs.topk("bar", k=7)
    np.testing.assert_array_equal(idx, ji)
    same_scores(scores, js)


def test_topk_phrase(docs, jdocs):
    scores, idx = docs.topk(["foo", "bar"], k=5)
    full = docs.score(["foo", "bar"])
    assert np.allclose(full[idx], scores)
    assert scores[0] == full.max()
    js, ji = jdocs.topk(["foo", "bar"], k=5)
    np.testing.assert_array_equal(idx, ji)
    same_scores(scores, js)


def test_topk_on_slice(docs):
    sliced = docs[::2]
    scores, idx = sliced.topk("bar", k=3)
    full = sliced.score("bar")
    assert np.allclose(full[idx], scores)


def test_topk_custom_similarity(docs):
    def binary(tfs, dfs, dls, avg, n):
        return (np.asarray(tfs) > 0).astype(np.float32)

    scores, idx = docs.topk("bar", k=4, similarity=binary)
    assert np.all(scores == 1.0)


def test_score_batch_topk(docs, jdocs):
    queries = ["bar", ["foo", "bar"], "nonexistent"]
    scores, idx = docs.score_batch(queries, top_k=5)
    assert scores.shape == (3, 5) and idx.shape == (3, 5)
    for qi, q in enumerate(queries):
        full = docs.score(q)
        assert np.allclose(full[idx[qi]], scores[qi])
    assert np.all(scores[2] == 0)
    js, ji = jdocs.score_batch(queries, top_k=5)
    np.testing.assert_array_equal(idx, ji)
    same_scores(scores, js)


def test_score_batch_topk_on_slice(docs):
    sliced = docs[::2]
    scores, idx = sliced.score_batch(["bar"], top_k=4)
    full = sliced.score("bar")
    assert np.allclose(full[idx[0]], scores[0])


def test_reference_import_paths():
    """Users of the reference import from these module paths."""
    from searcharray_tpu_torch import (  # noqa: F401
        SearchArray,
        SetOfResults,
        Terms,
        TermsDtype,
    )
    from searcharray_tpu_torch.postings import SearchArray as SA2
    from searcharray_tpu_torch.postings import Terms as T2
    from searcharray_tpu_torch.similarity import bm25_similarity as sim2
    from searcharray_tpu_torch.solr import edismax as ed2

    assert SA2 is SearchArray and T2 is Terms
    assert callable(sim2) and callable(ed2)


# ---------------------------------------------------------------------------
# incremental __setitem__ (builder.replace_docs delta splice)
# ---------------------------------------------------------------------------
def test_setitem_delta_matches_fresh_rebuild():
    rng = np.random.default_rng(3)
    vocab = [f"t{i}" for i in range(50)]
    corpus = [" ".join(rng.choice(vocab, size=rng.integers(2, 12)))
              for _ in range(400)]
    arr = index(corpus)
    donor = index(["brand new words here", "t1 t1 overlap t2"])
    arr[7] = donor[0]
    arr[[100, 399]] = donor[[1, 0]]

    corpus2 = list(corpus)
    corpus2[7] = "brand new words here"
    corpus2[100] = "t1 t1 overlap t2"
    corpus2[399] = "brand new words here"
    ref = index(corpus2)
    jref = JSearchArray.index(corpus2)
    for q in ["t0", "brand", "overlap", ["t1", "t1"], ["new", "words"]]:
        np.testing.assert_allclose(
            np.asarray(arr.score(q)), np.asarray(ref.score(q)),
            rtol=1e-6, atol=1e-6, err_msg=str(q))
        same_scores(arr.score(q), jref.score(q), q)
    assert arr.docfreq("brand") == ref.docfreq("brand") == 2
    assert arr.avg_doc_length == pytest.approx(ref.avg_doc_length)
    np.testing.assert_array_equal(
        np.sort(arr._built.postings.data), np.sort(ref._built.postings.data))


def test_setitem_dealias_appends_backing_rows():
    arr = index(CORPUS)
    taken = arr.take([0, 0, 1])
    donor = index(["solo"])
    taken[0] = donor[0]
    assert taken[1].termfreq("bar") == 2  # alias untouched
    assert taken[0].termfreq("solo") == 1
    assert arr[0].termfreq("bar") == 2    # original untouched


def test_setitem_repeated_position_last_wins():
    arr = index(CORPUS)
    donor = index(["first version", "second version"])
    arr[[2, 2]] = donor[[0, 1]]
    assert arr[2].termfreq("second") == 1
    assert "first" not in dict(arr[2].terms())


def test_row_scalar_termfreq_counts_positions():
    arr = index(["the quick the lazy the"])
    assert arr[0].termfreq("the") == 3
    assert arr[0].termfreq("quick") == 1
