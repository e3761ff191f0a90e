"""``SearchArray.__setitem__`` in the port against the JAX package: the
same assignments on both facades (several rows, new vocabulary,
de-aliasing through ``take``, a repeated position, views against
copies) give the same index term by term, and the same scores of terms,
phrases and slop phrases bit for bit; a mutation after the pools were
filled leaves no stale row; ``positions`` with and without ``key``."""
import numpy as np
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.index.builder import replace_docs
from searcharray_tpu_torch.pandas_ext.array import Terms

VOCAB = [f"t{i}" for i in range(50)]
NEW = ["brand new words here t3", "t1 t1 overlap t2", "t7 zzz t7 zzz t7",
       "solo"]
QUERIES = ["t0", "t1", "brand", "overlap", "zzz", ["t1", "t1"],
           ["new", "words"], ["t7", "zzz"], ["t1", "t2"]]


def corpus(n=400, seed=3):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(VOCAB, size=rng.integers(2, 14)))
            for _ in range(n)]


def both(docs):
    return JSearchArray.index(docs), SearchArray.index(docs, device="cpu")


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def same_index(jarr, tarr):
    """The two built indexes, term by term."""
    jb, tb = jarr._built, tarr._built
    assert len(jb.vocab) == len(tb.vocab)
    for i in range(len(tb.vocab)):
        assert jb.vocab.get_term(i) == tb.vocab.get_term(i)
    for name in ("data", "offsets", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(tb.postings, name)),
                                      np.asarray(getattr(jb.postings, name)))
    np.testing.assert_array_equal(tb.doc_lens, jb.doc_lens)
    np.testing.assert_array_equal(tb.doc_freqs, jb.doc_freqs)
    np.testing.assert_array_equal(tb.doc_term.cols, jb.doc_term.cols)
    np.testing.assert_array_equal(tb.doc_term.rows, jb.doc_term.rows)
    assert tb.avg_doc_length == jb.avg_doc_length
    np.testing.assert_array_equal(tarr.rows, jarr.rows)
    assert tarr.subset == jarr.subset


def same_scores(jarr, tarr, queries=QUERIES):
    for q in queries:
        for slop in (0, 2):
            if isinstance(q, str) and slop:
                continue
            np.testing.assert_array_equal(
                bits(tarr.score(q, slop=slop)), bits(jarr.score(q, slop=slop)),
                err_msg=f"{q} slop {slop}")
            np.testing.assert_array_equal(tarr.termfreqs(q, slop=slop),
                                          jarr.termfreqs(q, slop=slop))


def assign(arrs, key, donor_rows):
    """``arr[key] = donor[donor_rows]`` on (JAX, port) arrays, each from
    a donor array of its own package."""
    jarr, tarr = arrs
    jdonor, tdonor = both(NEW)
    jarr[key] = jdonor[donor_rows]
    tarr[key] = tdonor[donor_rows]


@pytest.mark.parametrize("case", ["one_row", "rows", "slice", "mask",
                                  "new_vocab_everywhere"])
def test_assignments_give_the_jax_index(case):
    arrs = both(corpus())
    if case == "one_row":
        assign(arrs, 7, 0)
    elif case == "rows":
        assign(arrs, [100, 399, 3], [1, 0, 2])
    elif case == "slice":
        assign(arrs, slice(10, 14), [3, 2, 1, 0])
    elif case == "mask":
        mask = np.zeros(400, bool)
        mask[[5, 50, 250]] = True
        assign(arrs, mask, [2, 2, 1])
    else:
        assign(arrs, slice(0, 400, 50), [0, 1, 2, 3, 0, 1, 2, 3])
    same_index(*arrs)
    same_scores(*arrs)


def test_a_mutated_index_equals_a_fresh_build():
    """tests/test_search.py::test_setitem_delta_matches_fresh_rebuild on
    the port: the same postings, doc frequencies and scores as the
    corpus indexed anew."""
    docs = corpus()
    _, arr = both(docs)
    donor = SearchArray.index(NEW[:2], device="cpu")
    arr[7] = donor[0]
    arr[[100, 399]] = donor[[1, 0]]
    docs2 = list(docs)
    docs2[7] = docs2[399] = NEW[0]
    docs2[100] = NEW[1]
    ref = SearchArray.index(docs2, device="cpu")
    for q in ["t0", "brand", "overlap", ["t1", "t1"], ["new", "words"]]:
        np.testing.assert_allclose(arr.score(q), ref.score(q), rtol=1e-6,
                                   atol=1e-6, err_msg=str(q))
    assert arr.docfreq("brand") == ref.docfreq("brand") == 2
    assert arr.avg_doc_length == pytest.approx(ref.avg_doc_length)
    np.testing.assert_array_equal(np.sort(arr._built.postings.data),
                                  np.sort(ref._built.postings.data))


def test_dealiasing_through_take():
    arrs = both(corpus(60))
    jt, tt = arrs[0].take([0, 0, 1]), arrs[1].take([0, 0, 1])
    assign((jt, tt), 0, 3)
    same_index(jt, tt)
    assert tt.subset and len(tt._built.doc_lens) == 61   # a fresh row
    assert tt[0].termfreq("solo") == 1
    assert dict(tt[1].terms()) == dict(arrs[1][0].terms())   # alias kept
    assert "solo" not in dict(arrs[1][0].terms())   # original kept
    same_scores(jt, tt, ["solo", "t1", ["t1", "t2"]])


def test_a_repeated_position_keeps_the_last_value():
    arrs = both(corpus(60))
    assign(arrs, [2, 2], [0, 3])
    same_index(*arrs)
    assert arrs[1][2].termfreq("solo") == 1
    assert "brand" not in dict(arrs[1][2].terms())


def test_views_see_a_mutation_and_copies_do_not():
    jarr, tarr = both(corpus())
    jview, tview = jarr[100:200], tarr[100:200]
    jcopy, tcopy = jarr.copy(), tarr.copy()
    before = tcopy.score("zzz")
    tarr.score("t1")   # the copy shares this device copy until a mutation
    assign((jarr, tarr), 150, 2)
    assert tview[50].termfreq("zzz") == 2 == jview[50].termfreq("zzz")
    np.testing.assert_array_equal(bits(tview.score("zzz")),
                                  bits(jview.score("zzz")))
    np.testing.assert_array_equal(tcopy.score("zzz"), before)
    assert tcopy.docfreq("zzz") == jcopy.docfreq("zzz") == 0
    assert tcopy._state.dev is not None and tarr._state.dev is not tcopy.dev


def test_a_mutation_after_the_pools_filled_reads_no_stale_row():
    """The tf pool, the plane pool and the phrase-tf cache are filled and
    a phrase promoted; after the mutation every query answers as a fresh
    index of the mutated corpus does, and as the JAX package does."""
    docs = corpus()
    jarr, tarr = both(docs)
    batch = ["t1", "t2", ["t1", "t2"], ["t1", "t1"], ["t3", "t4"]]
    slops = [0, 0, 0, 0, 2]
    for _ in range(4):
        tarr.score_batch(batch, top_k=5, slop=slops)
        jarr.score_batch(batch, top_k=5, slop=slops)
    dev = tarr.dev
    assert dev.maps.tf_slot and dev.maps.plane_slot and dev.maps.phrase_recipes
    rows = [1, 2, 3, 40, 41]
    assign((jarr, tarr), rows, [1, 1, 1, 0, 2])
    assert tarr._state.dev is None   # the pools went with the old copy
    docs2 = list(docs)
    for r, d in zip(rows, [1, 1, 1, 0, 2]):
        docs2[r] = NEW[d]
    ref = SearchArray.index(docs2, device="cpu")
    for _ in range(2):
        gs, gi = tarr.score_batch(batch, top_k=5, slop=slops)
        rs, ri = ref.score_batch(batch, top_k=5, slop=slops)
        ws, wi = jarr.score_batch(batch, top_k=5, slop=slops)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(bits(gs), bits(rs))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    assert tarr.dev is not dev


@pytest.mark.parametrize("key", [None, 3, [0, 5, 5, 2], slice(2, 9)])
def test_positions_match_jax(key):
    jarr, tarr = both(corpus(40))
    assign((jarr, tarr), 5, 2)
    for term in ("t1", "t7", "zzz"):
        got = tarr.positions(term, key=key)
        want = jarr.positions(term, key=key)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint32
            np.testing.assert_array_equal(g, w)


def test_setitem_rejects_what_the_jax_package_rejects():
    _, tarr = both(corpus(10))
    with pytest.raises(ValueError, match="non-object"):
        tarr[0] = 5
    with pytest.raises(ValueError, match="cannot set 2 positions"):
        tarr[[0, 1]] = np.asarray([Terms({"a": 1})] * 3, dtype=object)
    view = tarr[:4]
    view._readonly = True
    with pytest.raises(ValueError, match="read-only"):
        view[0] = Terms({"a": 1})
    tarr[1] = None   # a missing value is an empty doc
    assert tarr.isna()[1]


def test_replace_docs_keeps_the_last_duplicate_and_appends():
    _, tarr = both(corpus(20))
    built = tarr._built
    rows = [Terms({"a": 1}, doc_len=1), Terms({"b": 2}, doc_len=2),
            Terms({"c": 1}, doc_len=1)]
    out = replace_docs(built, np.asarray([3, 3, 25]), rows, Terms)
    assert out.corpus_size == 26 and out.doc_lens[3] == 2
    assert out.doc_lens[25] == 1 and out.doc_lens[20:25].sum() == 0
    assert replace_docs(built, np.asarray([], np.int64), [], Terms) is built
