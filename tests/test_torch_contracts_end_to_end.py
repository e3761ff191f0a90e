"""tests/test_end_to_end.py against the port on the CPU: one movie-like
corpus indexed under several configurations (small batches, one worker,
memory-mapped postings, no warm-up, empty docs at the ends) agrees with
itself, with a naive token oracle and with the JAX package; edismax over
two fields, ``SetOfResults``, row scalars and vectorised concatenation."""
import numpy as np
import pandas as pd
import pytest

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import edismax as jedismax
from searcharray_tpu_torch import SearchArray, SetOfResults, edismax
from searcharray_tpu_torch.index.builder import std_tokenizer
from test_end_to_end import make_movies


def index(docs, **kw):
    return SearchArray.index(docs, device="cpu", **kw)


def naive_term_match(docs, term, tokenizer):
    return np.array([term in tokenizer(d) for d in docs])


@pytest.fixture(scope="module")
def corpus():
    return make_movies()


@pytest.fixture(scope="module")
def configs(corpus, tmp_path_factory):
    titles, _ = corpus
    tok = std_tokenizer
    return {
        "full": index(titles, tokenizer=tok),
        "small_batch": index(titles, tokenizer=tok, batch_size=97),
        "one_worker": index(titles, tokenizer=tok, workers=1),
        "memmap": index(titles, tokenizer=tok,
                        data_dir=str(tmp_path_factory.mktemp("mm"))),
        "no_warm": index(titles, tokenizer=tok, autowarm=False),
        "smallbatch_memmap": index(
            titles, tokenizer=tok, batch_size=97,
            data_dir=str(tmp_path_factory.mktemp("mm2"))),
        "ends_empty": index(["", "", ""] + titles[3:-3] + ["", "", ""],
                            tokenizer=tok),
    }


@pytest.fixture(scope="module")
def jfull(corpus):
    titles, _ = corpus
    return JSearchArray.index(titles, tokenizer=std_tokenizer)


@pytest.mark.parametrize("term", ["star", "dark", "the", "notaterm"])
def test_configs_agree_and_match_oracle(configs, corpus, jfull, term):
    titles, _ = corpus
    oracle = naive_term_match(titles, term, std_tokenizer)
    base = configs["full"].score(term)
    assert np.array_equal(base > 0, oracle)
    np.testing.assert_array_equal(
        np.asarray(base, np.float32).view(np.int32),
        np.asarray(jfull.score(term), np.float32).view(np.int32))
    for name, arr in configs.items():
        got = arr.score(term)
        if name == "ends_empty":
            assert np.all(got[:3] == 0) and np.all(got[-3:] == 0)
            assert np.array_equal(got[3:-3] > 0, oracle[3:-3])
            continue
        assert np.allclose(got, base), name


def test_phrase_configs_agree(configs, jfull):
    base = configs["full"].termfreqs(["the", "star"])
    np.testing.assert_array_equal(base, jfull.termfreqs(["the", "star"]))
    for name, arr in configs.items():
        got = arr.termfreqs(["the", "star"])
        if name == "ends_empty":
            assert np.array_equal(got[3:-3], base[3:-3])
            assert np.all(got[:3] == 0) and np.all(got[-3:] == 0)
            continue
        assert np.array_equal(got, base), name


def test_edismax_end_to_end(corpus):
    titles, overviews = corpus
    frame = pd.DataFrame({
        "title": index(titles, tokenizer=std_tokenizer),
        "overview": index(overviews, tokenizer=std_tokenizer),
    })
    kw = dict(q="dark star", qf=["title^2", "overview"], pf=["title"],
              tie=0.1)
    scores, explain = edismax(frame, **kw)
    assert scores.shape == (len(titles),)
    matched = np.flatnonzero(scores > 0)
    for i in matched[:50]:
        toks = set(std_tokenizer(titles[i])) | set(std_tokenizer(overviews[i]))
        assert "dark" in toks or "star" in toks
    assert "title:dark^2.0" in explain
    jframe = pd.DataFrame({
        "title": JSearchArray.index(titles, tokenizer=std_tokenizer),
        "overview": JSearchArray.index(overviews, tokenizer=std_tokenizer),
    })
    jscores, jexplain = jedismax(jframe, **kw)
    np.testing.assert_allclose(scores, jscores, rtol=1e-6, atol=1e-7)
    assert explain == jexplain


def test_topk_results(corpus):
    titles, overviews = corpus
    frame = pd.DataFrame({
        "title": index(titles, tokenizer=std_tokenizer),
        "plot": overviews,
    })
    res = SetOfResults(frame)
    for q in ("star", "dark city"):
        scores, _ = edismax(frame, q=q, qf=["title"])
        res.ins_top_n(scores, N=10, query=q)
    out = res.get_all()
    assert set(out["query"]) == {"star", "dark city"}
    assert (out.groupby("query")["rank"].max() == 10).all()
    assert "title" not in out.columns  # searchable columns excluded
    for q in ("star", "dark city"):
        sub = out[out["query"] == q]
        assert (sub["score"].values == np.sort(sub["score"].values)[::-1]).all()


def test_getitem_row_roundtrip(configs, corpus):
    titles, _ = corpus
    row = configs["full"][5]
    toks = std_tokenizer(titles[5])
    assert set(row.postings.keys()) == set(toks)
    assert row.doc_len == len(toks)
    for tok in set(toks):
        assert all(toks[p] == tok for p in row.positions(tok))


def test_vectorized_concat_matches_rebuild():
    a = index(["foo bar baz", "qux foo", ""] * 7)
    b = index(["zig foo zag", "bar bar"] * 5)
    merged = SearchArray._concat_same_type([a, b])
    assert len(merged) == len(a) + len(b)
    rebuilt = SearchArray(np.concatenate([np.asarray(a), np.asarray(b)]),
                          device="cpu")
    for q in ("foo", "bar", "zig", ["foo", "bar"]):
        assert np.array_equal(merged.termfreqs(q), rebuilt.termfreqs(q)), q
    assert merged.docfreq("foo") == a.docfreq("foo") + b.docfreq("foo")
    df = pd.concat(
        [pd.DataFrame({"t": a}), pd.DataFrame({"t": b})], ignore_index=True
    )
    assert np.array_equal(df["t"].array.termfreqs("foo"),
                          merged.termfreqs("foo"))


def test_vectorized_concat_disjoint_vocabs():
    a = index(["alpha beta", "beta gamma"])
    b = index(["delta alpha", "epsilon"])
    merged = SearchArray._concat_same_type([a, b])
    assert np.array_equal(merged.termfreqs("alpha"), [1, 0, 1, 0])
    assert np.array_equal(merged.termfreqs("epsilon"), [0, 0, 0, 1])
    assert np.array_equal(merged.termfreqs(["delta", "alpha"]), [0, 0, 1, 0])
