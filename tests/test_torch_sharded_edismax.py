"""Port parity for edismax and the facade on a mesh: the counterpart of
tests/test_sharded_edismax.py.  Frames of arrays indexed with ``mesh=``
(the port on ``default_mesh(devices=["cpu"] * 8)``, the JAX package on
its conftest's 8 virtual CPU devices) against each other at rtol 1e-6,
atol 1e-7, and against the port's unsharded frame; ``score_batch(top_k=)``
on sharded fields; ``rows=`` pruning engaged on a mesh; and the facade's
mesh behaviour: ``__setitem__`` re-shards, ``copy`` keeps the mesh, a
pickle round trip drops it, ``block=False`` raises."""
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import searcharray_tpu.solr as jsolr
from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import edismax as jedismax
from searcharray_tpu import edismax_batch as jedismax_batch
from searcharray_tpu.index.builder import std_tokenizer as jstd
from searcharray_tpu.parallel.sharded import default_mesh as jmesh
from searcharray_tpu.parallel import sharded as jsh
from searcharray_tpu_torch import SearchArray, edismax, edismax_batch
from searcharray_tpu_torch import solr as tsolr
from searcharray_tpu_torch.index.builder import std_tokenizer
from searcharray_tpu_torch.parallel import sharded as tsh
from test_sharded_edismax import CASES

TOL = dict(rtol=1e-6, atol=1e-7)


def tmesh():
    return tsh.default_mesh(devices=[torch.device("cpu")] * 8)


def zipf_docs():
    rng = np.random.default_rng(5)
    vocab = ["the", "of", "what", "is", "star", "trek"] + [
        f"w{i}" for i in range(300)]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    return [" ".join(rng.choice(vocab, size=rng.integers(4, 50), p=probs))
            for _ in range(640)]


@pytest.fixture(scope="module", autouse=True)
def jax_programs_left_as_found():
    """The JAX sharded module caches its programs by shape in a module
    dict, and tests/test_sharded.py counts the programs a batch adds to
    it; the programs this module's JAX calls built go when it ends, so a
    later module in the same process finds the cache as it was."""
    before = set(jsh._pool_cache)
    yield
    for key in set(jsh._pool_cache) - before:
        del jsh._pool_cache[key]


@pytest.fixture(scope="module")
def frames():
    """(port sharded, JAX sharded, port unsharded) body/title frames."""
    corpus = zipf_docs()
    titles = [c[:40] for c in corpus]

    def frame(make):
        return pd.DataFrame({"body": make(corpus), "title": make(titles)})

    return (
        frame(lambda d: SearchArray.index(d, device="cpu", mesh=tmesh(),
                                          autowarm=False)),
        frame(lambda d: JSearchArray.index(d, mesh=jmesh(), autowarm=False)),
        frame(lambda d: SearchArray.index(d, device="cpu", autowarm=False)))


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("case", CASES,
                         ids=[c["q"].replace(" ", "-") for c in CASES])
def test_sharded_edismax_matches_jax(frames, case):
    sharded, jsharded, single = frames
    case = dict(case)
    q = case.pop("q")
    s_scores, s_explain = edismax(sharded, q=q, **case)
    j_scores, j_explain = jedismax(jsharded, q=q, **case)
    d_scores, d_explain = edismax(single, q=q, **case)
    assert s_explain == j_explain == d_explain
    np.testing.assert_allclose(s_scores, j_scores, err_msg=q, **TOL)
    np.testing.assert_array_equal(bits(s_scores), bits(d_scores))
    assert s_scores.max() > 0
    (ts, ti), _ = edismax(sharded, q=q, top_k=5, **case)
    (ws, wi), _ = edismax(single, q=q, top_k=5, **case)
    np.testing.assert_array_equal(ti, wi)
    np.testing.assert_array_equal(bits(ts), bits(ws))


def test_sharded_edismax_batch_takes_the_per_query_form(frames):
    """A sharded field takes edismax_batch's per-query fallback, as in
    the JAX package: the batch equals per-query edismax bit for bit."""
    sharded, jsharded, _ = frames
    queries = [c["q"] for c in CASES]
    kw = dict(qf=["body", "title^3"], mm="2", pf=["body"], pf2=["body"],
              ps=1, tie=0.3)
    (gs, gi), ge = edismax_batch(sharded, queries, top_k=5, **kw)
    (js, ji), je = jedismax_batch(jsharded, queries, top_k=5, **kw)
    assert ge == je
    np.testing.assert_allclose(gs, js, **TOL)
    for qi, q in enumerate(queries):
        (ws, wi), _ = edismax(sharded, q=q, top_k=5, **kw)
        np.testing.assert_array_equal(gi[qi], wi)
        np.testing.assert_array_equal(bits(gs[qi]), bits(ws))
        if js[qi, -1] > 0:
            np.testing.assert_array_equal(gi[qi], ji[qi])


def test_sharded_field_centric():
    """Different per-field tokenizers take the field-centric path."""
    corpus = ["foo-bar baz", "foo bar", "baz qux"] * 40
    fs = pd.DataFrame({
        "ws": SearchArray.index(corpus, device="cpu", mesh=tmesh(),
                                autowarm=False),
        "std": SearchArray.index(corpus, tokenizer=std_tokenizer,
                                 device="cpu", mesh=tmesh(), autowarm=False),
    })
    js = pd.DataFrame({
        "ws": JSearchArray.index(corpus, mesh=jmesh(), autowarm=False),
        "std": JSearchArray.index(corpus, tokenizer=jstd, mesh=jmesh(),
                                  autowarm=False),
    })
    s, es = edismax(fs, q="foo-bar baz", qf=["ws", "std^2"], mm="1")
    j, ej = jedismax(js, q="foo-bar baz", qf=["ws", "std^2"], mm="1")
    assert es == ej
    np.testing.assert_allclose(s, j, **TOL)
    assert s.max() > 0


def test_sharded_score_batch_topk(frames):
    sharded, jsharded, single = frames
    queries = ["the", ["what", "is"], ["star", "trek"], "nosuchterm"]
    ss, si = sharded["body"].array.score_batch(queries, top_k=5)
    js, ji = jsharded["body"].array.score_batch(queries, top_k=5)
    ds, di = single["body"].array.score_batch(queries, top_k=5)
    np.testing.assert_allclose(ss, js, **TOL)
    np.testing.assert_array_equal(si, di)
    np.testing.assert_array_equal(bits(ss), bits(ds))
    for q in range(len(queries)):
        if js[q, -1] > 0:
            np.testing.assert_array_equal(si[q], ji[q])


def test_sharded_edismax_phase_pruning_engaged(frames, monkeypatch):
    """With the subset threshold forced on both packages, the phrase
    phases score the main query's matched rows on every shard (the
    sharded rows= route) and stay within the tolerance of the JAX
    package's and bit-equal to the unpruned port."""
    sharded, jsharded, single = frames
    case = dict(q="what is the star", qf=["body", "title^3"], mm="2",
                pf=["body"], pf2=["body", "title"], pf3=["body"])
    q = case.pop("q")
    d_scores, d_explain = edismax(single, q=q, **case)
    for mod in (tsolr, jsolr):
        monkeypatch.setattr(mod, "PHASE_SUBSET_MIN_DOCS", 0)
        monkeypatch.setattr(mod, "PHASE_SUBSET_MAX_FRAC", 0)
    before = tsh.CAND_PROGRAMS[0]
    s_scores, s_explain = edismax(sharded, q=q, **case)
    assert tsh.CAND_PROGRAMS[0] - before > 0, "rows= pruning not engaged"
    j_scores, _ = jedismax(jsharded, q=q, **case)
    assert s_explain == d_explain
    np.testing.assert_allclose(s_scores, j_scores, **TOL)
    np.testing.assert_allclose(s_scores, d_scores, **TOL)


def test_facade_mesh_behaviour():
    docs = zipf_docs()[:200]
    arr = SearchArray.index(docs, device="cpu", mesh=tmesh(),
                            autowarm=False)
    jarr = JSearchArray.index(docs, mesh=jmesh(), autowarm=False)
    sharded = arr._state.sharded
    qs = ["w3", ["the", "of"], "star"]
    # copy shares the sharded runtime
    cp = arr.copy()
    assert cp._state.sharded is sharded
    # block=False needs one device, as in the JAX package
    with pytest.raises(ValueError, match="block=False"):
        arr.score_batch(qs, top_k=3, block=False)
    with pytest.raises(ValueError, match="block=False"):
        jarr.score_batch(qs, top_k=3, block=False)
    # __setitem__ re-shards on the same mesh, on both packages
    arr[7] = SearchArray.index(["w3 w3 novel"], device="cpu")[0]
    jarr[7] = JSearchArray.index(["w3 w3 novel"])[0]
    assert arr._state.sharded is not sharded
    assert arr._state.sharded.mesh is sharded.mesh
    assert cp._state.sharded is sharded            # the copy is untouched
    for q in qs + ["novel"]:
        got = arr.score_batch([q])[0]
        np.testing.assert_allclose(got, jarr.score_batch([q])[0], **TOL)
        np.testing.assert_array_equal(bits(got), bits(arr.score(q)))
    assert arr.score_batch(["novel"])[0][7] > 0
    gs, gi = arr.score_batch(qs, top_k=4)
    js, ji = jarr.score_batch(qs, top_k=4)
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_allclose(gs, js, **TOL)
    # a pickle round trip drops the mesh, as the JAX package's does
    back = pickle.loads(pickle.dumps(arr))
    jback = pickle.loads(pickle.dumps(jarr))
    assert back._state.sharded is None and jback._state.sharded is None
    np.testing.assert_array_equal(back.score_batch(qs, top_k=4)[1], gi)
    # a sliced view scores on the single device
    view = arr[10:50]
    np.testing.assert_array_equal(bits(view.score_batch(qs)),
                                  bits(arr.score_batch(qs)[:, 10:50]))
    # topk and score_batch_device on the full view
    np.testing.assert_array_equal(arr.topk("w3", k=4)[1],
                                  arr.score_batch(["w3"], top_k=4)[1][0])
    dev = arr.score_batch_device(qs, slop=[0, 2, 0])
    assert dev.shape == (3, 200)
    np.testing.assert_allclose(
        dev.numpy(), np.asarray(jarr.score_batch_device(qs, slop=[0, 2, 0])),
        **TOL)
