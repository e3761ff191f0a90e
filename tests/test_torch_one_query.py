"""One query, one engine: ``SearchArray.score`` and ``termfreqs`` with no
position window are a one-query batch, so ``score(q)`` is
``score_batch([q])[0]`` bit for bit (before, through and after the
phrase-tf cache's promotion) and ``termfreqs(q)`` is the JAX package's
exactly.  With a position window both take the query's posting slices:
they equal the JAX package's and touch no pool.

The queries cover terms, exact phrases on pooled planes, a phrase above
K5's term cap, a phrase whose terms overflow the plane pool, slop phrases
the dense window takes and ones that take K9, a term three times,
vocabulary misses and a term whose postings a mutation emptied, on a full
and on a sliced view; the corpus is held in the pools as they are, as a
corpus the dense pools cannot take (``DENSE_TERM_BYTES_LIMIT`` patched to
0) and with a plane pool of 8 rows (``PLANE_POOL_BYTES`` patched).  The
``cuda`` cases make the same checks on a card against the port on the
CPU.  The JAX package is imported only where a case reads it, so the
``cuda`` cases run where it is not installed."""
import numpy as np
import pytest
import torch

from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch.search import dense

KINDS = {"bm25": "bm25_similarity", "bm25_legacy": "bm25_legacy_similarity",
         "bm25_impact": "bm25_impact", "classic": "classic_similarity"}
LONG = (["x0", "x1", "x2", "x3"] * 9)[:dense.CHAIN_MAX_TERMS + 1]
WIDE = [f"w{i}" for i in range(8)]   # 8 distinct terms: a pool of 8 rows
# (query, slop) pairs and what each exercises
QUERIES = {
    "term": ("red", 0),
    "rare_term": ("w11", 0),
    "term_ignores_slop": ("fox", 3),
    "phrase": (["red", "fox"], 0),
    "phrase3": (["the", "red", "fox"], 0),
    "repeat_phrase": (["fox", "red", "fox"], 0),
    "above_k5_cap": (LONG, 0),
    "overflows_pool8": (WIDE, 0),
    "dense_window_slop": (["red", "fox"], 2),
    "k9_slop": (["red", "the", "fox"], 20),
    "term_thrice": (["the", "the", "the"], 0),
    "term_thrice_slop": (["the", "the", "the"], 2),
    "miss": ("nope", 0),
    "phrase_miss": (["red", "nope"], 0),
    "empty_postings": ("solo", 0),
    "phrase_empty_postings": (["red", "solo"], 2),
}
WINDOWED = [("red", 0, (0, 17)), ("w3", 0, (18, None)),
            (["red", "fox"], 0, (18, 53)), (["the", "red", "fox"], 0,
                                             (None, 35)),
            (["red", "fox"], 2, (0, 35)), (["the", "the", "the"], 2,
                                           (18, None)),
            (LONG, 0, (0, 35)), (["red", "solo"], 0, (0, 17))]
CONFIGS = ["pools", "no_dense_pools", "plane_pool_8"]


def make_docs(n=400, seed=31):
    rng = np.random.default_rng(seed)
    vocab = ["red", "fox", "the", "dog"] + [f"w{i}" for i in range(12)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 40)))
            for _ in range(n)]
    docs[2] = " ".join(LONG) + " " + docs[2]
    docs[3] = " ".join(LONG[:9]) + " " + docs[3]
    docs[4] = " ".join(WIDE) + " " + docs[4]
    docs[5] = "red solo fox"   # "solo" occurs here only; mutated away
    return docs


def index(cls, docs, **kw):
    """``docs`` indexed by ``cls``, then doc 5 replaced so that "solo"
    stays in the vocabulary with an empty posting."""
    arr = cls.index(docs, **kw)
    arr[5] = cls.index(["red fox"], **kw)[0]
    return arr


def configure(mp, config):
    if config == "no_dense_pools":
        mp.setattr(dense, "DENSE_TERM_BYTES_LIMIT", 0)
    elif config == "plane_pool_8":
        mp.setattr(dense, "PLANE_POOL_BYTES", 1)


def check_config(arr, config):
    dev = arr.dev
    assert dense.dense_eligible(dev) == (config != "no_dense_pools")
    if config == "plane_pool_8":
        assert dense.plane_capacity(dev) == 8
        assert not dense.phrase_fits_pool(dev, arr._resolve_tids(WIDE))
    tid = arr.term_dict.get_term_id("solo")
    assert arr._built.postings.lengths[tid] == 0


def view_of(arr, view):
    return arr if view == "full" else arr[100:500:3]


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def maps_state(arr):
    m = arr.dev.maps
    return (dict(m.tf_slot), dict(m.plane_slot), dict(m.phrase_hits),
            dict(m.phrase_recipes))


_JAX: dict = {}


def jax_pair():
    """The JAX package's array over the same documents, and its sliced
    view (built once: its answers do not depend on the port's pools)."""
    if not _JAX:
        from searcharray_tpu import SearchArray as JSearchArray

        jarr = index(JSearchArray, make_docs())
        _JAX.update(full=jarr, sliced=view_of(jarr, "sliced"))
    return _JAX


_JAX_FREQS: dict = {}


def jax_termfreqs(view, name):
    key = (view, name)
    if key not in _JAX_FREQS:
        q, slop = QUERIES[name]
        _JAX_FREQS[key] = jax_pair()[view].termfreqs(q, slop=slop)
    return _JAX_FREQS[key]


def jax_similarity(kind):
    from searcharray_tpu import similarity as jsim

    return getattr(jsim, KINDS[kind])()


def window_kw(window):
    return dict(min_posn=window[0], max_posn=window[1])


def assert_one_engine(arr, sim, q, slop, what):
    """score(q) before the batch, score_batch([q])[0] and score(q) after
    it (a phrase's second and third hits: its promotion and cached row)
    are one result bit for bit."""
    first = arr.score(q, similarity=sim, slop=slop)
    batched = arr.score_batch([q], similarity=sim, slop=slop)[0]
    again = arr.score(q, similarity=sim, slop=slop)
    assert first.shape == (len(arr),)
    np.testing.assert_array_equal(bits(first), bits(batched), err_msg=what)
    np.testing.assert_array_equal(bits(again), bits(batched), err_msg=what)
    return first


# ---------------------------------------------------------------------------
# on the CPU, against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("view", ["full", "sliced"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("config", CONFIGS)
def test_score_is_a_one_query_batch(config, kind, view, monkeypatch):
    configure(monkeypatch, config)
    arr = index(SearchArray, make_docs(), device="cpu")
    check_config(arr, config)
    arr = view_of(arr, view)
    sim = getattr(tsim, KINDS[kind])()
    for name, (q, slop) in QUERIES.items():
        got = assert_one_engine(arr, sim, q, slop, f"{name} {config}")
        if "miss" in name or "empty" in name:
            assert not got.any(), name
        freqs = arr.termfreqs(q, slop=slop)
        np.testing.assert_array_equal(freqs, jax_termfreqs(view, name),
                                      err_msg=name)
        np.testing.assert_array_equal(arr.termfreqs(q, slop=slop), freqs,
                                      err_msg=name)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_queries_take_the_routes_they_name(config, monkeypatch):
    """The phrase above K5's cap, the pool overflow (at 8 plane rows) and
    the K9 slop phrases never take a pool row; the dense phrases and the
    dense-window slop phrase are promoted into the phrase-tf cache where
    the corpus takes the dense pools."""
    configure(monkeypatch, config)
    arr = index(SearchArray, make_docs(), device="cpu")
    sig = {name: (tuple(arr._resolve_tids(q)), slop)
           for name, (q, slop) in QUERIES.items() if isinstance(q, list)}
    for q, slop in QUERIES.values():
        for _ in range(3):
            arr.termfreqs(q, slop=slop)
    cached = set(arr.dev.maps.phrase_recipes)
    never = {"above_k5_cap", "k9_slop", "term_thrice_slop", "phrase_miss",
             "phrase_empty_postings"}
    if config == "plane_pool_8":
        never.add("overflows_pool8")
    for name, s in sig.items():
        if name in never or config == "no_dense_pools":
            assert s not in cached, name
        else:
            assert s in cached, name


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("config", CONFIGS)
def test_windowed_queries_take_the_posting_slices(config, kind, monkeypatch):
    configure(monkeypatch, config)
    arr = index(SearchArray, make_docs(), device="cpu")
    check_config(arr, config)
    jarr = jax_pair()["full"]
    sim = getattr(tsim, KINDS[kind])()
    jsim = jax_similarity(kind)
    arr.score_batch([q for q, _ in QUERIES.values()], similarity=sim,
                    slop=[s for _, s in QUERIES.values()])
    before = maps_state(arr)
    for q, slop, window in WINDOWED:
        kw = window_kw(window)
        for _ in range(2):
            got = arr.termfreqs(q, slop=slop, **kw)
            np.testing.assert_array_equal(
                got, jarr.termfreqs(q, slop=slop, **kw), err_msg=str(q))
            np.testing.assert_allclose(
                arr.score(q, similarity=sim, slop=slop, **kw),
                jarr.score(q, similarity=jsim, slop=slop, **kw), rtol=1e-6,
                atol=1e-7, err_msg=str(q))
    assert maps_state(arr) == before


# ---------------------------------------------------------------------------
# on a card, against the port on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("config", CONFIGS)
def test_card_score_is_a_one_query_batch(config, kind, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    configure(monkeypatch, config)
    card = index(SearchArray, make_docs(), device="cuda")
    check_config(card, config)
    host = index(SearchArray, make_docs(), device="cpu")
    sim = getattr(tsim, KINDS[kind])()
    for view in ("full", "sliced"):
        cv, hv = view_of(card, view), view_of(host, view)
        for name, (q, slop) in QUERIES.items():
            what = f"{name} {view}"
            got = assert_one_engine(cv, sim, q, slop, what)
            np.testing.assert_array_equal(
                bits(got), bits(hv.score(q, similarity=sim, slop=slop)),
                err_msg=what)
            np.testing.assert_array_equal(cv.termfreqs(q, slop=slop),
                                          hv.termfreqs(q, slop=slop),
                                          err_msg=what)
    before = maps_state(card)
    for q, slop, window in WINDOWED:
        kw = window_kw(window)
        np.testing.assert_array_equal(card.termfreqs(q, slop=slop, **kw),
                                      host.termfreqs(q, slop=slop, **kw),
                                      err_msg=str(q))
        np.testing.assert_array_equal(
            bits(card.score(q, similarity=sim, slop=slop, **kw)),
            bits(host.score(q, similarity=sim, slop=slop, **kw)),
            err_msg=str(q))
    assert maps_state(card) == before
