"""The port against the JAX package through every routing of the batch
driver, on random corpora with planted near-ties (the torch twin of
tests/test_fuzz_engines.py).

Random mixed batches (terms, phrases and slop phrases, repeated terms,
vocabulary misses, per-query slop) go through ``score_batch`` of both
packages under the dense pools (the default here), the candidate engine
(``CAND_*`` thresholds 0) and the sparse sort-merge path
(``DENSE_TERM_BYTES_LIMIT = 0``), each set on BOTH packages' modules, for
bm25, bm25_legacy and bm25_impact.  The corpus holds planted pairs of
documents, each pair the only documents of a term of its own, whose
scores are one float32 step apart or equal in one rounding and not in
the other: the per-op form (every operation rounded) and the two-FMA
form (``denom = fma(k1, fma(b, dl / avgdl, 1 - b), tf)``) rank them in
opposite orders.  They are picked with ``fma_f32`` from the seed.

Every port score equals ``traced_form`` (the two-FMA form, emulated in
numpy) bit for bit, and its top-k is that form's, ties to the smallest
index.  The JAX package's scores equal the port's bit for bit wherever
its program takes the two-FMA form, and its top-k indices then equal the
port's; the near-tie rows are among those in every routing.  Where the
JAX package departs from that form it does so only as ``ROADMAP.md``
Queue 3 records (its own inconsistency): a dense phrase or slop group of
more than one query takes the length norm out of its loop (the hoisted
form, whole rows), and a sparse group whose doc lengths broadcast over
its rows rounds the columns past XLA's last full 32-column vector group
otherwise; there the port is within rtol 1e-6.  Classic similarity: the
"fox" case on tests/test_torch_sparse_chains.py's corpus equals the JAX
package's multi-query ``score_batch``."""
import numpy as np
import pytest
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu import similarity as jsim
from searcharray_tpu.search import batch as jbatch
from searcharray_tpu.search import candidates as jcand
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch import similarity as tsim
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.search import candidates as cand
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.search.scoring import host_idf
from test_torch_similarity import F32, hoisted_form, traced_form

KINDS = {"bm25": "bm25_similarity", "bm25_legacy": "bm25_legacy_similarity",
         "bm25_impact": "bm25_impact"}
PAIRS_PER_KIND = 2
PLANT_LEN = 700     # the words of a pair's two documents and their balance
TOP_K = 10


def base_docs():
    rng = np.random.default_rng(1234)
    vocab = [f"t{i}" for i in range(120)]
    p = 1.0 / np.arange(1, 121) ** 1.1
    docs = [" ".join(rng.choice(vocab, size=rng.integers(1, 40),
                                p=p / p.sum())) for _ in range(1000)]
    return docs + ["", "t0 t0 t0 t0", "t1 t2 t1 t2 t1 t2"]


def perop_form(kind, tf, dl, idf, avgdl, k1=1.2, b=0.75):
    tf, dl = np.asarray(tf, F32), np.asarray(dl, F32)
    x = dl / F32(avgdl)
    denom = tf + F32(k1) * ((F32(1) - F32(b)) + F32(b) * x)
    if kind == "bm25":
        return (tf / denom) * F32(idf)
    if kind == "bm25_legacy":
        return F32(idf) * ((tf * (F32(k1) + F32(1))) / denom)
    return tf / denom


def near_ties(kind, avgdl, idf, rng, count):
    """``count`` pairs ((tf_a, dl_a), (tf_b, dl_b)) with dl_a + dl_b <
    PLANT_LEN whose two-FMA scores (``fma_f32``) and per-op scores order
    them differently (one form ties them, or they swap)."""
    # near-ties are rare: one in ~2,500 pairs of neighbours by score
    tf, dl = np.meshgrid(np.arange(1, 101), np.arange(1, 601), indexing="ij")
    tf, dl = tf.ravel(), dl.ravel()
    keep = tf <= dl
    tf, dl = tf[keep].astype(F32), dl[keep].astype(F32)
    t_tf, t_dl = torch.from_numpy(tf), torch.from_numpy(dl)
    x = t_dl / torch.tensor(float(avgdl))
    k1 = float(F32(1.2))     # the float32 values the similarity takes
    denom = K.fma_f32(k1, K.fma_f32(0.75, x, 0.25), t_tf)
    traced = {"bm25": (t_tf / denom) * float(idf),
              "bm25_legacy": float(idf) * ((t_tf * float(F32(k1) + F32(1)))
                                           / denom),
              "bm25_impact": t_tf / denom}[kind].numpy()
    assert np.array_equal(traced, traced_form(kind, tf, dl, idf, avgdl))
    perop = perop_form(kind, tf, dl, idf, avgdl)
    order = np.argsort(traced, kind="stable")
    found = []
    for i, j in zip(order[:-1], order[1:]):
        if dl[i] + dl[j] >= PLANT_LEN or (tf[i], dl[i]) == (tf[j], dl[j]):
            continue
        if (np.sign(traced[i] - traced[j]) != np.sign(perop[i] - perop[j])
                and abs(int(traced[i].view(np.int32))
                        - int(traced[j].view(np.int32))) <= 1):
            found.append(((int(tf[i]), int(dl[i])), (int(tf[j]), int(dl[j]))))
    assert len(found) >= count, f"{kind}: {len(found)} near-ties"
    pick = rng.choice(len(found), count, replace=False)
    return [found[k] for k in pick]


@pytest.fixture(scope="module")
def planted():
    """(docs, {pair term: (kind, (doc a, doc b))}): the base corpus with
    PAIRS_PER_KIND pairs a kind inserted at seeded positions, each pair
    with a balance document of filler, so the planted words add up to
    PLANT_LEN a pair whatever the pair and avgdl is known before the
    pairs are chosen."""
    rng = np.random.default_rng(2024)
    docs = base_docs()
    n_pairs = PAIRS_PER_KIND * len(KINDS)
    n_total = len(docs) + 3 * n_pairs
    total = sum(len(d.split()) for d in docs) + n_pairs * PLANT_LEN
    avgdl = F32(total / n_total)
    idf = host_idf("bm25", [2], n_total, avgdl)
    plants = []
    for kind in KINDS:
        for (a, b) in near_ties(kind, avgdl, idf, rng, PAIRS_PER_KIND):
            term = f"nt{len(plants)}"
            da = " ".join([term] * a[0] + ["zpad"] * (a[1] - a[0]))
            db = " ".join([term] * b[0] + ["zpad"] * (b[1] - b[0]))
            pad = " ".join(["zpad"] * (PLANT_LEN - a[1] - b[1]))
            plants.append((kind, term, da, db, pad))
    out = list(docs)
    where = {}
    for kind, term, da, db, pad in plants:
        for d in (pad, db, da):
            out.insert(int(rng.integers(0, len(out) + 1)), d)
        where[term] = kind
    pos = {t: tuple(i for i, d in enumerate(out) if d.split()[:1] == [t])
           for t in where}
    return out, {t: (where[t], pos[t]) for t in where}, avgdl


def random_queries(rng, n):
    qs, slops = [], []
    for _ in range(n):
        L = int(rng.integers(1, 5))
        toks = [f"t{int(rng.integers(0, 130))}" for _ in range(L)]
        if L >= 2 and rng.random() < 0.3:
            toks[rng.integers(1, L)] = toks[0]    # a repeated term
        qs.append(toks[0] if L == 1 and rng.random() < 0.5 else toks)
        slops.append(int(rng.integers(0, 4)) if L > 1 else 0)
    return qs, slops


def rank(scores, k):
    """Top-k indices of each row, ties to the smallest index."""
    return K.topk_exact(torch.from_numpy(np.ascontiguousarray(scores)),
                        k)[1].numpy()


def route(routing, monkeypatch):
    if routing == "candidates":
        for mod in (jcand, cand):
            monkeypatch.setattr(mod, "CAND_MIN_DOCS", 0)
            monkeypatch.setattr(mod, "CAND_TERM_MIN_DOCS", 0)
            monkeypatch.setattr(mod, "CAND_MAX_FRAC", 0)
    elif routing == "sparse":
        for mod in (jdense, dense):
            monkeypatch.setattr(mod, "DENSE_TERM_BYTES_LIMIT", 0)
    jbatch._group_cache.clear()


@pytest.mark.parametrize("routing", ["dense", "candidates", "sparse"])
def test_fuzz_mixed_batches_match_jax(planted, routing, monkeypatch):
    docs, pairs, avgdl = planted
    route(routing, monkeypatch)
    jarr = JSearchArray.index(docs)
    tarr = SearchArray.index(docs, device="cpu")
    assert F32(tarr.avg_doc_length) == avgdl == F32(jarr.avg_doc_length)
    assert dense.dense_eligible(tarr.dev) == (routing != "sparse")
    rng = np.random.default_rng({"dense": 7, "candidates": 8,
                                 "sparse": 9}[routing])
    qs, slops = random_queries(rng, 14)
    # phrase groups of more than one query, slop 0 and 2
    qs += [["t0", "t1"], ["t2", "t0"], ["t1", "t3"], ["t0", "t2"]]
    slops += [0, 0, 2, 2]
    qs += list(pairs)
    slops += [0] * len(pairs)
    n = len(docs)
    dl = np.asarray(tarr.doclengths(), F32)
    tfs = [np.asarray(tarr.termfreqs(q, slop=s), F32)
           for q, s in zip(qs, slops)]
    head = n // 32 * 32
    departures = 0
    for kind, sim_name in KINDS.items():
        jsim_f, tsim_f = getattr(jsim, sim_name)(), getattr(tsim, sim_name)()
        want = np.asarray(jarr.score_batch(qs, similarity=jsim_f,
                                           slop=slops))
        got = np.asarray(tarr.score_batch(qs, similarity=tsim_f,
                                          slop=slops))
        emul = np.stack([traced_form(kind, tf, dl, host_idf(
            kind, [tarr.docfreq(t) for t in ([q] if isinstance(q, str)
                                             else q)], n, avgdl),
            avgdl) for q, tf in zip(qs, tfs)])
        np.testing.assert_array_equal(got.view(np.int32),
                                      emul.view(np.int32))
        traced_rows = []
        for i, q in enumerate(qs):
            if np.array_equal(want[i].view(np.int32), got[i].view(np.int32)):
                traced_rows.append(i)
                continue
            departures += 1
            np.testing.assert_allclose(want[i], got[i], rtol=1e-6)
            cols = np.nonzero(want[i] != got[i])[0]
            phrase = not isinstance(q, str) and len(q) > 1
            if routing == "sparse":
                assert cols.min() >= head, (q, cols)
            else:
                assert routing == "dense" and phrase, (routing, q)
                if kind != "bm25_legacy":
                    idf = host_idf(kind, [tarr.docfreq(t) for t in q], n,
                                   avgdl)
                    hoist = hoisted_form(kind, tfs[i], dl, idf, avgdl)
                    np.testing.assert_array_equal(want[i], hoist)
        for t, (pkind, (a, b)) in pairs.items():
            i = qs.index(t)
            assert i in traced_rows, (routing, kind, t)
            if pkind == kind:   # planted for this kind: the forms disagree
                pe = perop_form(kind, tfs[i][[a, b]], dl[[a, b]],
                                host_idf(kind, [2], n, avgdl), avgdl)
                assert (np.sign(got[i][a] - got[i][b])
                        != np.sign(pe[0] - pe[1]))
        if kind == "bm25" or routing == "dense":
            ws, wi = jarr.score_batch(qs, similarity=jsim_f, slop=slops,
                                      top_k=TOP_K)
            gs, gi = tarr.score_batch(qs, similarity=tsim_f, slop=slops,
                                      top_k=TOP_K)
            # the ranked docs of positive score (the candidate engine
            # fills a short tail with zero-score docs of its own choice)
            want_i = rank(emul, TOP_K)
            for i in range(len(qs)):
                m = int((emul[i] > 0).sum())
                np.testing.assert_array_equal(np.asarray(gi)[i][:m],
                                              want_i[i][:m])
            np.testing.assert_array_equal(
                np.asarray(gi)[traced_rows], np.asarray(wi)[traced_rows])
            np.testing.assert_array_equal(
                np.asarray(gs)[traced_rows], np.asarray(ws)[traced_rows])
    if routing == "candidates":
        assert departures == 0


@pytest.mark.parametrize("routing", ["dense", "sparse"])
def test_fox_classic_equals_jax_multi_query(routing, monkeypatch):
    """``score_batch(["fox"], similarity=classic_similarity(), top_k=10)``
    on tests/test_torch_sparse_chains.py's corpus equals the JAX package's
    multi-query ``score_batch``.  The JAX package's one-query form (XLA
    rewrites ``/ sqrt(dl)`` into ``* rsqrt(dl)``) ranks docs 121 and 8
    the other way; that is its own inconsistency, not asserted here."""
    from test_torch_sparse_chains import corpus

    route(routing, monkeypatch)
    docs, _ = corpus()
    jarr = JSearchArray.index(docs)
    tarr = SearchArray.index(docs, device="cpu")
    gs, gi = tarr.score_batch(["fox"], similarity=tsim.classic_similarity(),
                              top_k=TOP_K)
    ws, wi = jarr.score_batch(["fox", "dog"],
                              similarity=jsim.classic_similarity(),
                              top_k=TOP_K)
    np.testing.assert_array_equal(np.asarray(gi)[0], np.asarray(wi)[0])
    np.testing.assert_array_equal(np.asarray(gs)[0].view(np.int32),
                                  np.asarray(ws)[0].view(np.int32))
    full = tarr.score_batch(["fox"], similarity=tsim.classic_similarity())
    jfull = jarr.score_batch(["fox", "dog"],
                             similarity=jsim.classic_similarity())
    np.testing.assert_array_equal(np.asarray(full)[0].view(np.int32),
                                  np.asarray(jfull)[0].view(np.int32))
    assert {121, 8} <= set(np.asarray(gi)[0].tolist())
