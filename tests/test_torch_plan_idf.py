"""The batch planner's per-term tables (``search/batch.py``): the idf table
(``PlanView.idf_terms``, ``scoring.idf_terms`` / ``table_idf`` /
``table_idfs``) bit for bit against ``host_idf``, and the single-term
array pass (``_term_rows``) with the count-cut chunks and waves of plain
term rows against a per-query planner written here: the same groups,
rows, idfs, specs, slots, ``out_qis`` and slot maps after every
reservation, on one index and on a two-shard view, on the dense, the
candidate and the sparse routes.  Imports no JAX."""
import numpy as np
import pytest
import torch

from searcharray_tpu_torch.index.builder import build_index
from searcharray_tpu_torch.index.device import DeviceIndex, SlotMaps
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.parallel import sharded as tsh
from searcharray_tpu_torch.search import batch
from searcharray_tpu_torch.search import candidates as cand
from searcharray_tpu_torch.search import dense
from searcharray_tpu_torch.search.dense import Fill
from searcharray_tpu_torch.search.scoring import (host_idf, idf_terms,
                                                  table_idf, table_idfs)
from searcharray_tpu_torch.utils import profiling

KINDS = ["bm25", "bm25_legacy", "classic", "none"]
N_DOCS = 20000
VOCAB = 400


def make_docs(n=N_DOCS, seed=11):
    """Zipf draws over VOCAB words: hot terms of many thousand posting
    words, rare ones of a handful."""
    rng = np.random.default_rng(seed)
    words = np.array([f"t{i}" for i in range(VOCAB)])
    p = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    p /= p.sum()
    return [" ".join(rng.choice(words, size=rng.integers(5, 16), p=p))
            for _ in range(n)]


@pytest.fixture(scope="module")
def built():
    return build_index(make_docs())


def fresh_view(built, shards):
    """A PlanView over fresh slot maps: one index, or two shards that
    hold the corpus's ``stats_docs`` and ``doc_freqs``."""
    if shards == 1:
        members = [DeviceIndex(built, "cpu")]
    else:
        cpu = torch.device("cpu")
        sh = tsh.ShardedIndex.build(built, mesh=tsh.Mesh([[cpu], [cpu]]))
        members = sh.lanes[0].members
    m0 = members[0]
    maps = SlotMaps(max(m.corpus_size for m in members), m0.blk_bits,
                    max(m.pool_share for m in members))
    for m in members:
        m.maps = maps
    return batch.PlanView(members)


@pytest.fixture(scope="module", params=[1, 2], ids=["one", "two_shards"])
def view(request, built):
    return fresh_view(built, request.param)


# ---------------------------------------------------------------------------
# the idf table
# ---------------------------------------------------------------------------
def f32_bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_idf_table_is_host_idf_bit_for_bit(view, kind):
    """Every term of the vocabulary as a single-term query, and 2,000
    seeded queries of 2-40 terms (repeats included), on the corpus's
    statistics: the table's idf is ``host_idf``'s, bit for bit."""
    V = len(view.doc_freqs)
    assert view.stats_docs == N_DOCS
    parts = view.idf_terms(kind)
    assert parts is view.idf_terms(kind)       # built once
    assert parts.dtype == np.float64 and parts.shape == (V,)
    tids = np.arange(V)
    want = [host_idf(kind, [int(view.doc_freqs[t])], view.stats_docs,
                     view.avg_doc_length) for t in tids]
    np.testing.assert_array_equal(
        f32_bits(table_idfs(kind, parts[tids], view.stats_docs)),
        f32_bits(want))
    rng = np.random.default_rng(19)
    for _ in range(2000):
        q = rng.integers(0, V, size=rng.integers(2, 41)).tolist()
        if rng.random() < 0.3:
            q += q[: rng.integers(1, len(q) + 1)]
        got = table_idf(kind, parts[q], view.stats_docs)
        exp = host_idf(kind, [int(view.doc_freqs[t]) for t in q],
                       view.stats_docs, view.avg_doc_length)
        assert got.dtype == np.float32
        assert f32_bits(got) == f32_bits(exp), q


def test_vector_buckets_and_term_eligibility_match_the_scalar_rules(view):
    n = np.concatenate([np.arange(0, 70000), [1 << 20, (1 << 20) + 1,
                                              (1 << 31) - 1, 1 << 40]])
    np.testing.assert_array_equal(
        K.buckets_of(np.maximum(n, 1)),
        [K.bucket_of(max(1, int(x))) for x in n])
    np.testing.assert_array_equal(
        K.expand_buckets_of(n), [K.expand_bucket_of(int(x)) for x in n])
    lens = view.local_lengths
    with patched(cand, CAND_TERM_MIN_DOCS=0, CAND_MAX_FRAC=2):
        for top_k in (None, 10, 5000):
            np.testing.assert_array_equal(
                cand.eligible_terms(view, lens, top_k),
                [cand.eligible_term(view, t, top_k)
                 for t in range(len(lens))])
        assert 0 < cand.eligible_terms(view, lens, 10).sum() < len(lens)
    assert not cand.eligible_terms(view, lens, 10).any()


# ---------------------------------------------------------------------------
# the plan against a per-query planner
# ---------------------------------------------------------------------------
class patched:
    def __init__(self, mod, **values):
        self.mod, self.values = mod, values

    def __enter__(self):
        self.old = {k: getattr(self.mod, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.mod, k, v)


def resolved_single(tids):
    return tids is not None and len(tids) == 1 and tids[0] >= 0


def ref_term_row(view, qi, tids, kind, top_k, allow_candidates):
    """One resolved single-term query, planned alone by the documented
    rules: ``host_idf``; ``cterm`` keyed by its coarse bucket where the
    candidate engine takes it, else ``dterm`` on a dense-eligible corpus,
    else ``term`` keyed by its bucket; a sliced row's tables are its
    shards' slices."""
    t = tids[0]
    idf = host_idf(kind, [int(view.doc_freqs[t])], view.stats_docs,
                   view.avg_doc_length)
    n = int(view.local_lengths[t])
    if allow_candidates and n > 0 and cand.eligible_term(view, t, top_k):
        gkey = ("cterm", K.expand_bucket_of(n), K.expand_bucket_of(n))
    elif dense.dense_eligible(view):
        gkey = ("dterm",)
    else:
        gkey = ("term", K.bucket_of(max(1, n)))
    offs = ns = None
    if gkey[0] != "dterm":
        offs, ns = view.offsets[:, [t]], view.lengths[:, [t]]
    return gkey, (qi, offs, ns, idf, tids)


def ref_classify(classify):
    """A per-query classifier: the single-term rows by ``ref_term_row``,
    the rest by the planner's own loop (given no single-term query, so
    the array pass takes none), each of their idfs held to
    ``host_idf``; rows in query order, groups in order of first row."""
    def f(dev, queries, kind, slop=0, top_k=None, allow_candidates=False):
        view = batch._as_view(dev)
        rows = {}
        loop = classify(view, [None if resolved_single(q) else q
                               for q in queries], kind, slop=slop,
                        top_k=top_k, allow_candidates=allow_candidates)
        for gkey, grows in loop.items():
            for r in grows:
                want = host_idf(kind, [int(view.doc_freqs[t])
                                       for t in queries[r[0]]],
                                view.stats_docs, view.avg_doc_length)
                assert f32_bits(r[3]) == f32_bits(want)
                rows[r[0]] = (gkey, r)
        for qi, q in enumerate(queries):
            if resolved_single(q):
                rows[qi] = ref_term_row(view, qi, q, kind, top_k,
                                        allow_candidates)
        groups = {}
        for qi in sorted(rows):
            gkey, r = rows[qi]
            groups.setdefault(gkey, []).append(r)
        return groups
    return f


def ref_dterm_chunks(maps, rows, max_rows, cap_p):
    """Every row's recipe planes unioned into its chunk's."""
    chunks, cur, cur_planes = [], [], set()
    for row in rows:
        p_t = batch._recipe_planes(maps, row[4][0])
        if cur and (len(cur) >= max_rows
                    or len(cur_planes | p_t) > cap_p - 1):
            chunks.append(cur)
            cur, cur_planes = [], set()
        cur.append(row)
        cur_planes |= p_t
    if cur:
        chunks.append(cur)
    return chunks


def ref_fitting(maps, s, cap_p):
    if s["gkey"][0] != "dterm":
        return [s]
    chunks = ref_dterm_chunks(maps, s["chunk"], len(s["chunk"]), cap_p)
    return ([s] if len(chunks) == 1
            else [batch._spec(s["gkey"], c) for c in chunks])


def ref_waves(view, specs):
    """Every tf key's recipe planes read into its spec's wave."""
    maps = view.maps
    cap_p, cap_t = dense.plane_capacity(view), dense.tf_capacity(view)
    cur, cur_p, cur_t = [], set(), set()
    pending = [s for s in specs if s["gkey"][0] not in batch._SPARSE_KINDS]
    while pending:
        s = pending.pop(0)
        if not cur:
            parts = ref_fitting(maps, s, cap_p)
            s, pending = parts[0], parts[1:] + pending
        t_t = set(s.get("tf_tids", ()))
        p_t = set(s.get("plane_tids", ()))
        for key_ in t_t:
            p_t |= batch._recipe_planes(maps, key_)
        if cur and (len(cur_p | p_t) > cap_p - 1
                    or len(cur_t | t_t) > cap_t - 1):
            yield cur
            cur, cur_p, cur_t = [], set(), set()
            pending.insert(0, s)
            continue
        cur.append(s)
        cur_p |= p_t
        cur_t |= t_t
    if cur:
        yield cur


def canon(x):
    """A plan's parts as plain values: floats as their float32 bits."""
    if isinstance(x, np.ndarray):
        return ("nd", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, Fill):
        return ("fill", canon([x.planes, x.terms,
                               sorted(x.recipes.items(), key=repr),
                               x.new_t]))
    if isinstance(x, dict):
        return ("dict", tuple((canon(k), canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(canon(v) for v in x))
    if isinstance(x, (float, np.floating)):
        return ("f32", int(f32_bits(x)))
    if isinstance(x, np.integer):
        return int(x)
    return x


def plan_state(plan, view):
    return canon({
        "Q": plan.Q, "expand": plan.expand, "out_qis": plan.out_qis,
        "qis": plan.qis, "n_specs": plan.n_specs, "n_cand": plan.n_cand,
        "waves": plan.waves, "sparse": plan.sparse,
        "phrase_runs": plan.phrase_runs,
        "plane_slot": list(view.maps.plane_slot.items()),
        "tf_slot": list(view.maps.tf_slot.items()),
        "free": [view.maps.plane_free, view.maps.tf_free],
        "hits": view.maps.phrase_hits, "recipes": view.maps.phrase_recipes,
    })


def batches(view, n_calls=8, seed=23):
    """Seeded calls: hot and rare terms, misses, empty queries, None,
    in-batch repeats, a term with an empty posting, exact phrases (some
    repeated across calls, so the phrase-tf cache promotes them) and slop
    phrases; one slop per query, top k alternating under and over the
    candidate buffer, the idf kind cycling."""
    rng = np.random.default_rng(seed)
    V = len(view.doc_freqs)
    empty = int(np.argmin(view.doc_freqs))
    hot_phrases = [[0, 1], [2, 0, 3], [1, 4]]
    out = []
    for c in range(n_calls):
        qs, slops = [], []
        for _ in range(70):
            r = rng.random()
            if r < 0.25:
                q = [int(rng.integers(0, 12))]            # hot
            elif r < 0.5:
                q = [int(rng.integers(12, V))]            # rare
            elif r < 0.54:
                q = [-1]
            elif r < 0.56:
                q = None if rng.random() < 0.5 else []
            elif r < 0.58:
                q = [empty]
            elif r < 0.68:
                q = list(hot_phrases[int(rng.integers(0, 3))])
            elif r < 0.74:
                q = [int(t) for t in rng.integers(0, V, size=2)]
                q[int(rng.integers(0, 2))] = -1 if rng.random() < .3 else q[0]
            else:
                q = [int(t) for t in rng.integers(0, 40,
                                                  size=rng.integers(2, 5))]
            qs.append(q)
            slops.append(int(rng.integers(0, 3)) if q and len(q) > 1 else 0)
        for j in rng.integers(0, len(qs), size=12):      # repeats
            qs.append(qs[j])
            slops.append(slops[j])
        out.append((qs, slops, 10 if c % 2 == 0 else 5000,
                    KINDS[c % len(KINDS)]))
    return out


ROUTES = {
    "dense": {},
    "cand": {"CAND_TERM_MIN_DOCS": 0, "CAND_MIN_DOCS": 0,
             "CAND_MAX_FRAC": 2},
    "sparse": {"DENSE_TERM_BYTES_LIMIT": 0},
}


def with_empty_term(view):
    """The view with its rarest term's posting emptied in the routing and
    corpus lengths."""
    t = int(np.argmin(view.doc_freqs))
    view.local_lengths = view.local_lengths.copy()
    view.stats_lengths = view.stats_lengths.copy()
    view.local_lengths[t] = view.stats_lengths[t] = 0
    return view


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("shards", [1, 2], ids=["one", "two_shards"])
def test_plan_equals_a_per_query_planner(built, route, shards, monkeypatch):
    """A sequence of calls planned by the planner and by the per-query
    one, each on its own fresh slot maps (pools shrunk so that waves cut
    and rows evict): after every call the same plan and the same maps.
    Under ``profiling.recording()`` the plan's span counts the distinct
    queries it classified and those the per-query loop took."""
    monkeypatch.setattr(dense, "TF_POOL_MAX_SLOTS", 24)
    monkeypatch.setattr(dense, "PLANE_POOL_MAX_SLOTS", 12)
    consts = ROUTES[route]
    for k, v in consts.items():
        monkeypatch.setattr(dense if k.startswith("DENSE") else cand, k, v)
    mine = with_empty_term(fresh_view(built, shards))
    ref = with_empty_term(fresh_view(built, shards))
    seen = set()
    for qs, slops, top_k, kind in batches(mine):
        N = mine.corpus_size
        with mine.held():
            profiling.clear()
            with profiling.recording():
                got = batch.plan_batch(mine, qs, kind, top_k=top_k,
                                       slop=slops, n_out=N)
            span = [s for s in profiling.spans() if s.name == "batch.plan"]
            profiling.clear()
        with monkeypatch.context() as m:
            m.setattr(batch, "_classify", ref_classify(batch._classify))
            m.setattr(batch, "_dterm_chunks", ref_dterm_chunks)
            m.setattr(batch, "_fitting", ref_fitting)
            m.setattr(batch, "_waves", ref_waves)
            with ref.held():
                want = batch.plan_batch(ref, qs, kind, top_k=top_k,
                                        slop=slops, n_out=N)
        assert plan_state(got, mine) == plan_state(want, ref)
        uniq, _, _ = batch.dedup_queries(qs, slops)
        assert len(span) == 1
        assert span[0].counts["plan_rows"] == len(uniq)
        assert span[0].counts["plan_loop_rows"] == sum(
            1 for q in uniq if not resolved_single(q))
        seen |= {s["gkey"][0] for _, w in got.waves for s in w}
        seen |= {s["gkey"][0] for s in got.sparse}
        seen |= {"sig" for _, w in got.waves for s in w if s.get("sigs")}
    # the routes this case is for were taken
    assert {"dense": {"dterm", "dphrase", "dspan", "sig"},
            "cand": {"cterm", "dterm"},
            "sparse": {"term", "phrase", "span"}}[route] <= seen
