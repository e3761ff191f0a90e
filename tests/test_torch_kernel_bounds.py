"""The work and bound arithmetic that chip_smoke.py prints for each kernel
(``ops/cuda/roofline.py``) on hand-made shapes and on the sparse term
group's flat keys, and the multi-row K1's
plain version against the JAX package's tf-pool rows on the same
numpy-seeded corpus."""
import numpy as np
import pytest
import torch

from searcharray_tpu import SearchArray as JSearchArray
from searcharray_tpu.search import dense as jdense
from searcharray_tpu_torch import SearchArray
from searcharray_tpu_torch.ops import kernels as K
from searcharray_tpu_torch.ops.cuda import roofline as rl
from searcharray_tpu_torch.ops.cuda import score as kc
from searcharray_tpu_torch.ops.kernels import bucket_of
from searcharray_tpu_torch.search import batch, dense
from searcharray_tpu_torch.search.phrase import _plan


def test_bound_is_bytes_or_operations_over_the_card_rates():
    w = rl.bound(3_350_000_000, 1)
    assert w["bound_ms"] == pytest.approx(1.0) and w["bound_by"] == "bytes"
    w = rl.bound(1, 16_727_040_000)
    assert w["bound_ms"] == pytest.approx(1.0)
    assert w["bound_by"] == "operations"


def test_integer_rate_is_the_issue_rate_not_the_float_rate():
    # 64 lanes x 132 SMs x 1.98 GHz, a quarter of the float32 FMA rate;
    # a popcount takes four of those issue slots
    assert rl.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    assert rl.k1_work(1, 0)["ops"] == rl.POPC + 3


@pytest.mark.parametrize("kind,per_doc", [("none", 4), ("bm25", 8),
                                          ("bm25_impact", 8),
                                          ("bm25_legacy", 8)])
def test_k1_work_is_the_words_plus_the_row(kind, per_doc):
    # "what" at 1M docs: 2,931,452 words of 8 bytes and a 4 MB row
    w = rl.k1_work(2_931_452, 1_000_000, kind)
    assert w["bytes"] == 8 * 2_931_452 + per_doc * 1_000_000
    assert w["bound_by"] == "bytes"
    # a rare term: the f32 row alone is 1.19 us at 3.35 TB/s
    rare = rl.k1_work(0, 1_000_000, "none")
    assert rare["bound_ms"] == pytest.approx(4e6 / 3.35e12 * 1e3)


@pytest.mark.parametrize("ns", [[949], [0, 1, 2_931_452], [5] * 30])
def test_k1_rows_work_adds_up_the_single_rows(ns):
    rows = rl.k1_rows_work(ns, 123_457)
    singles = [rl.k1_work(n, 123_457, "none") for n in ns]
    assert rows["bytes"] == sum(w["bytes"] for w in singles)
    assert rows["ops"] == sum(w["ops"] for w in singles)
    assert rl.total(singles)["bound_ms"] == pytest.approx(rows["bound_ms"])


def test_k2_work_counts_the_keys_in_range_and_the_slots():
    w = rl.k2_work(215_720, 6 * 40_960)
    assert w["bytes"] == 8 * 215_720 + 4 * 6 * 40_960


def test_k2_work_of_the_1m_sparse_group():
    """"what" at 1M docs: 2,931,452 words in a 3,145,728-word bucket, so
    its K2 launch reads the whole bucket (the 214,276-key pad run on slot
    Npad - 1 included) and writes 1,000,448 slots: ~8.7 us."""
    assert bucket_of(2_931_452) == 3_145_728
    Npad = batch._npad(1_000_000)
    assert Npad == 1_000_448
    flat = batch._flat_keys(torch.cat([
        torch.arange(2_931_452, dtype=torch.int32) // 3,
        torch.full((3_145_728 - 2_931_452,), K.PAD_HDR32 >> 3,
                   dtype=torch.int32)])[None, :], 1, Npad)
    assert int((flat == Npad - 1).sum()) == 214_276
    w = rl.k2_flat_work(flat, Npad)
    assert w["bytes"] == 8 * 3_145_728 + 4 * 1_000_448
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(0.008706, rel=1e-3)


@pytest.mark.parametrize("Qg", [1, 3, 8])
def test_k2_work_drops_a_2_30_tail(Qg):
    """Keys at 2^30 are dropped unread: a tail of them adds no work, and
    every launch writes Qg * Npad slots."""
    rng = np.random.default_rng(Qg)
    Npad, bucket = batch._npad(5000), 4096
    keys = np.full((Qg, bucket), K.PAD_HDR32 >> 3, np.int32)
    for q in range(Qg):
        n = int(rng.integers(1, bucket))
        keys[q, :n] = np.sort(rng.integers(0, 5000, n))
    flat = batch._flat_keys(torch.from_numpy(keys), Qg, Npad)
    tail = torch.full((777,), 2**30, dtype=torch.int32)
    w = rl.k2_flat_work(flat, Qg * Npad)
    assert w == rl.k2_flat_work(torch.cat([flat, tail]), Qg * Npad)
    assert w == rl.k2_flat_work(torch.cat([flat, tail]).numpy(), Qg * Npad)
    assert w["bytes"] == 8 * Qg * bucket + 4 * Qg * Npad


def test_k4_work_writes_whole_rows():
    w = rl.k4_work([10, 0, 5], 8_000_000)
    assert w["bytes"] == 8 * 15 + 3 * 4 * 8_000_000


@pytest.mark.parametrize("slots,distinct", [
    ([[0, 1]], 2),
    ([[0, 1], [2, 3], [4, 5]], 6),
    ([[0, 1], [1, 2], [2, 0], [1, 0]], 3),   # shared planes count once
    ([[3, 3]], 1),                          # a repeated term: one plane
    ([[7, 1, 7, 2, 7]], 3),
])
def test_k5_work_counts_each_distinct_plane_once(slots, distinct):
    n, S = 1_000_000, 8
    T = len(slots[0])
    w = rl.k5_work(slots, _plan(T, 0), n, S)
    q = len(slots)
    assert w["bytes"] == 4 * n * S * distinct + 4 * n * q + 4 * q * T
    assert w["bound_by"] == "bytes"


def test_k7_work_is_both_lists_read_and_the_base_written():
    # lists of like size: a merge walk (A + B compares) beats B searches
    w = rl.k7_work([1000], [1000])
    assert w["bytes"] == 8 * 1000 + 8 * 1000 + 12 * 1000
    assert w["ops"] == rl.K7_OPS_PER_WORD * 1000 + rl.K7_OPS_PER_PROBE * 2000
    # no continuation on a chain's last step: 8 bytes written a word
    assert rl.k7_work([1000], [1000], need_cont=False)["bytes"] == 24 * 1000
    # a rare base against a stopword: 21 probes a word, and only the
    # probed words of the other list
    w = rl.k7_work([10], [2_000_000])
    assert w["bytes"] == 8 * 10 + 8 * 210 + 12 * 10
    assert w["ops"] == rl.K7_OPS_PER_WORD * 10 + rl.K7_OPS_PER_PROBE * 210
    # a stopword base against a rare other list: the list whole
    w = rl.k7_work([2_000_000], [10])
    assert w["bytes"] == 20 * 2_000_000 + 8 * 10
    # nothing to search: no other list, or the same-term step
    for w in (rl.k7_work([500], [0]),
              rl.k7_work([500], [500], same_term=True)):
        assert w["bytes"] == 20 * 500
        assert w["ops"] == rl.K7_OPS_PER_WORD * 500
    # a chunk is the sum of its queries
    both = rl.k7_work([1000, 10], [1000, 2_000_000])
    parts = rl.total([rl.k7_work([1000], [1000]),
                      rl.k7_work([10], [2_000_000])])
    assert both == parts
    # at the card's rates a large step is bound by its bytes
    assert rl.k7_work([3_000_000], [2_500_000])["bound_by"] == "bytes"


def test_k5_work_has_no_halo():
    """A 32-term chain reads each of its planes once: the bytes do not
    grow with the steps, only the operations do."""
    n, S = 1001, 8
    short = rl.k5_work([[0, 1]], _plan(2, 0), n, S)
    long = rl.k5_work([[0, 1] * 16], _plan(32, 0), n, S)
    assert long["bytes"] - short["bytes"] == 4 * 30  # the slot ints only
    assert long["ops"] == 31 * short["ops"]


def test_first_batch_bound_matches_the_plane_count():
    """Six launches of the shapes of chip_smoke's first mixed batch: the
    batch's bound reads each 32 MB plane row DISTINCT across the batch once
    (7), while the launches fetch 23 between them, and its 18 chain steps
    over 8M slots make it bound by operations."""
    n, S = 1_000_000, 8
    launches = [([[0, 1], [2, 3], [4, 5]], 2), ([[0, 1, 4, 6]], 4),
                ([[4, 4]], 2), ([[0, 1, 6, 6]], 4),
                ([[1, 4, 6, 5, 4]], 5), ([[0, 1, 4, 6, 5]], 5)]
    groups = [(s, _plan(T, 0)) for s, T in launches]
    queries = 8
    batch = rl.k5_batch_work(groups, n, S)
    want = 4 * n * S * 7 + 4 * n * queries + 4 * (6 + 4 + 2 + 4 + 5 + 5)
    assert batch["bytes"] == want
    assert rl.k5_plane_reads(groups) == 6 + 4 + 1 + 3 + 4 + 5
    works = [rl.k5_work(s, p, n, S) for s, p in groups]
    assert rl.total(works)["bytes"] - want == 4 * n * S * (23 - 7)
    assert batch["ops"] == rl.total(works)["ops"]
    query_steps = sum(len(s) * sum(len(idxs) - 1 for _, idxs in p)
                      for s, p in groups)
    assert query_steps == 18
    assert batch["ops"] == 18 * (rl.K5_OPS_PER_SLOT_STEP * n * S + n)
    assert batch["bound_by"] == "operations"
    assert batch["bound_ms"] == pytest.approx(
        batch["ops"] / rl.INT32_OPS_PER_S * 1e3)


@pytest.mark.parametrize("slots", [[[0, 1]], [[0, 1], [1, 2], [2, 0]],
                                   [[7, 1, 7, 2, 7]]])
def test_k5_batch_of_one_launch_is_that_launch(slots):
    p = _plan(len(slots[0]), 0)
    assert rl.k5_batch_work([(slots, p)], 1001, 8) == rl.k5_work(
        slots, p, 1001, 8)


def test_k3_work_reads_each_row_once():
    """A serving group of 120 queries at 1M docs: 480 MB read once and 80
    bytes a row written, 0.143 ms at 3.35 TB/s; the key costs a few
    operations an element, far below the bytes."""
    w = rl.k3_work(120, 1_000_000, 10)
    assert w["bytes"] == 4 * 120 * 1_000_000 + 8 * 120 * 10
    assert w["ops"] == rl.K3_OPS_PER_ELEMENT * 120 * 1_000_000
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(0.14328, rel=1e-3)
    # k = N: the results are twice the input
    assert rl.k3_work(2, 1000, 1000)["bytes"] == 3 * 4 * 2 * 1000


@pytest.mark.parametrize("k", [1, 10, 64, 65, 2048, 2049])
def test_k3_work_is_the_same_on_either_path(k):
    """K3's two-launch path (k up to 64) reads a row into shared memory
    once and passes over it there; the radix select (larger k) reads it
    two to four times.  Neither re-read is work: each element is read once
    and its key computed once, whatever the path, and only the k results
    a row grow with k."""
    w = rl.k3_work(63, 1_000_000, k)
    assert w["bytes"] == 4 * 63 * 1_000_000 + 8 * 63 * k
    assert w["ops"] == rl.K3_OPS_PER_ELEMENT * 63 * 1_000_000
    assert w["bound_by"] == "bytes"


@pytest.mark.parametrize("length,steps", [
    (1, 0), (2, 1), (3, 2), (4, 2), (5, 3), (8, 3), (16, 4), (18, 5),
    (19, 5)])
def test_k6_dilation_takes_log_steps(length, steps):
    assert rl._k6_dilate_ops(length) == steps * (rl.K6_OPS_PER_SHIFT + 1)


def test_k6_ops_follow_the_plain_version():
    dil = rl._k6_dilate_ops
    tail = 1 + rl.POPC + 1   # anchor and, popcount, the doc's sum
    # two terms once each at w = 4: two dilations down, an and, one up
    assert rl.k6_ops_per_slot(4, (1, 1)) == 3 * dil(5) + 1 + tail
    # one term twice at w = 2: d = 1 (shift, and, a 2-start dilation) and
    # d = 2 (shift, and, no dilation, an or); then the dilation up
    assert rl.k6_ops_per_slot(2, (2,)) == (
        (rl.K6_OPS_PER_SHIFT + 1 + dil(2))
        + (rl.K6_OPS_PER_SHIFT + 1 + 0 + 1) + dil(3) + tail)
    # a shift by a whole slot is a move of the neighbour: no operations
    wide = rl.k6_ops_per_slot(18, (2,))
    assert wide == sum((0 if d == 18 else rl.K6_OPS_PER_SHIFT) + 1
                       + dil(19 - d) + (1 if d > 1 else 0)
                       for d in range(1, 19)) + dil(19) + tail
    # multiplicity 2 at a wide window: some hundreds of operations a slot
    assert 300 < wide < 600
    assert rl.k6_ops_per_slot(4, (1, 1)) < 70


@pytest.mark.parametrize("slots,distinct", [
    ([[0, 1]], 2), ([[0, 1], [1, 2], [2, 0]], 3), ([[3]], 1),
    ([[0, 1, 2], [3, 4, 5]], 6)])
def test_k6_work_counts_each_distinct_plane_once(slots, distinct):
    n, S = 1_000_000, 8
    q, T = len(slots), len(slots[0])
    w = rl.k6_work(slots, 4, (1,) * T, n, S)
    assert w["bytes"] == 4 * n * S * distinct + 4 * n * q + 4 * q * T
    assert w["ops"] == q * (rl.k6_ops_per_slot(4, (1,) * T) * n * S + n)


def test_k6_work_is_bound_by_operations_where_the_window_is_wide():
    n, S = 1_000_000, 8
    narrow = rl.k6_work([[0, 1]], 3, (1, 1), n, S)
    assert narrow["bound_by"] == "bytes"
    wide = rl.k6_work([[0, 1]], 17, (1, 2), n, S)
    assert wide["bound_by"] == "operations"
    assert wide["bound_ms"] == pytest.approx(
        wide["ops"] / rl.INT32_OPS_PER_S * 1e3)
    # a batch of launches counts a plane they share once
    both = rl.k6_batch_work([([[0, 1]], 3, (1, 1)), ([[1, 2]], 5, (2, 1))],
                            n, S)
    parts = [rl.k6_work([[0, 1]], 3, (1, 1), n, S),
             rl.k6_work([[1, 2]], 5, (2, 1), n, S)]
    assert rl.total(parts)["bytes"] - both["bytes"] == 4 * n * S
    assert both["ops"] == rl.total(parts)["ops"]


# ---------------------------------------------------------------------------
# the multi-row K1's plain version against the JAX package's tf-pool rows
# ---------------------------------------------------------------------------
def make_docs(n, seed, max_len):
    rng = np.random.default_rng(seed)
    vocab = ["red", "fox", "the", "dog"] + [f"w{i}" for i in range(40)]
    return [" ".join(rng.choice(vocab, size=rng.integers(1, max_len)))
            for _ in range(n)]


@pytest.fixture(scope="module", params=[(1001, 4, 30), (2049, 5, 90)])
def pair(request):
    docs = make_docs(*request.param)
    return (JSearchArray.index(docs, autowarm=False),
            SearchArray.index(docs, device="cpu", autowarm=False))


def test_rows_plain_matches_jax_tf_pool(pair):
    jarr, tarr = pair
    terms = ["red", "the", "w7", "w39", "dog", "w0"]
    tids = [tarr.term_dict.get_term_id(t) for t in terms]
    assert tids == [jarr.term_dict.get_term_id(t) for t in terms]
    jdense.ensure_tfs(jarr.dev, tids)
    dev = tarr.dev
    spans = [dev.term_span(t)[:2] for t in tids]
    out = torch.full((len(tids) + 3, dev.corpus_size), -1.0)
    rows = [4, 0, 8, 2, 6, 5]
    before = kc.score_term_rows.launches
    kc.score_term_rows(dev.hdrs, dev.pays, [o for o, _ in spans],
                       [m for _, m in spans], out, rows,
                       num_docs=dev.corpus_size, blk_bits=dev.blk_bits)
    assert kc.score_term_rows.launches == before  # the CPU launches nothing
    for t, row in zip(tids, rows):
        want = np.asarray(jarr.dev.tf_pool[jarr.dev.tf_slot[t]])
        np.testing.assert_array_equal(out[row].numpy(), want)
    keep = [i for i in range(len(tids) + 3) if i not in rows]
    assert bool((out[keep] == -1).all())


def test_pool_fill_of_a_wave_matches_jax(pair):
    """``ensure_tfs`` fills every missing term row of a wave with one
    multi-row K1 call; the rows equal the JAX package's."""
    jarr, tarr = pair
    tids = list(range(0, 30, 3))
    jdense.ensure_tfs(jarr.dev, tids)
    dense.ensure_tfs(tarr.dev, tids)
    for t in tids:
        want = np.asarray(jarr.dev.tf_pool[jarr.dev.tf_slot[t]])
        got = tarr.dev.tf_pool[tarr.dev.maps.tf_slot[t]].numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Qg", [1, 3, 8])
def test_k2_work_of_sparse_groups_on_an_index(pair, Qg):
    """The flat keys of a sparse term group, as ``_term_group_fn`` builds
    them: each row's PAD tail is clamped onto the row's last slot with
    count 0, so every key is in range and counts as K2's work."""
    _, tarr = pair
    dev = tarr.dev
    terms = ["red", "the", "w7", "w39", "dog", "w0", "fox", "w1"][:Qg]
    spans = [dev.term_span(tarr.term_dict.get_term_id(t)) for t in terms]
    bucket = max(b for _, _, b in spans)
    keys, pops = batch._slice_keys(dev.hdrs, dev.pays,
                                   [o for o, _, _ in spans],
                                   [n for _, n, _ in spans], bucket,
                                   dev.blk_bits)
    Npad = batch._npad(dev.corpus_size)
    flat = batch._flat_keys(keys, Qg, Npad)
    for q, (_, n, _) in enumerate(spans):
        row = flat[q * bucket:(q + 1) * bucket]
        assert bool((row[n:] == q * Npad + Npad - 1).all())
        assert bool((pops[q, n:] == 0).all())
    w = rl.k2_flat_work(flat, Qg * Npad)
    assert w == rl.k2_work(Qg * bucket, Qg * Npad)


def test_rows_reject_bad_requests():
    hdrs = torch.tensor([0, 8, 16], dtype=torch.int32)
    pays = torch.tensor([1, 3, 7], dtype=torch.int32)
    out = torch.zeros((2, 4))
    kw = dict(num_docs=4, blk_bits=3)
    with pytest.raises(ValueError, match="twice"):
        kc.score_term_rows(hdrs, pays, [0, 1], [1, 1], out, [1, 1], **kw)
    with pytest.raises(ValueError, match="past the planes"):
        kc.score_term_rows(hdrs, pays, [2], [2], out, [0], **kw)
    with pytest.raises(ValueError, match="out of range"):
        kc.score_term_rows(hdrs, pays, [0], [1], out, [2], **kw)
    kc.score_term_rows(hdrs, pays, [0, 1], [1, 2], out, [1, 0], **kw)
    assert out.tolist() == [[0, 2, 3, 0], [1, 0, 0, 0]]


@pytest.mark.parametrize("ns,kc,with_tf", [([949], 4096, True),
                                            ([0, 65_000, 3], 65_536, True),
                                            ([2_048] * 5, 4096, False)])
def test_k8a_work_is_the_headers_the_indices_and_the_tables(ns, kc, with_tf):
    w = rl.k8a_work(ns, kc, with_tf)
    words = sum(ns)
    per_word = 8 if with_tf else 4
    assert w["bytes"] == per_word * words + (8 if with_tf else 4) * kc * len(
        ns)
    assert w["ops"] == ((rl.K8A_OPS_PER_WORD + (rl.K8A_OPS_PER_TF_WORD
                                                if with_tf else 0)) * words
                        + kc * len(ns))
    # a serving chunk is bound by its bytes: a few operations a word
    assert w["bound_by"] == "bytes"


def test_k8a_work_of_a_chunk_adds_up_its_queries():
    chunk = rl.k8a_work([10, 2000, 0], 4096)
    singles = [rl.k8a_work([n], 4096) for n in (10, 2000, 0)]
    assert chunk["bytes"] == sum(w["bytes"] for w in singles)
    assert chunk["ops"] == sum(w["ops"] for w in singles)


@pytest.mark.parametrize("blk_bits", [0, 3, 14])
def test_k8b_work_pooled_minis_are_a_read_and_a_write(blk_bits):
    kc = 4096
    w = rl.k8b_work(kc, blk_bits, 3, [], 2)
    width = kc << blk_bits
    assert w["bytes"] == 3 * 8 * width + 2 * 4 * kc
    assert w["ops"] == rl.K8B_OPS_PER_SLOT * 3 * width


def test_k8b_work_own_slices_are_the_words_and_the_zeroed_minis():
    kc, bb = 16_384, 3
    w = rl.k8b_work(kc, bb, 0, [100, 70_000], 1)
    width = kc << bb
    assert w["bytes"] == 8 * 70_100 + 2 * 4 * width + 4 * kc
    probes = 70_100 * kc.bit_length()
    assert w["ops"] == (rl.K8B_OPS_PER_SLOT * 2 * width
                        + rl.K8B_OPS_PER_WORD * 70_100
                        + rl.K7_OPS_PER_PROBE * probes)
    both = rl.k8b_work(kc, bb, 2, [100, 70_000], 1)
    assert both["bytes"] == w["bytes"] + 2 * 8 * width


def test_k8b_work_of_a_launch_is_its_halves():
    """The forced cphrase unit (one pooled mini, one own slice of 4,233
    words, Kc = 16,384, S = 8) and its pooled half launched alone: the
    whole is the half plus the own slice's words, zeroed mini and
    search; the row table counts once a launch."""
    kc, bb = 16_384, 3
    whole = rl.k8b_work(kc, bb, 1, [4233], 1)
    half = rl.k8b_work(kc, bb, 1, [], 1)
    own = rl.k8b_work(kc, bb, 0, [4233], 0)
    assert whole["bytes"] == half["bytes"] + own["bytes"]
    assert whole["ops"] == half["ops"] + own["ops"]
    assert half["bytes"] == 8 * (kc << bb) + 4 * kc
    assert half["bound_by"] == whole["bound_by"] == "bytes"


@pytest.mark.parametrize("kind", sorted(rl.K10_FLOPS))
@pytest.mark.parametrize("per_element", [False, True])
def test_k10_work_is_a_read_and_a_write_per_element(kind, per_element):
    w = rl.k10_work(63, 1_000_000, kind, per_element_lens=per_element)
    lens = 4 * 63_000_000 if per_element else 4 * 1_000_000
    assert w["bytes"] == 8 * 63_000_000 + lens + 4 * 63
    assert w["flops"] == rl.K10_FLOPS[kind] * 63_000_000 and w["ops"] == 0
    # far from the float rate: bound by the bytes
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(w["bytes"] / rl.HBM_BYTES_PER_S
                                          * 1e3)


@pytest.mark.parametrize("kind", sorted(rl.K10_FLOPS))
def test_rank_work_reads_each_tf_once_and_stores_no_scores(kind):
    """The fused ranking pass over a terms wave of 99 rows at 1M docs: the
    tf read once, the doc lengths once, an idf and k results a row; less
    than K10 then K3 over the gathered rows by K10's write and K3's read
    of the scores (the gather's read and write besides)."""
    w = rl.rank_work(99, 1_000_000, 10, kind)
    assert w["bytes"] == 4 * 99_000_000 + 4 * 1_000_000 + 4 * 99 \
        + 8 * 99 * 10
    assert w["ops"] == rl.K3_OPS_PER_ELEMENT * 99_000_000
    assert w["flops"] == rl.K10_FLOPS[kind] * 99_000_000
    assert w["bound_by"] == "bytes"
    split = rl.total([rl.k10_work(99, 1_000_000, kind),
                      rl.k3_work(99, 1_000_000, 10)])
    assert split["bytes"] - w["bytes"] == 8 * 99_000_000
    assert split["ops"] == w["ops"] and split["flops"] == w["flops"]


def test_total_adds_the_float_operations():
    a, b = rl.k10_work(2, 100), rl.k10_work(3, 50, "classic")
    t = rl.total([a, b])
    assert t["flops"] == a["flops"] + b["flops"]
    assert t["bytes"] == a["bytes"] + b["bytes"]
    assert rl.bound(0, 0, 67_000)["bound_ms"] == pytest.approx(1e-6)
