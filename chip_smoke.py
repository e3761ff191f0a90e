"""Smoke test of the PyTorch/CUDA port (searcharray_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path once at the 1M-doc tier of bench.py (zipfian
corpus, ~30k vocabulary, 20-89 tokens per doc, seed 42), through the
entry points a user calls, and checks it:

1. environment: a CUDA device, torch/CUDA versions, the card's name and
   power limit;
2. build: the hand-written kernels K1 (csrc/score_term.cu) and K2
   (csrc/segment_sum.cu) compile with nvcc for sm_90a;
3. main path, with every kernel launch counter set to 0 first:
   ``SearchArray.index(corpus, device="cuda")`` -> ``score`` ->
   ``topk`` -> ``score_batch(top_k=10)`` blocking and pipelined, each held
   to a numpy oracle computed from the host postings; then the same
   ``score_batch`` on a 40k-doc index with one ~220k-token document,
   which is too large for dense planes and takes the sparse term group
   (K2); the launch counts are read right after it and every kernel
   must have run;
4. the sparse term group (``batch._term_group_fn``, reduced by K2) on the
   1M-doc index, held to the dense ``dterm`` results;
5. each kernel against its plain PyTorch version, on the card, at the
   shapes the main path gave it (K1 on the slices of its tf fills, K2 on
   the flat keys of the long-document batch), with their times;
6. evidence: timings, ``score_batch`` qps over several windows and
   memory, each beside the card's name and power limit; the kernels
   line; the result line.

Exits non-zero, before printing any result, without a CUDA device or
outside the repository.
"""
import json
import subprocess
import sys
import time

import numpy as np

N_DOCS = 1_000_000
LONG_DOCS = 40_000
TOP_K = 10
DEVICE = "cuda"
WINDOWS = 5       # score_batch qps windows
HOT_CALLS = 25    # calls per hot window (~0.5 s on an H100)
COLD_CALLS = 10   # calls per cold window


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"ok: {what}", flush=True)


def oracle_tf(post, tid, n_docs):
    """Per-doc tf from the host posting words: popcount, added by doc."""
    from searcharray_tpu_torch.ops import encoding as enc

    words = post.term_slice(tid)
    keys = enc.keys_of(words).astype(np.int64)
    pops = enc.popcount64(words & enc.LSB_MASK).astype(np.float64)
    return np.bincount(keys, weights=pops, minlength=n_docs).astype(np.float32)


def oracle_bm25(tf, doc_lens, df, n_docs, avgdl, k1=1.2, b=0.75):
    """float32 BM25 in the port's association (Lucene 9 form)."""
    idf = np.float32(np.log1p((n_docs - df + 0.5) / (df + 0.5)))
    k1f, bf, avg = np.float32(k1), np.float32(b), np.float32(avgdl)
    norm = k1f * ((np.float32(1.0) - bf) + bf * (doc_lens / avg))
    return (tf / (tf + norm)) * idf


def oracle_scores(dev, term):
    """BM25 of one term over the corpus of a DeviceIndex, from its host
    postings (zeros for a vocabulary miss)."""
    n = dev.corpus_size
    if term not in dev.vocab:
        return np.zeros(n, np.float32)
    tid = dev.vocab.get_term_id(term)
    return oracle_bm25(oracle_tf(dev.postings, tid, n), dev.doc_lens_np,
                       int(dev.doc_freqs[tid]), n, dev.avg_doc_length)


def oracle_topk(scores, k):
    """Top-k by (-score, index), the smallest-index tie rule."""
    kth = np.partition(scores, len(scores) - k)[len(scores) - k]
    cand = np.flatnonzero(scores >= kth)
    order = np.lexsort((cand, -scores[cand]))[:k]
    return cand[order]


def check_ranking(dev, terms, scores, idx, what):
    """Top-k scores within rtol 1e-6 of the oracle's, indices equal
    wherever the k-th score is > 0 (below it the zero tail ties)."""
    for term, got_s, got_i in zip(terms, scores, idx):
        want = oracle_scores(dev, term)
        want_i = oracle_topk(want, len(got_i))
        if not np.allclose(got_s, want[want_i], rtol=1e-6, atol=0):
            raise AssertionError(f"{what}: top-k scores of {term!r} differ")
        if want[want_i[-1]] > 0 and not np.array_equal(got_i, want_i):
            raise AssertionError(f"{what}: top-k indices of {term!r} differ")
    check(len(terms) == len(scores),
          f"{what} agrees with the numpy oracle on {len(terms)} queries")


def long_doc_segment_sums(ldev, terms):
    """(flat keys, values, num_docs) of every K2 launch ``score_batch``
    makes for ``terms`` on an index that is not dense-eligible, rebuilt as
    ``batch._flat_segment_sum`` builds them, by ascending bucket."""
    from searcharray_tpu_torch.search import batch

    tids = [[ldev.vocab.get_term_id(t)] for t in terms if t in ldev.vocab]
    groups = batch._classify(ldev, tids, "bm25")
    Npad = batch._npad(ldev.corpus_size)
    calls = []
    for (kind, bucket), rows in sorted(groups.items()):
        assert kind == "term", kind
        keys, pops = batch._slice_keys(
            ldev.hdrs, ldev.pays, [r[1][0] for r in rows],
            [r[2][0] for r in rows], bucket, ldev.blk_bits)
        calls.append((batch._flat_keys(keys, len(rows), Npad),
                      pops.reshape(-1).contiguous(), len(rows) * Npad))
    return calls


def cuda_ms(fn, iters=50):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from bench import TERM_QUERIES, build_corpus
    from searcharray_tpu_torch import SearchArray
    from searcharray_tpu_torch.ops.cuda import score as kc
    from searcharray_tpu_torch.search import batch, dense, scoring

    # ---- 1. environment ----------------------------------------------
    card = card_line()
    tag = f"[{card}]"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    so = kc.build()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s -> {so}",
          flush=True)

    # ---- 3. main path (counted) -----------------------------------------
    t0 = time.perf_counter()
    corpus = build_corpus(N_DOCS, seed=42)
    corpus_s = time.perf_counter() - t0
    kc.score_term.launches = 0
    kc.segment_sum.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arr = SearchArray.index(corpus, device=DEVICE, autowarm=False)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = arr.dev  # attach: upload the posting planes
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr.warm()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del corpus
    n = len(arr)
    post = dev.postings
    check(n == N_DOCS and dev.blk_bits == 3,
          f"index of {n} docs on {dev.device}, blk_bits {dev.blk_bits}")

    avgdl = dev.avg_doc_length
    s_what = arr.score("what")
    s_rare = arr.score("w4095")
    top_scores, top_idx = arr.topk("star", k=TOP_K)
    rare = [f"w{i}" for i in range(4000, 29000, 125)]
    queries = list(TERM_QUERIES) + rare
    b_scores, b_idx = arr.score_batch(queries, top_k=TOP_K)
    collect = arr.score_batch(queries, top_k=TOP_K, block=False)
    p_scores, p_idx = collect()

    for term, got in (("what", s_what), ("w4095", s_rare)):
        tid = arr.term_dict.get_term_id(term)
        tf = oracle_tf(post, tid, n)
        check(np.array_equal(arr.termfreqs(term), tf),
              f"termfreqs({term!r}) equals the numpy oracle exactly")
        want = oracle_scores(dev, term)
        check(got.shape == (n,) and np.all(np.isfinite(got))
              and np.allclose(got, want, rtol=1e-6, atol=0),
              f"score({term!r}) within rtol 1e-6 of the oracle "
              f"(max abs err {np.abs(got - want).max():.3g})")
    check_ranking(dev, ["star"], [top_scores], [top_idx],
                  f"topk('star', k={TOP_K})")
    check_ranking(dev, queries, b_scores, b_idx,
                  f"score_batch(top_k={TOP_K})")
    check(np.array_equal(p_idx, b_idx) and np.array_equal(p_scores, b_scores),
          "score_batch(block=False) + collect() equals the blocking call")

    # long documents: one ~220k-token doc needs 14 block bits, so dense
    # planes would pass the per-plane limit and score_batch takes the
    # sparse term group, reduced by K2
    long_corpus = build_corpus(LONG_DOCS, seed=7)
    long_corpus[0] = " ".join(long_corpus[1:4001])
    larr = SearchArray.index(long_corpus, device=DEVICE)
    del long_corpus
    ldev = larr.dev
    check(ldev.blk_bits == 14 and not dense.dense_eligible(ldev),
          f"long-document index of {len(larr)} docs is not dense-eligible")
    k2_before = kc.segment_sum.launches
    l_scores, l_idx = larr.score_batch(TERM_QUERIES, top_k=TOP_K)
    k2_long = kc.segment_sum.launches - k2_before
    check_ranking(ldev, TERM_QUERIES, l_scores, l_idx,
                  f"long-document score_batch(top_k={TOP_K})")

    # the main path ends here: read its launch counts before anything else
    # launches a kernel
    launches = {"score_term": kc.score_term.launches,
                "segment_sum": kc.segment_sum.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"main path launches: {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          "every kernel of the path launched in the main-path run")

    # ---- 4. sparse term group (K2) vs dterm ------------------------------
    dense_want = batch.score_batch_fused(
        dev, [[arr.term_dict.get_term_id(t)] for t in TERM_QUERIES])
    sparse_rows = []
    for term in TERM_QUERIES:
        tid = arr.term_dict.get_term_id(term)
        off, length, bucket = dev.term_span(tid)
        idf = scoring.host_idf("bm25", [int(dev.doc_freqs[tid])], n, avgdl)
        fn = batch._term_group_fn(dev, 1, bucket, "bm25", 1.2, 0.75, None)
        sparse_rows.append(fn(dev.hdrs, dev.pays, dev.doc_lens,
                              np.float32(avgdl), [off], [length], [idf]))
    sparse = torch.cat(sparse_rows).cpu().numpy()
    check(np.allclose(sparse, dense_want, rtol=1e-6, atol=0),
          "sparse term group (K2) equals the dterm results within rtol 1e-6 "
          f"(max abs err {np.abs(sparse - dense_want).max():.3g})")

    # ---- 5. kernels vs plain at the main path's shapes --------------------
    k1_err = 0.0
    k1_pairs = {}
    for term in ("what", "w333", "w4095"):
        tid = arr.term_dict.get_term_id(term)
        h, p = scoring.term_planes(dev, tid)
        idf = scoring.host_idf("bm25", [int(dev.doc_freqs[tid])], n, avgdl)
        for kind in ("none", "bm25", "bm25_legacy", "bm25_impact"):
            args = (h, p, dev.doc_lens, idf, np.float32(avgdl))
            kw = dict(num_docs=n, blk_bits=dev.blk_bits, kind=kind)
            got = kc.score_term(*args, **kw)
            want = kc.score_term_plain(*args, **kw)
            if kind == "none":
                ok = torch.equal(got, want)
            else:
                ok = torch.allclose(got, want, rtol=1e-6, atol=1e-7)
            err = (got - want).abs().max().item()
            k1_err = max(k1_err, err)
            if not ok:
                raise AssertionError(f"K1 {term}/{kind} differs: {err}")
        # the tf-pool fill's call: kind none into a fresh f32[N]
        k1_pairs[term] = (h.numel(), *(
            lambda fn=fn, h=h, p=p: fn(h, p, dev.doc_lens, 0.0, 1.0,
                                       num_docs=n, blk_bits=dev.blk_bits,
                                       kind="none")
            for fn in (kc.score_term, kc.score_term_plain)))
    check(True, f"K1 equals its plain version (tf exact, scores rtol 1e-6) "
          f"on 3 terms x 4 kinds, max abs err {k1_err:.3g}")

    # K2 on the flat keys _flat_segment_sum built for the long-document
    # score_batch: one launch per (term, bucket) group
    k2_calls = long_doc_segment_sums(ldev, TERM_QUERIES)
    check(len(k2_calls) == k2_long,
          f"{len(k2_calls)} rebuilt sparse groups = {k2_long} K2 launches "
          "of the long-document score_batch")
    k2_err = 0.0
    pad = 1 << 30
    tail = (torch.full((4096,), pad, dtype=torch.int32, device=ldev.device),
            torch.ones(4096, dtype=torch.float32, device=ldev.device))
    for flat, fvals, n_out in [
            *k2_calls,
            # the largest group again, with a 2^30 pad tail to drop
            (torch.cat([k2_calls[-1][0], tail[0]]),
             torch.cat([k2_calls[-1][1], tail[1]]), k2_calls[-1][2])]:
        got = kc.segment_sum(flat, fvals, num_docs=n_out)
        want = kc.segment_sum_plain(flat, fvals, num_docs=n_out)
        err = (got - want).abs().max().item()
        k2_err = max(k2_err, err)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"K2 differs on {flat.numel()} keys: {err}")
    k2_keys = sum(c[0].numel() for c in k2_calls)
    k2_slots = sum(c[2] for c in k2_calls)
    check(True, f"K2 equals its plain version within rtol 1e-5 on the "
          f"{len(k2_calls)} groups of the long-document batch ({k2_keys} "
          f"flat keys, {k2_slots} slots) and with a 2^30 pad tail, max abs "
          f"err {k2_err:.3g}")

    # kernel and plain version in turns: kernel, plain, plain, kernel
    k1_times = {}
    for term, (words, run, plain) in k1_pairs.items():
        t = [cuda_ms(run), cuda_ms(plain), cuda_ms(plain), cuda_ms(run)]
        k1_times[term] = (words, t)
    k1_ms, k1_plain_ms = k1_times["what"][1][0], k1_times["what"][1][1]
    # K2 time: all launches of the long-document batch, per batch
    def k2_batch(fn):
        return lambda: [fn(f, v, num_docs=m) for f, v, m in k2_calls]

    k2_run, k2_plain = k2_batch(kc.segment_sum), k2_batch(kc.segment_sum_plain)
    k2_ms, k2_plain_ms = cuda_ms(k2_run), cuda_ms(k2_plain)
    k2_plain_ms2, k2_ms2 = cuda_ms(k2_plain), cuda_ms(k2_run)

    # ---- 6. evidence -------------------------------------------------------
    def host_ms(fn, iters):
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    score_ms = host_ms(lambda: arr.score("what"), 30)
    topk_ms = host_ms(lambda: arr.topk("star", k=TOP_K), 30)

    # score_batch qps over WINDOWS windows.  "hot": the same 206 queries
    # every call (most tf rows stay in the pool); "cold": every call a
    # fresh set of 200 rare terms, so each call fills ~200 rows with K1
    def qps_windows(window, n_queries):
        rates, fills = [], 0
        for w in range(WINDOWS):
            k1_before = kc.score_term.launches
            t0 = time.perf_counter()
            calls = window(w)
            rates.append(calls * n_queries / (time.perf_counter() - t0))
            fills += kc.score_term.launches - k1_before
        return rates, fills / (WINDOWS * calls)

    def hot_blocking(w):
        for _ in range(HOT_CALLS):
            arr.score_batch(queries, top_k=TOP_K)
        return HOT_CALLS

    def hot_pipelined(w):
        pending = None
        for _ in range(HOT_CALLS):
            nxt = arr.score_batch(queries, top_k=TOP_K, block=False)
            if pending is not None:
                pending()
            pending = nxt
        pending()
        return HOT_CALLS

    cold_sets = [[f"w{4000 + j + 125 * i}" for i in range(200)]
                 for j in range(1, 1 + WINDOWS * COLD_CALLS)]
    check(all(t in arr.term_dict for s in cold_sets for t in s),
          f"{WINDOWS * COLD_CALLS} cold query sets of 200 indexed terms")

    def cold_blocking(w):
        for c in range(COLD_CALLS):
            arr.score_batch(cold_sets[w * COLD_CALLS + c], top_k=TOP_K)
        return COLD_CALLS

    arr.score_batch(queries, top_k=TOP_K)
    qps_hot, fills_hot = qps_windows(hot_blocking, len(queries))
    qps_pipe, fills_pipe = qps_windows(hot_pipelined, len(queries))
    qps_cold, fills_cold = qps_windows(cold_blocking, 200)

    evidence = [
        ("corpus generation s", corpus_s),
        ("host build s (SearchArray.index)", build_s),
        ("upload s (posting planes)", upload_s),
        ("warm s (tf pool prefill)", warm_s),
        ("p50 score('what') ms", score_ms),
        ("p50 topk('star', k=10) ms", topk_ms),
        *((f"score_batch qps {name}, {WINDOWS} windows of {calls} calls "
           f"(median; windows; K1 fills per call)",
           f"{float(np.median(rates))}; {rates}; {fills}")
          for name, calls, rates, fills in (
              (f"hot blocking ({len(queries)} terms, top_k=10)",
               HOT_CALLS, qps_hot, fills_hot),
              (f"hot pipelined ({len(queries)} terms, top_k=10)",
               HOT_CALLS, qps_pipe, fills_pipe),
              ("cold blocking (200 fresh rare terms, top_k=10)",
               COLD_CALLS, qps_cold, fills_cold))),
        *((f"K1 ms kernel, plain, plain, kernel ({term!r}, {words} words, "
           "kind none)", " ".join(map(str, t)))
          for term, (words, t) in k1_times.items()),
        (f"K2 ms kernel, plain, plain, kernel (long-document batch: "
         f"{len(k2_calls)} launches, {k2_keys} flat keys, {k2_slots} slots)",
         f"{k2_ms} {k2_plain_ms} {k2_plain_ms2} {k2_ms2}"),
        ("max memory allocated bytes (main path)", peak_bytes),
    ]
    for name, value in evidence:
        print(f"evidence: {name} = {value} {tag}", flush=True)
    print(json.dumps({"kernels": [
        {"name": "score_term (K1)", "route": "cuda",
         "source": "searcharray_tpu_torch/csrc/score_term.cu",
         "replaces": "searcharray_tpu/ops/pallas/score.py:86",
         "launches": launches["score_term"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "segment_sum (K2)", "route": "cuda",
         "source": "searcharray_tpu_torch/csrc/segment_sum.cu",
         "replaces": "searcharray_tpu/ops/pallas/score.py:196",
         "launches": launches["segment_sum"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
