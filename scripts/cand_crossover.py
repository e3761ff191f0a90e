"""Where the candidate engine and edismax's phase pruning pay on the card:
the corpus sizes their thresholds are set from.

For each corpus size (``bench.build_corpus(n, seed=42)``: the README's
MSMARCO-like synthetic corpus, a body index and a title index of each
doc's first 8 tokens, as ``chip_smoke.py`` builds them at 1M docs), the
script times five routings in turns, set by the port's module constants
(``search/candidates.py``, ``solr.py``) as the tests set them:

  off     the engine and the pruning off;
  terms   rare terms on the engine (``CAND_TERM_MIN_DOCS`` at the JAX
          package's 2^16), phrases off;
  engine  rare terms and phrases on the engine (``CAND_MIN_DOCS`` at 2^19
          too), the pruning off;
  prune   edismax's pruning alone (``PHASE_SUBSET_MIN_DOCS`` at 2^17);
  on      all three at the JAX package's values.

A turn is ``--calls`` calls of the serving mix (``bench.serving_queries``,
120 queries, ``score_batch(top_k=10)``), as many of the mixed request with
slop (the serving mix and ``bench.slop_queries`` at slop 2), each call with
a rare tail of its own, and one ``edismax`` call per query of bench.py's
12 in bench.py's configuration.  Every turn starts from emptied phrase-tf
caches and one warming call of each request on other queries.  The turns
run off, terms, engine, prune, on, then back, ``--rounds`` times, so each
routing has ``2 * rounds`` turns.  Before the turns, each routing's
answers to one serving call, one mixed call and three edismax calls are
held to the ``off`` routing's (scores within rtol 1e-6, top-k indices
equal where the k-th score is positive, edismax's explain strings
equal).

Prints one JSON line per corpus size (and appends it to ``--out``): the
card, the build times, the medians and every turn's serving and mixed
qps, edismax p50 ms, and the K8a / K8b launches per call.

    python3 scripts/cand_crossover.py --docs 2097152 4194304 8841823 \\
        --out chiprun_out/cand_crossover.jsonl

``--device cpu`` rehearses the script on a small corpus (the plain
versions of the kernels); a time taken so is not the card's.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

BIG = 1 << 62   # a threshold no corpus reaches
ROUTINGS = {
    "off": ({"CAND_TERM_MIN_DOCS": BIG, "CAND_MIN_DOCS": BIG}, BIG),
    "terms": ({"CAND_TERM_MIN_DOCS": cs.JAX_CAND["CAND_TERM_MIN_DOCS"],
               "CAND_MIN_DOCS": BIG}, BIG),
    "engine": (dict(cs.JAX_CAND), BIG),
    "prune": ({"CAND_TERM_MIN_DOCS": BIG, "CAND_MIN_DOCS": BIG},
              cs.JAX_PHASE_SUBSET_MIN_DOCS),
    "on": (dict(cs.JAX_CAND), cs.JAX_PHASE_SUBSET_MIN_DOCS),
}
METRICS = ("serving mix qps", "mixed request with slop qps", "edismax p50 ms")


def agree(got, want, k):
    """Ranked results within rtol 1e-6, indices equal where the k-th score
    is positive (below it the tail may hold other zero-score docs)."""
    (gs, gi), (ws, wi) = got, want
    gs, gi, ws, wi = map(np.asarray, (gs, gi, ws, wi))
    if gs.shape != ws.shape or not np.allclose(gs, ws, rtol=1e-6, atol=0):
        return False
    full = ws[..., k - 1] > 0
    return bool(np.array_equal(gi[full], wi[full]))


def run_size(n_docs, args, kc, cand, solr):
    import pandas as pd
    import torch

    from bench import build_corpus, serving_queries, slop_queries
    from searcharray_tpu_torch import SearchArray, edismax

    out = {"docs": n_docs, "card": cs.card_line() if args.device == "cuda"
           else "cpu rehearsal"}
    t0 = time.perf_counter()
    corpus = build_corpus(n_docs, seed=42)
    out["corpus s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr = SearchArray.index(corpus, device=args.device)
    titles = [" ".join(doc.split()[:8]) for doc in corpus]
    del corpus
    tarr = SearchArray.index(titles, device=args.device)
    del titles
    df = pd.DataFrame({"title": tarr, "body": arr})
    if args.device == "cuda":
        torch.cuda.synchronize()
    out["index s"] = time.perf_counter() - t0
    out["blk_bits"] = arr.dev.blk_bits
    print(f"{n_docs} docs indexed ({out['corpus s']:.1f} s corpus, "
          f"{out['index s']:.1f} s indexes)", flush=True)

    def mixed(r):
        return (serving_queries(r) + slop_queries(r),
                [0] * len(serving_queries(r))
                + [cs.SLOP] * len(slop_queries(r)))

    mix_n, mixs_n = len(serving_queries(0)), len(mixed(0)[0])
    counted = ("cand_rows", "cand_minis")

    def forget():
        for a in (arr, tarr):
            cs.forget_phrase_rows(a.dev)

    def answers():
        sq, ss = mixed(7)
        return ([arr.score_batch(serving_queries(7), top_k=cs.TOP_K),
                 arr.score_batch(sq, top_k=cs.TOP_K, slop=ss)],
                [edismax(df, q=q, top_k=cs.TOP_K, **cs.ED_KW)
                 for q in cs.ED_QUERIES[:3]])

    def turn(t, calls):
        res = {}
        before = {k: getattr(kc, k).launches for k in counted}
        t0 = time.perf_counter()
        for c in range(calls):
            arr.score_batch(serving_queries(11000 + 100 * t + c),
                            top_k=cs.TOP_K)
        res["serving mix qps"] = calls * mix_n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for c in range(calls):
            q, s = mixed(21000 + 100 * t + c)
            arr.score_batch(q, top_k=cs.TOP_K, slop=s)
        res["mixed request with slop qps"] = calls * mixs_n / (
            time.perf_counter() - t0)
        res["K8a, K8b launches per serving / mixed call"] = [
            (getattr(kc, k).launches - before[k]) / (2 * calls)
            for k in counted]
        times = []
        for q in cs.ED_QUERIES:
            t0 = time.perf_counter()
            edismax(df, q=q, top_k=cs.TOP_K, **cs.ED_KW)
            times.append((time.perf_counter() - t0) * 1e3)
        res["edismax p50 ms"] = float(np.median(times))
        return res

    # every routing's answers against the off routing's
    checks = {}
    for name, (consts, phase) in ROUTINGS.items():
        with cs.thresholds(cand, solr, consts, phase):
            forget()
            checks[name] = answers()
    ref_b, ref_e = checks["off"]
    out["agrees with off"] = {
        name: all(agree(g, w, cs.TOP_K) for g, w in zip(b, ref_b))
        and all(agree(g[0], w[0], cs.TOP_K) and g[1] == w[1]
                for g, w in zip(e, ref_e))
        for name, (b, e) in checks.items()}

    order = list(ROUTINGS)
    turns = []
    for r in range(args.rounds):
        for t, name in enumerate(order + order[::-1]):
            consts, phase = ROUTINGS[name]
            with cs.thresholds(cand, solr, consts, phase):
                forget()
                turn(50 + 10 * r + t, 1)   # warm, on other queries
                turns.append((name, turn(10 * r + t, args.calls)))
    out["medians"] = {
        name: {m: float(np.median([res[m] for nm, res in turns if nm == name]))
               for m in METRICS}
        for name in order}
    out["launches"] = {
        name: next(res["K8a, K8b launches per serving / mixed call"]
                   for nm, res in turns if nm == name) for name in order}
    out["turns"] = [(name, {m: res[m] for m in METRICS})
                    for name, res in turns]
    del df, arr, tarr
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, nargs="+",
                    default=[1 << 21, 1 << 22, 8_841_823],
                    help="corpus sizes, smallest first")
    ap.add_argument("--calls", type=int, default=cs.MIX_CALLS,
                    help="calls of each request per turn")
    ap.add_argument("--rounds", type=int, default=2,
                    help="passes of the turn order and back")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="append each size's JSON line here")
    args = ap.parse_args()
    import torch

    from searcharray_tpu_torch import solr
    from searcharray_tpu_torch.ops.cuda import score as kc
    from searcharray_tpu_torch.search import candidates as cand

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("cand_crossover: no CUDA device", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        kc.build()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    for n_docs in args.docs:
        res = run_size(n_docs, args, kc, cand, solr)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
