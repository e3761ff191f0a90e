"""The control of a cell's comparison: the plain reference, computed in
bfloat16 (every operation's result rounded), put in the program's place
and judged against the float64 reference exactly as a run judges the
program.  Its readings are the upper ends of the cell's limits; a sound
limit fails it.

    python benchmark/tools/control.py --workload <name> --seeds <n> [<n> ...]

at the cell's own size (the corpus is drawn on a CUDA card where there is
one, as a run draws it), on as many calls a seed as a run compares.  One
JSON line a seed on standard output.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None, root=ROOT):
    import torch

    from benchmark.harness.compare import judge, verdict
    from benchmark.harness.corpus import generate
    from benchmark.harness.registry import Bench
    from benchmark.harness.traffic import WINDOW, Traffic
    from benchmark.reference.search import bf16

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = Bench(root)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    traffic = Traffic(bench.traffic(cell["traffic"]), cfg["corpus"])
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        corpus = generate(cfg["corpus"], cfg["docs"], cfg["fields"], seed,
                          device)
        ref = bench.system(cfg["system"]).Reference(cfg, corpus)
        answers = []
        streams = [traffic.stream(seed, WINDOW, c)
                   for c in range(traffic.clients)]
        for i in range(int(cell["check_calls"])):
            call = streams[i % traffic.clients][i // traffic.clients]
            for low, exact in zip(ref.answers(call, rnd=bf16),
                                  ref.answers(call)):
                s, ix = low.top(traffic.top_k)
                answers.append((s, ix, exact))
        numbers = judge(answers, traffic.top_k)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16", **numbers,
                          "fails_limits": not verdict(numbers,
                                                      cell["limits"]),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
