"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``searcharray_tpu_torch``)
beside this folder, on a machine with the CUDA cards the cell asks for.
The cell's configuration, traffic, metrics and limits are found by name
(``harness/registry.py``).  The run draws its corpus and its calls from
``--seed``, builds and warms the system, measures a closed loop of calls
for ``--seconds`` (under the profiler with ``--trace 1``), then checks a
sample of the window's answers against the plain reference
(``reference/``).  It exits non-zero, printing no result, without the
cards (3), if JAX or the JAX package was loaded (4), or if the window
had to draw calls of its own (5).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the whole top-level names a run may not load (the port's own name
# begins with the JAX package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "searcharray_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def cards_missing(chips: int):
    """Why this machine cannot run the cell, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures the card, never the CPU"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA devices, "
                f"{torch.cuda.device_count()} present")
    return None


def cache_dirs(root):
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``build/`` there itself)."""
    base = os.path.join(root, "build", "benchmark-caches")
    for var, sub in (("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None, *, root=ROOT, device="cuda", look_for_cards=True,
         t_start=None):
    args = parse(argv)
    from benchmark.harness.registry import Bench

    bench = Bench(root)
    cell = bench.cell(args.workload)
    cache_dirs(root)
    if look_for_cards:
        why = cards_missing(int(cell["chips"]))
        if why:
            log(why)
            return 3
    result = run_cell(bench, cell, args, device,
                      T_START if t_start is None else t_start)
    if result is None:
        return 5
    # last, after the reference, the metric readers and whatever they
    # import: the process that prints the result never held JAX
    found = forbidden_modules()
    if found:
        log(f"loaded what the benchmark may not load: {', '.join(found)}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


def run_cell(bench, cell, args, device, t_start):
    import torch

    from benchmark.harness import compare
    from benchmark.harness.corpus import generate
    from benchmark.harness.loop import closed_loop
    from benchmark.harness.record import SPAN_KINDS, Run, Setup
    from benchmark.harness.registry import load_module
    from benchmark.harness.trace import DeviceTrace, breakdown
    from benchmark.harness.traffic import WARMUP, WINDOW, Traffic

    config = bench.config(cell["config"])
    system_mod = bench.system(config["system"])
    traffic = Traffic(bench.traffic(cell["traffic"]), config["corpus"])
    setup = Setup()
    setup.stages["start"] = [time.perf_counter() - t_start]
    with setup.span("corpus"):
        corpus = generate(config["corpus"], config["docs"], config["fields"],
                          args.seed, device)
    system = system_mod.System(config, corpus, device, setup)
    warm_s = []
    with setup.span("warmup"):
        for c in range(traffic.clients):
            for call in traffic.stream(args.seed, WARMUP, c).take(
                    int(cell["warmup_calls"])):
                t0 = time.perf_counter()
                system.run(call)
                warm_s.append(time.perf_counter() - t0)
    with setup.span("calls"):
        # every call the window can send, drawn before it: the warm-up's
        # fastest call, DRAW_MARGIN times faster, for the whole window
        streams = [traffic.stream(args.seed, WINDOW, c)
                   for c in range(traffic.clients)]
        drawn = calls_to_draw(warm_s, args.seconds)
        for st in streams:
            st.take(drawn)
            st.sealed = True

    def calls_of(c, i):
        return streams[c][i]

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    maps = system.maps()
    spans = [] if args.trace else None
    tracer = DeviceTrace() if args.trace and on_card else None
    launches0 = launch_counts()
    # what set-up left (corpus strings, the calls drawn, the indexes' host
    # side) is never scanned again by the collector inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log("set-up: " + ", ".join(f"{k} {sum(v):.2f} s" for k, v in
                               setup.stages.items()) + f"; all {setup_s:.2f} s")
    hold0 = sum(m.hold_seconds for m in maps)
    with system.traced(spans if spans is not None else []):
        if tracer:
            tracer.start()
        records, window = closed_loop(system.run, calls_of, traffic.clients,
                                      args.seconds, spans)
        if tracer:
            tracer.stop()
    hold_s = sum(m.hold_seconds for m in maps) - hold0
    launches = {k: v - launches0.get(k, 0)
                for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    timeline = tracer.timeline() if tracer else None
    late = sum(st.late for st in streams)
    log(f"calls: {drawn} drawn a client before the window, "
        f"{len(records)} sent, {late} drawn inside it")
    if late:
        log("the window drew calls of its own: its time holds the "
            "traffic generator's, so the run is no measurement")
        return None
    del system, maps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the comparison with the plain reference, on a sample of the window
    t_ref = time.perf_counter()
    reference = system_mod.Reference(config, corpus)
    sample = sample_calls(records, int(cell["check_calls"]), args.seed)
    answers = []
    for rec in sample:
        call = calls_of(rec.client, rec.i)
        if rec.answers is None:
            continue
        for (s, ix), ref in zip(rec.answers, reference.answers(call)):
            answers.append((s, ix, ref))
    numbers = compare.judge(answers, traffic.top_k)
    failed = sum(r.n_queries for r in records if r.error is not None)
    limits = cell["limits"]
    correct = compare.verdict(numbers, limits) and failed == 0
    log(f"reference: {numbers['compared']} answers of {len(sample)} calls "
        f"compared in {time.perf_counter() - t_ref:.1f} s")

    work = load_module(os.path.join(bench.dir, "metrics", "_work.py"),
                       "benchmark_metric__work")
    indexes = reference.indexes()

    def work_bytes():
        return sum(work.call_bytes(reference.needs(calls_of(r.client, r.i)),
                                   indexes, r.n_queries * traffic.top_k)
                   for r in records)

    run = Run(setup_s=setup_s, setup=setup, calls=records, window=window,
              hold_s=hold_s, peak_bytes=peak, device_kind=kind,
              spans=spans or [], timeline=timeline, work_bytes=work_bytes)
    if timeline is not None:
        check_launches(timeline, launches)
    metrics = {}
    for m in bench.metrics(cell["name"], bool(args.trace)):
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(sum(r.n_queries for r in records)),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if timeline is not None:
        from benchmark.harness.trace import busy_intervals

        lo, hi = window
        dev["busy_s"] = sum(e - s for s, e in
                            busy_intervals(timeline.ops, lo, hi)) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = breakdown(timeline, run.spans, SPAN_KINDS)
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in compare.NAMES}
    checks["failed_queries"] = {"value": failed, "limit": 0}
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    result["checks"] = checks
    return result


DRAW_MARGIN = 2.0


def calls_to_draw(warm_s, seconds: float) -> int:
    """Calls a client can send in ``seconds`` at DRAW_MARGIN times the
    rate of the warm-up's fastest call."""
    import math

    per_call = max(min(warm_s), 1e-6)
    return max(math.ceil(DRAW_MARGIN * seconds / per_call), 1) + 1


def sample_calls(records, n, seed):
    """``n`` of the window's calls drawn from the seed, each client's last
    call among them."""
    import numpy as np

    from benchmark.harness.corpus import seed_of

    last = {}
    for i, r in enumerate(records):
        last[r.client] = i
    rng = np.random.default_rng(seed_of(seed, 3))
    lasts = set(last.values())
    rest = [i for i in range(len(records)) if i not in lasts]
    pick = sorted(lasts | set(
        rng.choice(rest, size=min(max(n - len(last), 0), len(rest)),
                   replace=False).tolist() if rest else []))
    return [records[i] for i in pick]


def launch_counts():
    """The port's per-wrapper launch counters (kernels enqueued, where a
    wrapper counts them apart)."""
    from searcharray_tpu_torch.ops.cuda import score as kc

    out = {}
    for name in dir(kc):
        fn = getattr(kc, name)
        if callable(fn) and isinstance(getattr(fn, "launches", None), int):
            out[name] = int(getattr(fn, "kernels", 0) or fn.launches)
    return out


def check_launches(timeline, launches):
    """Print the profiler's count of the port's hand-written kernels beside
    the wrappers' counters (the profiler has been seen to drop events)."""
    import glob
    import re

    from benchmark.harness.trace import kernel_base

    names = set()
    for path in glob.glob(os.path.join(ROOT, "searcharray_tpu_torch", "csrc",
                                       "*.cu*")):
        with open(path) as f:
            names |= set(re.findall(
                r"__global__\s+(?:void\s+)?"
                r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(",
                f.read()))
    seen = sum(1 for o in timeline.kernels if kernel_base(o.name) in names)
    log(f"kernels.launches check: the profiler saw {seen} hand-written "
        f"kernel launches, the wrappers counted {sum(launches.values())} "
        f"({', '.join(f'{k} {v}' for k, v in sorted(launches.items()) if v)})")


if __name__ == "__main__":
    sys.exit(main())
