"""The harness on the CPU at a tiny size: what it loads, how it finds its
parts by name, its traffic, its refusal to run without a card, the
faults and the control that its comparison must catch, and the work
arithmetic of ``kernels.roofline_pct``."""
import glob
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import run
from benchmark.harness.compare import judge, verdict
from benchmark.harness.corpus import generate
from benchmark.harness.registry import Bench, load_module
from benchmark.harness.traffic import WARMUP, WINDOW, Traffic
from benchmark.reference.search import bf16

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["passage-2m.mixed", "edismax-2m.single", "passage-2m.terms"]
FORBIDDEN = {"jax", "jaxlib", "flax", "searcharray_tpu"}


def shrink(root):
    """The benchmark's files at a tiny size: 3,000 docs, 400 tail words,
    tails drawn from them."""
    for p in glob.glob(os.path.join(root, "benchmark", "configs", "*.json")):
        c = json.load(open(p))
        c["docs"] = 3000
        c["corpus"]["tail_size"] = 400
        json.dump(c, open(p, "w"))
    for p in glob.glob(os.path.join(root, "benchmark", "traffic", "*.json")):
        t = json.load(open(p))
        for d in t.get("draws", {}).values():
            if d["kind"] == "uniform":
                d["hi"] = 390
        json.dump(t, open(p, "w"))
    for p in glob.glob(os.path.join(root, "benchmark", "workloads", "*.json")):
        w = json.load(open(p))
        w.update(warmup_calls=2)
        json.dump(w, open(p, "w"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shrink(root)
    return root


def run_tiny(root, cell, capsys, trace=0, seed=3_000_000_019):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], root=root, device="cpu",
                  look_for_cards=False)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_and_reports_its_metrics(tiny, cell, capsys):
    rc, res = run_tiny(tiny, cell, capsys)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"qps", "p50_ms", "p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"
    rc, res = run_tiny(tiny, cell, capsys, trace=1)
    assert rc == 0 and res["correct"]
    want = {"setup.build_s", "setup.attach_s", "driver.hold_ms"}
    if cell.startswith("edismax"):
        want.add("composer.host_ms")
    assert set(res["metrics"]) == want   # no device metric from a CPU run


def test_nothing_forbidden_is_loaded_and_the_reference_loads_no_port(tiny):
    code = f"""
import json, sys
sys.path.insert(0, {REPO!r})
from benchmark.harness.registry import Bench
from benchmark.harness.corpus import generate
from benchmark.harness.traffic import Traffic, WINDOW
b = Bench({tiny!r})
for cell in {CELLS!r}:
    c = b.cell(cell)
    cfg = b.config(c["config"])
    ref = b.system(cfg["system"]).Reference(
        cfg, generate(cfg["corpus"], cfg["docs"], cfg["fields"], 5, "cpu"))
    t = Traffic(b.traffic(c["traffic"]), cfg["corpus"])
    ref.answers(t.stream(5, WINDOW, 0)[0])
ref_mods = sorted({{m.split(".")[0] for m in sys.modules}})
from benchmark import run
rc = run.main(["--workload", "passage-2m.mixed", "--seed", "5", "--seconds",
               "0.3", "--trace", "1"], root={tiny!r}, device="cpu",
              look_for_cards=False)
print(json.dumps([ref_mods, sorted({{m.split(".")[0] for m in sys.modules}}),
                  rc]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tiny, timeout=600)
    ref_mods, run_mods, rc = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0
    assert not FORBIDDEN & set(run_mods), run_mods
    assert "searcharray_tpu_torch" in run_mods       # the port ran
    assert not (FORBIDDEN | {"searcharray_tpu_torch"}) & set(ref_mods)


def test_a_reader_that_loads_jax_stops_the_result(tmp_path, tiny):
    """A metric reader is loaded after the window; one that imports a
    module named ``jax`` (a stub here) leaves the run with no result."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny, "benchmark"),
                    os.path.join(root, "benchmark"))
    metrics = os.path.join(root, "benchmark", "metrics")
    os.makedirs(os.path.join(metrics, "_stub", "jax"))
    open(os.path.join(metrics, "_stub", "jax", "__init__.py"), "w").close()
    with open(os.path.join(metrics, "loads_jax.py"), "w") as f:
        f.write("import os, sys\n"
                "sys.path.insert(0, os.path.join(os.path.dirname(__file__),"
                " '_stub'))\n"
                "import jax  # noqa: F401\n\n\n"
                "def read(run):\n    return 1.0\n")
    spec = json.load(open(os.path.join(tiny, "BENCHMARK.json")))
    spec["end_to_end"].append({"name": "loads_jax", "unit": "calls",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["passage-2m.terms"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from benchmark import run
sys.exit(run.main(["--workload", "passage-2m.terms", "--seed", "5",
                   "--seconds", "0.3", "--trace", "0"], root={root!r},
                  device="cpu", look_for_cards=False))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=600)
    assert out.returncode == 4, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "may not load: jax" in out.stderr


def test_a_window_that_draws_calls_is_no_measurement(tiny, capsys,
                                                     monkeypatch):
    monkeypatch.setattr(run, "DRAW_MARGIN", 1e-9)    # 2 calls drawn
    rc, res = run_tiny(tiny, "passage-2m.terms", capsys)
    assert rc == 5 and res is None


def test_the_calls_drawn_follow_the_warm_up_rate():
    assert run.calls_to_draw([1.0, 0.125, 0.25], 10) == 161
    assert run.calls_to_draw([0.5], 0.5) == 3


def test_the_guard_names_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "searcharray_tpu_torch_extra", object())
    assert run.forbidden_modules() == ["jax"]


def test_a_cell_config_traffic_and_metric_added_as_files_are_found(
        tmp_path, tiny, capsys):
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny, "benchmark"),
                    os.path.join(root, "benchmark"))
    spec = json.load(open(os.path.join(tiny, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(
        tiny, "benchmark", "configs", "msmarco-passage-2m.json")))
    cfg["docs"] = 1500
    json.dump(cfg, open(os.path.join(root, "benchmark", "configs",
                                     "tiny-new.json"), "w"))
    json.dump({"call": "batch", "clients": 2, "top_k": 5,
               "draws": {"t": {"kind": "uniform", "prefix": "w", "lo": 0,
                               "hi": 50}},
               "batch": [{"repeat": 3, "slop": 1,
                          "queries": [["what", "$t"], "$t"]}]},
              open(os.path.join(root, "benchmark", "traffic", "new-mix.json"),
                   "w"))
    json.dump({"warmup_calls": 1, "check_calls": 4,
               "limits": {"score_gap": 1e-5, "rank_gap": 1e-5,
                          "order_faults": 0}},
              open(os.path.join(root, "benchmark", "workloads",
                                "tiny-new.cell.json"), "w"))
    with open(os.path.join(root, "benchmark", "metrics",
                           "client_calls.py"), "w") as f:
        f.write("def read(run):\n    return run.n_calls\n")
    spec["configs"].append({"name": "tiny-new", "source": "x",
                            "file": "benchmark/configs/tiny-new.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny-new.cell", "config": "tiny-new",
                              "traffic": "new-mix", "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "client_calls", "unit": "calls",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["tiny-new.cell"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    bench = Bench(root)
    assert bench.cell("tiny-new.cell")["config"] == "tiny-new"
    assert bench.config("tiny-new")["docs"] == 1500
    rc, res = run_tiny(root, "tiny-new.cell", capsys)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["client_calls"]["value"] >= 2
    assert "client_calls" not in run_tiny(root, "passage-2m.terms",
                                          capsys)[1]["metrics"]


@pytest.mark.parametrize("mix", ["mixed", "terms", "free-text"])
def test_traffic_is_the_same_for_a_seed_and_other_for_another(mix):
    bench = Bench(REPO)
    cfg = bench.config("msmarco-passage-2m")
    t = Traffic(bench.traffic(mix), cfg["corpus"])
    seed = 2_147_483_659          # above 32 signed bits

    def calls(seed, stream=WINDOW):
        return [c for k in range(t.clients)
                for c in t.stream(seed, stream, k).take(30)]

    a = calls(seed)
    assert a == calls(seed)
    assert t.stream(seed, WINDOW, 0)[29] == a[29]   # drawn alone, the same
    assert a != calls(seed + 1)
    assert a[:30] != calls(seed, WARMUP)[:30]
    if t.kind == "single":
        shapes = sorted(t.spec["shapes"])
        got = sorted(len(c.q.split()) for c in a[:12])
        assert got == sorted(len(s.split()) for s in shapes)
    else:
        assert {c.n_queries for c in a} == {a[0].n_queries}


def test_a_distinct_mix_repeats_no_query_in_a_call():
    bench = Bench(REPO)
    cfg = bench.config("msmarco-passage-2m")
    t = Traffic(bench.traffic("terms"), cfg["corpus"])
    assert t.distinct
    for call in t.stream(2_147_483_659, WINDOW, 0).take(20):
        assert len(set(call.queries)) == call.n_queries == 120
    fixed = {"call": "batch", "top_k": 5, "distinct": True,
             "batch": [{"repeat": 2, "queries": ["what"]}]}
    with pytest.raises(ValueError, match="repeats"):
        Traffic(fixed, cfg["corpus"]).stream(1, WINDOW, 0)[0]


def test_the_command_fails_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "passage-2m.mixed", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def alter_answer(scores, idx):
    idx = idx.copy()
    idx[0, 0] = (idx[0, 0] + 1) % 3000
    return scores, idx


def drop_half(scores, idx):
    half = len(idx) // 2
    scores, idx = scores.copy(), idx.copy()
    scores[half:] = 0
    idx[half:] = np.arange(idx.shape[1])
    return scores, idx


@pytest.mark.parametrize("cell,fault", [
    ("passage-2m.mixed", alter_answer), ("passage-2m.mixed", drop_half),
    ("passage-2m.terms", alter_answer), ("passage-2m.terms", drop_half),
    ("edismax-2m.single", alter_answer)])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault, capsys,
                                            monkeypatch):
    import searcharray_tpu_torch as port

    if cell.startswith("edismax"):
        inner = port.edismax

        def broken(*a, **kw):
            (s, ix), e = inner(*a, **kw)
            s2, ix2 = fault(s[None], ix[None])
            return (s2[0], ix2[0]), e

        monkeypatch.setattr(port, "edismax", broken)
    else:
        inner = port.SearchArray.score_batch
        monkeypatch.setattr(port.SearchArray, "score_batch",
                            lambda *a, **kw: fault(*inner(*a, **kw)))
    rc, res = run_tiny(tiny, cell, capsys)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_bfloat16_is_not_correct(tiny, cell):
    """The reference in bfloat16 in the program's place fails the cell's
    own limits."""
    bench = Bench(tiny)
    c = bench.cell(cell)
    cfg = bench.config(c["config"])
    corpus = generate(cfg["corpus"], cfg["docs"], cfg["fields"], 11, "cpu")
    ref = bench.system(cfg["system"]).Reference(cfg, corpus)
    t = Traffic(bench.traffic(c["traffic"]), cfg["corpus"])
    answers = []
    for i in range(c["check_calls"]):
        call = t.stream(11, WINDOW, 0)[i]
        for low, exact in zip(ref.answers(call, rnd=bf16), ref.answers(call)):
            s, ix = low.top(t.top_k)
            answers.append((s, ix, exact))
    numbers = judge(answers, t.top_k)
    assert not verdict(numbers, c["limits"]), numbers


def test_work_bytes_by_hand():
    work = load_module(os.path.join(REPO, "benchmark", "metrics", "_work.py"),
                       "bench_work_test")
    from benchmark.reference.index import RefIndex

    vocab = {"a": 0, "b": 1, "c": 2}
    docs = [[0, 1, 0], [1, 2], [0, 0, 0, 2]]
    ix = RefIndex(np.array(sum(docs, [])), np.array([3, 2, 4]), vocab)
    # "a" in docs 0 and 2 (df 2, cf 5); "b" df 2, cf 2; "c" df 2; "zzz"
    # reads nothing; positions only for the words marked positional
    need = {"body": {"a": True, "b": True, "c": False, "zzz": False}}
    want = (8 * 4                      # 4 results
            + 4 * 3                    # doc lengths
            + 8 * 2 + 4 * 5            # a
            + 8 * 2 + 4 * 2            # b
            + 8 * 2)                   # c: df 2, no positions
    assert work.call_bytes(need, {"body": ix}, 4) == want


def test_work_bytes_read_nothing_the_port_made(tiny, monkeypatch):
    """The same calls give the same bytes however the port routes them:
    the arithmetic reads the corpus and the queries, not the port."""
    import searcharray_tpu_torch.search.dense as dense

    bench = Bench(tiny)
    cell = bench.cell("passage-2m.mixed")
    cfg = bench.config(cell["config"])
    corpus = generate(cfg["corpus"], cfg["docs"], cfg["fields"], 7, "cpu")
    sysmod = bench.system(cfg["system"])
    work = load_module(os.path.join(tiny, "benchmark", "metrics", "_work.py"),
                       "bench_work_test2")
    t = Traffic(bench.traffic(cell["traffic"]), cfg["corpus"])
    calls = t.stream(7, WINDOW, 0).take(3)
    got = []
    for limit in (dense.DENSE_TERM_BYTES_LIMIT, 0):   # planes, then slices
        monkeypatch.setattr(dense, "DENSE_TERM_BYTES_LIMIT", limit)
        ref = sysmod.Reference(cfg, corpus)
        system = sysmod.System(cfg, corpus, "cpu", run_setup())
        assert all(len(system.run(c)) == c.n_queries for c in calls)
        got.append([work.call_bytes(ref.needs(c), ref.indexes(),
                                    c.n_queries * t.top_k) for c in calls])
    assert got[0] == got[1] and min(got[0]) > 0
    mods = {v.__name__.split(".")[0] for v in vars(work).values()
            if isinstance(v, types.ModuleType)}
    assert "searcharray_tpu_torch" not in mods


def run_setup():
    from benchmark.harness.record import Setup

    return Setup()
