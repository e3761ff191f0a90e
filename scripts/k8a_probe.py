"""Device times of K8a (candidate rows) on a synthetic unit shaped like the
serving mix's largest ``cterm`` launch of ``chip_smoke.py`` (5 rare terms,
153,788 posting words, Kc = 65,536, 1M docs), for several builds of the
kernel library in turns.

Run on the card from the repo root::

    python3 scripts/k8a_probe.py [--lib NAME=CSRC_DIR ...] [--shapes]

The package's own ``csrc`` is always built ("new").  Each ``--lib`` adds a
library built from another directory of kernel sources (an earlier
commit's ``searcharray_tpu_torch/csrc``, filled with ``git show``, or an
edited copy: only ``cand_rows.cu`` is needed).  A library of the
two-kernel K8a (no ``sa_cand_rows_grid``) runs through
``chip_smoke.parent_cand_rows``.  ``--shapes`` adds copies of the
package's ``cand_rows.cu`` at other block shapes (threads x words a
thread: 512 x 4, 256 x 8, 1,024 x 1) and cut copies (no tails, no tiles,
no look-back; the tiles alone stopped after a tile's record, its words,
its scan or its look-back: the time of what is left).  Every whole build is first held
to the plain version bit for bit; builds are timed in turns (each in
order, then in reverse), device time from ``torch.profiler``
(``chip_smoke.DeviceTimer``).  Prints the card and one JSON line per
build.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from searcharray_tpu_torch.ops.cuda import roofline as rl  # noqa: E402
from searcharray_tpu_torch.ops.cuda import score as kc  # noqa: E402

THREADS, ITEMS = "constexpr int THREADS = 1024;", "constexpr int ITEMS = 2;"
EDITS = {
    "512x4": [(THREADS, "constexpr int THREADS = 512;"),
              (ITEMS, "constexpr int ITEMS = 4;")],
    "256x8": [(THREADS, "constexpr int THREADS = 256;"),
              (ITEMS, "constexpr int ITEMS = 8;")],
    "1024x1": [(ITEMS, "constexpr int ITEMS = 1;")],
    "cut: no tails": [("if (table == 0 || blockIdx.x < tail0) return;",
                       "return;")],
    "cut: no tiles": [("for (int64_t t = blockIdx.x; t < n_tiles;",
                       "for (int64_t t = blockIdx.x; t < 0;"),
                      ("if (lo >= known) continue;", "continue;")],
    "cut: no look-back": [("base = look_back(status, t, first, epoch);",
                           "base = 0;")],
}
# a tile's phases: each copy runs the tiles (no tails) up to a point and
# keeps what it computed there live
NO_TAILS = EDITS["cut: no tails"][0]
EDITS.update({
    "cut: tile record": [NO_TAILS, (
        "    const int len = static_cast<int>(end - word < TILE ? end - word"
        " : TILE);\n",
        "    const int len = static_cast<int>(end - word < TILE ? end - word"
        " : TILE);\n    if (threadIdx.x == 0 && len == -7) rows[0] = q;\n"
        "    continue;\n")],
    "cut: + words": [NO_TAILS, (
        "    __syncthreads();  // keys\n",
        "    __syncthreads();  // keys\n    if (threadIdx.x == 0 && keys[1] +"
        " pops == -7) rows[0] = 1;\n    continue;\n")],
    "cut: + scan": [NO_TAILS, (
        "    // the runs of the query begun before the tile\n",
        "    if (threadIdx.x == 0 && total == -7) rows[0] = 1;\n    continue;"
        "\n    // the runs of the query begun before the tile\n")],
    "cut: + look-back": [NO_TAILS, (
        "    const int64_t base = base_s;\n",
        "    if (threadIdx.x == 0 && base_s == -7) rows[0] = 1;\n"
        "    __syncthreads();\n    continue;\n"
        "    const int64_t base = base_s;\n")],
})


def edited_copy(name: str, edits, root: str) -> str:
    with open(os.path.join(kc.CSRC_DIR, "cand_rows.cu")) as f:
        src = f.read()
    for a, b in edits:
        if a not in src:
            raise SystemExit(f"cand_rows.cu changed: update EDITS[{name!r}]")
        src = src.replace(a, b)
    d = os.path.join(root, name.replace(" ", "").replace(":", "_"))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cand_rows.cu"), "w") as f:
        f.write(src)
    return d


def unit(seed=0, num_docs=1_000_000, blk_bits=3,
         sizes=(40_000, 35_000, 30_000, 28_000, 20_788)):
    """Five rare terms' doc-sorted slices, one word a doc, end to end."""
    rng = np.random.default_rng(seed)
    hs, ps, offs, at = [], [], [], 0
    for n in sizes:
        docs = np.sort(rng.choice(num_docs, n, replace=False))
        hs.append((docs << blk_bits | rng.integers(0, 8, n)).astype(np.int32))
        ps.append(rng.integers(1, 1 << 18, n).astype(np.int32))
        offs.append(at)
        at += n
    return (torch.from_numpy(np.concatenate(hs)).cuda(),
            torch.from_numpy(np.concatenate(ps)).cuda(), offs, list(sizes))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lib", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--shapes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8a_probe: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    dirs = {"new": kc.CSRC_DIR}
    for spec in args.lib:
        name, _, d = spec.partition("=")
        dirs[name] = d
    root = os.path.join(kc.BUILD_DIR, "k8a_probe_src")
    if args.shapes:
        for name, edits in EDITS.items():
            dirs[name] = edited_copy(name, edits, root)
    libs = {name: kc.load_library(kc.build(d, os.path.join(
        kc.BUILD_DIR, "k8a_probe", name.replace(" ", "").replace(":", "_"))))
        for name, d in dirs.items()}
    hdrs, pays, offs, sizes = unit()
    kw = dict(num_docs=1_000_000, blk_bits=3)
    kc_ = 65_536
    want = kc.cand_rows_plain(hdrs, pays, np.asarray(offs), np.asarray(sizes),
                              kc_, **kw)
    orig, extra = kc.cand_rows, [0]

    def run(lib):
        def f():
            kc._lib = lib
            fn = (orig if hasattr(lib, "sa_cand_rows_grid")
                  else chip_smoke.parent_cand_rows(lib, orig, extra))
            return fn(hdrs, pays, offs, sizes, kc_, **kw)
        return f

    for name, lib in libs.items():
        if name.startswith("cut"):
            continue
        got = run(lib)()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{name}: K8a differs from its plain version")
    timer = chip_smoke.DeviceTimer("cuda")
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(timer(run(libs[name]), iters=50,
                                 names=("cand_rows",))[0])
    work = rl.k8a_work(sizes, kc_)
    for name, ms in times.items():
        print(json.dumps({"build": name, "device_ms": ms,
                          "median_ms": float(np.median(ms)),
                          "bound_ms": work["bound_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
