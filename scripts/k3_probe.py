"""Device times of K3 (exact top-k) and K8b (mini-planes) on synthetic
shapes, for several builds of the kernel library in turns.

Run on the card from the repo root::

    python3 scripts/k3_probe.py [--lib NAME=CSRC_DIR ...] [--load-only]

The package's own ``csrc`` is always built ("new").  Each ``--lib`` adds
a library built from another directory of kernel sources (an earlier
commit's ``searcharray_tpu_torch/csrc``, filled with ``git show``, or an
edited copy).  ``--load-only`` adds a copy of the package's sources whose
K3 tile kernel returns once its tile is in shared memory (the merge then
reads indices modulo the row): the time of the loads alone.  Builds are timed in
turns (each in order, then in reverse), device time from
``torch.profiler`` (``chip_smoke.DeviceTimer``); every build but the
load-only one is first held to the plain version, bit for bit.  Prints the
card and one JSON line per unit.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import DeviceTimer  # noqa: E402
from searcharray_tpu_torch.ops.cuda import score as kc  # noqa: E402


def load_only_copy(dst: str) -> str:
    """The package's sources with K3's tile kernel cut after its loads."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(kc.CSRC_DIR, dst)
    path = os.path.join(dst, "topk.cu")
    with open(path) as f:
        src = f.read()
    cut = "    least = min(least, wsum[w]);\n  }\n"
    read = "x[row * n + id]"
    if cut not in src or read not in src:
        raise SystemExit("topk.cu changed: update load_only_copy")
    src = src.replace(cut, cut + "  if (least != 12345u) return;\n", 1)
    src = src.replace(read, "x[row * n + id % n]")
    with open(path, "w") as f:
        f.write(src)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lib", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--load-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = {"new": kc._get_lib()}
    dirs = dict(a.split("=", 1) for a in args.lib)
    if args.load_only:
        dirs["load-only"] = load_only_copy(
            os.path.join(kc.BUILD_DIR, "load_only_src"))
    for name, d in dirs.items():
        libs[name] = kc.load_library(kc.build(
            d, os.path.join(kc.BUILD_DIR, "probe_" + name)))
    order = list(libs)
    order += order[::-1]
    dev = torch.device("cuda")
    timer = DeviceTimer(dev)

    def with_lib(lib, fn):
        def run():
            saved = kc._lib
            kc._lib = lib
            try:
                return fn()
            finally:
                kc._lib = saved
        return run

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    n = 1_000_000

    def bm25(q, nonzero):
        x = torch.randint(0, 40, (q, n), generator=g,
                          device=dev).float() / 3
        return torch.where(torch.rand((q, n), generator=g, device=dev)
                           < nonzero, x, 0.0)

    ties = bm25(150, 0.1)
    for r in range(150):
        at = (1 + r % 50) * 16384 - (r % 7)
        ties[r, at: at + 13] = 50.0 + r
    ties[100:] = torch.where(ties[100:] > 40, ties[100:], 0.0)
    cand = torch.rand((64, 65536), generator=g, device=dev)
    cand[:, 30000:] = -1.0
    units = {"bm25-like [8, 1M]": torch.cat([bm25(5, 0.05),
                                             bm25(3, 0.0001)]),
             "distinct [8, 1M]": torch.rand((8, n), generator=g,
                                            device=dev),
             "ties [150, 1M]": ties, "candidate axis [64, 65536]": cand,
             "candidate axis [200, 16384]": torch.rand(
                 (200, 16384), generator=g, device=dev)}
    for unit, x in units.items():
        wv, wi = kc.topk_plain(x, 10)
        times = {}
        for name in order:
            fn = with_lib(libs[name], lambda: kc.topk(x, 10))
            if name != "load-only":
                v, i = fn()
                if not (torch.equal(i.long(), wi) and torch.equal(
                        v.view(torch.int32), wv.view(torch.int32))):
                    raise AssertionError(f"K3 {name} differs on {unit}")
            times.setdefault(name, []).append(
                timer(fn, 20, ("topk_",))[0])
        print(json.dumps({"kernel": "K3", "unit": unit, "k": 10,
                          "device_ms": times, "torch.topk_device_ms":
                          timer(lambda: torch.topk(x, 10), 20)[0]}),
              flush=True)

    # K8b: one pooled mini and one own-slice mini, Kc = 16384, S = 8, from
    # a 1M-doc plane pool; and the pooled half alone
    nd, bb, S, Kc = 1_000_000, 3, 8, 16384
    pool = torch.randint(0, 1 << 20, (4, nd << bb), device=dev,
                         dtype=torch.int32)
    rng = np.random.default_rng(0)
    rows_np = np.sort(rng.choice(nd, Kc - 50, replace=False))
    docs = np.unique(np.concatenate([rng.choice(rows_np, 2500),
                                     rng.choice(nd, 1800)]))
    words = np.unique(docs * S + rng.integers(0, S, len(docs)))
    hd = torch.from_numpy(np.concatenate([words, [-1] * 64]).astype(
        np.int32)).to(dev)
    pa = torch.from_numpy(rng.integers(1, 1 << 18, len(hd)).astype(
        np.int32)).to(dev)
    rows = torch.from_numpy(np.concatenate([rows_np, [nd] * 50]).astype(
        np.int32)).to(dev)
    kw = dict(pool=pool, hdrs=hd, pays=pa, num_docs=nd, blk_bits=bb)
    spread = torch.arange(S, device=dev)

    def gather():
        flat = (rows.clamp(0, nd - 1).long()[:, None] * S
                + spread).reshape(-1)
        return pool[2, flat]

    for unit, args_ in (("one pooled and one own-slice mini",
                         ([[2, -1]], [[0, 0]], [[0, len(words)]])),
                        ("the pooled mini alone", ([[2]], [[0]], [[0]]))):
        want = kc.minis_for_rows_plain(rows, np.asarray(args_[0]),
                                       *args_[1:], **kw)
        times = {}
        for name in order:
            fn = with_lib(libs[name], lambda: kc.cand_minis(rows, *args_,
                                                            **kw))
            if not torch.equal(fn(), want):
                raise AssertionError(f"K8b {name} differs on {unit}")
            times.setdefault(name, []).append(
                timer(fn, 50, ("cand_minis",))[0])
        print(json.dumps({"kernel": "K8b", "unit": unit, "Kc": Kc,
                          "words": len(words), "device_ms": times,
                          "gather_with_index_device_ms":
                          timer(gather, 50)[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
