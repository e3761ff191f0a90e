"""Where a block of K7 (csrc/merge_step.cu), and with ``--k9`` of K9
(csrc/span_sparse.cu), spends its time.

    python3 scripts/k7_probe.py [--parent-csrc DIR] [--k9]
        (on a machine with one CUDA device)

Builds the committed kernel and copies of it with one part taken out (the
partner search and merge, the output writes, every word's work after the
tile's words are staged; these copies compute wrong results and are only
timed) or one constant changed, and times each by its device time
(``chip_smoke.DeviceTimer``) on one synthetic step of the size of the
largest windowed step of ``chip_smoke.py``: 2,095,523 base words against
2,931,452, uniform over 8M slots, window block 0.  With ``--parent-csrc``
the ``merge_step.cu`` of DIR (the one-block-a-tile design before the
sorted join, C entry ``sa_merge_step``) is timed on the same step first.
Prints microseconds per launch (two turns; with the continuation written;
with L2 flushed before each launch) beside the card's name and power
limit.  Both kernels are the sorted-join pipeline of csrc/sorted_join.cuh;
``--k9`` also times K9 (and DIR's, in turns) on synthetic launches like
``chip_smoke.py``'s K9 units, each held to its plain version, and reads
the same phase clocks from a copy of span_sparse.cu."""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from searcharray_tpu_torch.ops.cuda import roofline as rl  # noqa: E402
from searcharray_tpu_torch.ops.cuda import score as kc  # noqa: E402
from searcharray_tpu_torch.ops.kernels import PAD_HDR32  # noqa: E402

OUT = os.path.join(kc.BUILD_DIR, "k7_probe")
SLOTS = 8_000_000
B, A = 2_095_523, 2_931_452

# the partners: no search and no merge walk, the first staged word taken
NOSEARCH = [(r"if \(lo < 0 \|\| !WALK\) \{.*?// the forward merge\n"
             r"      \}", "lo = 0;")]
NOWRITE = [(r"  put\(key_v, keys\);\n.*?put\(cont_v, conts\);\n",
            "  if (key_v[0] == 12345) keys[0] = count_v[0] + cont_v[0];\n")]
# the block stages its tiles and finds its ranges, and no thread matches
# or writes a word: the pipeline alone
NOWORDS = [(r"for \(int u = 0; u < MS_ITEMS; \+\+u\)",
            "for (int u = 0; u < 0; ++u)")]
# per-block phase clocks: thread 0 adds the cycles of each phase of each
# tile (the first tile's opening; waiting for the tile's copies; finding
# its range and opening the next; issuing the next one's copies; its own
# words) to a device array; sa_clk_read returns and clears it
CLOCKS = [
    (r'#include "sorted_join.cuh"\n',
     '#include "sorted_join.cuh"\n\n__device__ unsigned long long sa_clk[8];\n'
     'extern "C" int sa_clk_read(unsigned long long* out) {\n'
     '  cudaDeviceSynchronize();\n'
     '  cudaMemcpyFromSymbol(out, sa_clk, sizeof(sa_clk));\n'
     '  const unsigned long long zero[8] = {};\n'
     '  return cudaMemcpyToSymbol(sa_clk, zero, sizeof(zero));\n}\n'),
    (r"  if \(t0 >= t1\) return;\n",
     "  if (t0 >= t1) return;\n  long long c_last = clock64();\n"
     "  auto tick = [&](int slot) {\n    if (threadIdx.x == 0) {\n"
     "      const long long c = clock64();\n"
     "      atomicAdd(&sa_clk[slot], (unsigned long long)(c - c_last));\n"
     "      c_last = c;\n      if (slot == 4) atomicAdd(&sa_clk[5], 1ull);\n"
     "    }\n  };\n"),
    (r"  issue\(0\);\n", "  issue(0);\n  tick(0);\n"),
    (r"    sj::cp_async_wait_all\(\);\n    __syncthreads\(\);\n",
     "    sj::cp_async_wait_all();\n    __syncthreads();\n    tick(1);\n"),
    (r"    __syncthreads\(\);\n    if \(t \+ 1 < t1\) issue\(k \^ 1\);\n",
     "    __syncthreads();\n    tick(2);\n    if (t + 1 < t1) issue(k ^ 1);\n"
     "    tick(3);\n"),
    (r"(counts_out \+ out, conts\);\n    \}\n)(  \}\n\}\n)",
     r"\1    tick(4);\n\2"),
]
PHASES = ("first tile opened", "waiting for the copies",
          "range found, next tile opened", "next copies issued",
          "thread 0's words")
VARIANTS = [
    ("as committed", []),
    ("phase clocks", CLOCKS),
    ("no partner search or merge", NOSEARCH),
    ("no output writes", NOWRITE),
    ("staging and ranges only, no word matched", NOWORDS),
    ("6 blocks an SM", [(r"MS_BLOCKS = 8", "MS_BLOCKS = 6")]),
    ("2,048-word window, 5 blocks an SM",
     [(r"MS_CAP = 1024", "MS_CAP = 2048"), (r"MS_BLOCKS = 8", "MS_BLOCKS = 5")]),
    ("256 threads of 4 words, a 1,536-word window, 4 blocks an SM",
     [(r"MS_THREADS = 128", "MS_THREADS = 256"),
      (r"MS_CAP = 1024", "MS_CAP = 1536"), (r"MS_BLOCKS = 8", "MS_BLOCKS = 4")]),
    ("128 threads of 8 words, a 1,536-word window, 4 blocks an SM",
     [(r"MS_ITEMS = 4", "MS_ITEMS = 8"), (r"MS_CAP = 1024", "MS_CAP = 1536"),
      (r"MS_BLOCKS = 8", "MS_BLOCKS = 4")]),
]
# the C entries: this design's, and the one-block-a-tile design's
NEW_ENTRY = ("sa_merge_join", kc._ENTRIES["sa_merge_join"])
OLD_ENTRY = ("sa_merge_step", [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
             + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_void_p])


def build(name, edits, src_dir=kc.CSRC_DIR, entry=NEW_ENTRY):
    """``src_dir``'s kernel with ``edits`` (regex, replacement) applied, as
    a library of its own: (ctypes function, tile, registers per thread)."""
    d = os.path.join(OUT, re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(src_dir, "merge_step.cu")) as f:
        src = f.read()
    for pat, rep in edits:
        new = re.sub(pat, rep, src, flags=re.S)
        if new == src:
            raise RuntimeError(f"{name}: {pat} matches nothing")
        src = new
    with open(os.path.join(d, "merge_step.cu"), "w") as f:
        f.write(src)
    so = os.path.join(d, "lib.so")
    res = subprocess.run(
        [kc._nvcc(), *kc.NVCC_FLAGS, "-I", src_dir, "-Xptxas", "-v",
         "-shared", "-o", so, os.path.join(d, "merge_step.cu")],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    fn = getattr(lib, entry[0])
    fn.argtypes, fn.restype = entry[1], ctypes.c_int
    tile = getattr(lib, entry[0] + "_tile")()
    return fn, tile, re.findall(r"Used (\d+) registers", res.stderr), lib


# K9 launches like chip_smoke.py's units: (name, list lengths, slots,
# blk_bits, w, multiplicities, block window)
K9_CASES = [
    ("largest windowed slop launch, synthetic", [1_576_972, 2_931_452],
     8_000_000, 3, 4, (2, 1), (0, 0)),
    ("a small launch", [90_000, 250_000], 2_000_000, 3, 4, (1, 1), None),
    ("a rare anchor against a dense term", [20_000, 600_000], 640_000, 4, 4,
     (1, 1), None),
    ("the walked path, three terms, w = 21", [300_000] * 3, 2_000_000, 3, 21,
     (1, 1, 1), None),
]


def k9_probe(parent_csrc, timer):
    """K9 on K9_CASES: device us of the parent's kernel and the
    committed one in turns, and the committed one's phase clocks."""
    import shutil

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    libs = {"committed": kc._get_lib()}
    if parent_csrc:
        libs["parent"] = kc.load_library(kc.build(
            parent_csrc, os.path.join(OUT, "k9_parent")))
    src_dir = os.path.join(OUT, "k9_clocks_src")
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(kc.CSRC_DIR, src_dir)
    path = os.path.join(src_dir, "span_sparse.cu")
    with open(path) as f:
        src = f.read()
    for pat, rep in CLOCKS[:-1] + [(
            r"(static_cast<float>\(live_a \? covered_s\[threadIdx\.x\] : 0\);"
            r"\n    \}\n)(  \}\n\}\n)", r"\1    tick(4);\n\2")]:
        new = re.sub(pat, rep, src, flags=re.S)
        if new == src:
            raise RuntimeError(f"K9 clocks: {pat} matches nothing")
        src = new
    with open(path, "w") as f:
        f.write(src)
    clocked = kc.load_library(kc.build(src_dir,
                                       os.path.join(OUT, "k9_clocks")))
    clocked.sa_clk_read.argtypes = [ctypes.c_void_p]
    names = ("span_sparse_kernel", "span_join_kernel")
    for name, sizes, slots, bb, w, mults, window in K9_CASES:
        hs, ps = [], []
        for n in sizes:
            h = np.sort(rng.choice(slots, size=n, replace=False))
            p = rng.integers(0, 1 << 18, n) & rng.integers(0, 1 << 18, n)
            if w > 18:
                p &= rng.integers(0, 1 << 18, n)
            p[rng.random(n) < 0.2] |= (1 << 17) | 1
            hs.append(h.astype(np.int32))
            ps.append(p.astype(np.int32))
        ns = np.asarray(sizes, np.int64)
        hdrs = torch.from_numpy(np.concatenate(
            hs + [np.full(16, PAD_HDR32, np.int32)])).to(dev)
        pays = torch.from_numpy(np.concatenate(
            ps + [np.zeros(16, np.int32)])).to(dev)
        mb = ({} if window is None
              else dict(min_blk=window[0], max_blk=window[1]))

        def run():
            return kc.span_sparse(hdrs, pays, [kc.prefix_offsets(ns)], [ns],
                                  w, mults, blk_bits=bb, **mb)

        want = kc.span_sparse_plain(hdrs, pays, [kc.prefix_offsets(ns)],
                                    [ns], w, mults, blk_bits=bb, **mb)
        us = {}
        saved = kc._lib
        try:
            for label in ("parent", "committed", "committed", "parent"):
                if label not in libs:
                    continue
                kc._lib = libs[label]
                got = run()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"K9 ({label}) differs from plain "
                                         f"on {name}")
                us.setdefault(label, []).append(
                    round(timer(run, 20, names)[0] * 1e3, 1))
            kc._lib = clocked
            clk = (ctypes.c_ulonglong * 8)()
            run()
            clocked.sa_clk_read(clk)
            run()
            clocked.sa_clk_read(clk)
        finally:
            kc._lib = saved
        tiles = max(1, clk[5])
        print(f"K9, {name}: us {us}; phase clocks, cycles a tile of thread "
              "0: " + "; ".join(f"{p} {clk[i] / tiles:.0f}"
                                for i, p in enumerate(PHASES))
              + f" ({clk[5]} tiles) [{chip_smoke.card_line()}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", metavar="DIR",
                    help="also time DIR/merge_step.cu (entry sa_merge_step)")
    ap.add_argument("--k9", action="store_true",
                    help="also time K9 on synthetic launches")
    args = ap.parse_args()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def posting_list(n):
        h = torch.randperm(SLOTS, generator=g, device=dev)[:n].sort().values
        p = torch.randint(1, 1 << 18, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        return h.to(torch.int32), p

    bh, bp = posting_list(B)
    oh, op = posting_list(A)
    hdrs = torch.cat([bh, oh]).contiguous()
    pays = torch.cat([bp, op]).contiguous()
    keys = torch.empty(B, dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.float32, device=dev)
    cont = torch.empty(B, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    timer = chip_smoke.DeviceTimer(dev)
    print(f"the step's bound (roofline.k7_work, no continuation): "
          f"{rl.k7_work([B], [A], False)['bound_ms'] * 1e3:.1f} us", flush=True)

    def report(name, regs, tile, run, kernel):
        # the profiler must see every launch (it has been seen to drop
        # events): count them here, as the wrappers do
        calls = [0]

        def counted(need_cont=False):
            calls[0] += 1
            run(need_cont)

        def time(fn, flush=False):
            return timer(fn, 20, kernel, flush, lambda: calls[0])[0] * 1e3

        us = [time(counted) for _ in range(2)]
        us_cont = time(lambda: counted(True))
        us_flush = time(counted, flush=True)
        print(f"{name}: registers {regs}, tile {tile}: {us[0]:.1f} "
              f"{us[1]:.1f} us; with cont {us_cont:.1f}; flushed "
              f"{us_flush:.1f} [{chip_smoke.card_line()}]", flush=True)

    if args.parent_csrc:
        # one query: base [0, B), other [B, B + A); each tile's query
        fn, tile, regs, _ = build("parent", [], args.parent_csrc, OLD_ENTRY)
        n_tiles = -(-B // tile)
        meta = torch.cat([torch.as_tensor(
            [0, B, B, A, B, 0, 0, 0], device=dev),
            torch.zeros(n_tiles, dtype=torch.int64, device=dev)])

        def run_old(need_cont=False):
            err = fn(hdrs.data_ptr(), pays.data_ptr(), pays.data_ptr(),
                     meta.data_ptr(), 1, n_tiles, 3, 0, 0, 1, 0,
                     keys.data_ptr(), counts.data_ptr(),
                     cont.data_ptr() if need_cont else None, 0, stream)
            if err:
                raise RuntimeError(f"parent: CUDA error {err}")

        report("parent (one block a tile)", regs, tile, run_old,
               ("merge_step_kernel",))
    for name, edits in VARIANTS:
        fn, tile, regs, lib = build(name, edits)
        n_tiles = -(-B // tile)

        def run(need_cont=False):
            flags = (kc.MERGE_RHS
                     | (kc.MERGE_WRITE_CONT if need_cont else 0))
            meta = torch.cat([torch.as_tensor(
                [0, B, B, A, B, 0, 0, 0, flags], device=dev),
                torch.zeros(n_tiles, dtype=torch.int64, device=dev)])
            err = fn(hdrs.data_ptr(), pays.data_ptr(), pays.data_ptr(),
                     meta.data_ptr(), 1, n_tiles, 3, 0, 0, keys.data_ptr(),
                     counts.data_ptr(),
                     cont.data_ptr() if need_cont else None, 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        report(name, regs, tile, run, ("merge_join_kernel",))
        if edits is CLOCKS:
            clk = (ctypes.c_ulonglong * 8)()
            lib.sa_clk_read(clk)
            run()
            lib.sa_clk_read(clk)
            tiles = max(1, clk[5])
            print("phase clocks, cycles a tile of thread 0: " + "; ".join(
                f"{p} {clk[i] / tiles:.0f}" for i, p in enumerate(PHASES))
                + f" ({clk[5]} tiles)", flush=True)
    if args.k9:
        k9_probe(args.parent_csrc, timer)


if __name__ == "__main__":
    main()
