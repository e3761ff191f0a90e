"""Where a block of K7 (csrc/merge_step.cu) spends its time.

    python3 scripts/k7_probe.py        (on a machine with one CUDA device)

Builds the committed kernel and copies of it with one part taken out (the
warp search replaced by ranges computed beforehand, the partners' payload
reads, the output writes; these copies compute wrong results and are only
timed) or one constant changed, and times each by its device time
(``chip_smoke.DeviceTimer``) on one synthetic step of the size of the
largest windowed step of ``chip_smoke.py``: 2,095,523 base words against
2,931,452, uniform over 8M slots, window block 0.  Prints microseconds per
launch (two turns; with the continuation written; with L2 flushed before
each launch) beside the card's name and power limit."""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from searcharray_tpu_torch.ops.cuda import score as kc  # noqa: E402

OUT = os.path.join(kc.BUILD_DIR, "k7_probe")
SLOTS = 8_000_000
B, A = 2_095_523, 2_931_452

# the block reads its range from behind the tile table instead of searching
NOSEARCH = (
    r"sa::block_range\(oh, meta\[OTHER_N \* ld \+ q\], 0,.*?range\);",
    "if (threadIdx.x == 0) { range[0] = meta[MS_ROWS * ld + gridDim.x + "
    "blockIdx.x]; range[1] = meta[MS_ROWS * ld + 2 * gridDim.x + "
    "blockIdx.x]; }")
NOGATHER = [(r"win\(h, op\[lo\]\)", "h"),
            (r"win\(h - 1, op\[lo - 1\]\)", "h")]
NOWRITE = [(r"keys_out\[out_off \+ i\] = .*?;\n",
            "if (count == 12345) keys_out[out_off + i] = 1;\n"),
           (r"counts_out\[out_off \+ i\] = .*?;\n", ""),
           (r"if \(cont_out != nullptr\) cont_out\[out_off \+ i\] = cont;",
            "")]
VARIANTS = [
    ("as committed", []),
    ("ranges given, no search", [NOSEARCH]),
    ("no partner payload reads", NOGATHER),
    ("ranges given, no partner payload reads", [NOSEARCH] + NOGATHER),
    ("no output writes", NOWRITE),
    ("6 blocks an SM", [(r"MS_BLOCKS = 8", "MS_BLOCKS = 6")]),
    ("512-word tiles", [(r"MS_ITEMS = 4", "MS_ITEMS = 2")]),
    ("2048-word tiles", [(r"MS_ITEMS = 4", "MS_ITEMS = 8"),
                         (r"MS_BLOCKS = 8", "MS_BLOCKS = 6")]),
]


def build(name, edits):
    """The kernel with ``edits`` (regex, replacement) applied, as a
    library of its own: (ctypes library, registers per thread)."""
    d = os.path.join(OUT, re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(kc.CSRC_DIR, "merge_step.cu")) as f:
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
        [kc._nvcc(), *kc.NVCC_FLAGS, "-I", kc.CSRC_DIR, "-Xptxas", "-v",
         "-shared", "-o", so, os.path.join(d, "merge_step.cu")],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    lib.sa_merge_step.argtypes = kc._ENTRIES["sa_merge_step"]
    lib.sa_merge_step.restype = ctypes.c_int
    return lib, re.findall(r"Used (\d+) registers", res.stderr)


def main():
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
    # one query: base [0, B), other [B, B + A)
    table = np.asarray([0, B, B, A, B, 0, 0, 0], np.int64)

    def meta_for(tile):
        """The query table, each tile's query, and each tile's range of
        the other list as the kernel's search would find it."""
        n_tiles = -(-B // tile)
        first = bh[::tile].long()
        last = torch.cat([bh[tile - 1::tile], bh[-1:]])[:n_tiles].long()
        return n_tiles, torch.cat([
            torch.as_tensor(table, device=dev),
            torch.zeros(n_tiles, dtype=torch.int64, device=dev),
            torch.searchsorted(oh.long(), first - 1),
            torch.searchsorted(oh.long(), last + 2)]).contiguous()

    timer = chip_smoke.DeviceTimer(dev)
    for name, edits in VARIANTS:
        lib, regs = build(name, edits)
        tile = lib.sa_merge_step_tile()
        n_tiles, meta = meta_for(tile)

        def run(need_cont=False):
            err = lib.sa_merge_step(
                hdrs.data_ptr(), pays.data_ptr(), pays.data_ptr(),
                meta.data_ptr(), 1, n_tiles, 3, 0, 0, 1, 0, keys.data_ptr(),
                counts.data_ptr(), cont.data_ptr() if need_cont else None,
                0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        kernel = ("merge_step_kernel",)
        us = [timer(run, 20, kernel)[0] * 1e3 for _ in range(2)]
        us_cont = timer(lambda: run(True), 20, kernel)[0] * 1e3
        us_flush = timer(run, 20, kernel, flush=True)[0] * 1e3
        print(f"{name}: registers {regs}, tile {tile}: {us[0]:.1f} "
              f"{us[1]:.1f} us; with cont {us_cont:.1f}; flushed "
              f"{us_flush:.1f} [{chip_smoke.card_line()}]", flush=True)


if __name__ == "__main__":
    main()
