"""Bytes the window's calls need, at the card's peak bandwidth, over the
kernels' device time in the window, as a percentage.  The bytes come from
the corpus and the queries alone (``_work.call_bytes``), never from the
port's groups, layouts or launches; the peak from ``_peaks.json``.
Nothing to read without a device timeline or without the card's peak."""
import json
import os
import subprocess
import sys


def peak_bytes_per_s(kind):
    with open(os.path.join(os.path.dirname(__file__), "_peaks.json")) as f:
        got = json.load(f).get(kind)
    return None if got is None else float(got["hbm_bytes_per_s"])


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "power limit unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def read(run):
    ks = run.kernel_seconds()
    peak = peak_bytes_per_s(run.device_kind)
    if not ks or peak is None or run.work_bytes is None:
        return None
    print(f"kernels.roofline_pct: peak {peak:.4g} B/s for "
          f"{run.device_kind} ({power_limit()})", file=sys.stderr)
    return 100.0 * run.work_bytes() / peak / ks
