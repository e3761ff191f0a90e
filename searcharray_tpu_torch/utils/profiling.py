"""Observability: device traces and device-memory accounting.

The JAX package's ``utils/profiling.py`` over torch: ``trace`` writes a
Chrome trace of ``torch.profiler`` (CPU activity, and CUDA activity where
a card is present) and ``hbm_report`` keeps the JAX package's keys for
the index's tensors and pools, with the card's own counters from
``torch.cuda`` for an index that lives on one.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome trace (``chrome://tracing``,
    Perfetto) into ``log_dir`` as ``trace-<time>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


def hbm_report(index=None) -> Dict[str, int]:
    """Bytes of the index's device tensors and pools (a ``SearchArray`` or
    a ``DeviceIndex``); for a sharded array (``mesh=``) also
    ``sharded.<name>``, its shards' ``hdrs``, ``pays``, ``doc_lens``,
    ``plane_pool`` and ``tf_pool`` summed over shards and counted in
    ``index.total``; and for an index on a card (or, with no index, any
    card present) the device's own counters: ``device.bytes_in_use``
    (``torch.cuda.memory_allocated``), ``device.peak_bytes_in_use``
    (``max_memory_allocated``) and ``device.bytes_limit`` (the card's
    total memory).  An index on the CPU reports no ``device.*`` key."""
    report: Dict[str, int] = {}
    device = None
    if index is not None:
        sharded = getattr(getattr(index, "_state", None), "sharded", None)
        dev = index.dev if hasattr(index, "dev") else index
        device = dev.device
        for name in ("hdrs", "pays", "doc_lens"):
            t = getattr(dev, name, None)
            if t is not None:
                report[f"index.{name}"] = t.numel() * t.element_size()
        # serving pools: the largest allocations an operator sees (the
        # plane pool's budget alone is gigabytes); residency beside them,
        # read under the maps' lock (a query may be filling them)
        with dev.maps.lock:
            pools = [(dev.plane_pool, len(dev.maps.plane_slot), "plane_pool"),
                     (dev.tf_pool, len(dev.maps.tf_slot), "tf_pool")]
        for pool, used, label in pools:
            if pool is not None:
                report[f"pool.{label}"] = pool.numel() * pool.element_size()
                report[f"pool.{label}.slots_used"] = used
                report[f"pool.{label}.slots_total"] = int(pool.shape[0])
        if sharded is not None:
            for name in ("hdrs", "pays", "doc_lens", "plane_pool",
                         "tf_pool"):
                ts = []
                for d in sharded.device_indexes():
                    with d.maps.lock:
                        t = getattr(d, name)
                    if t is not None:
                        ts.append(t)
                if ts:
                    report[f"sharded.{name}"] = sum(
                        t.numel() * t.element_size() for t in ts)
        report["index.total"] = sum(
            v for k, v in report.items()
            if k.startswith(("index.", "sharded."))
            or (k.startswith("pool.") and not k.endswith(("slots_used",
                                                           "slots_total"))))
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and device.type == "cuda":
        report["device.bytes_in_use"] = int(torch.cuda.memory_allocated(device))
        report["device.peak_bytes_in_use"] = int(
            torch.cuda.max_memory_allocated(device))
        report["device.bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    return report


def format_hbm_report(index=None) -> str:
    rep = hbm_report(index)
    lines = ["HBM report", "----------"]
    for k, v in rep.items():
        lines.append(f"{k:28s} {v / 1e6:10.2f} MB")
    return "\n".join(lines)
