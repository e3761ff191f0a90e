"""Finds everything a run needs by name, so that a cell, a configuration, a
traffic mix or a metric is added as files and entries alone.

Under a checkout's root: ``BENCHMARK.json`` (the cells and metrics), and
in ``benchmark/``: ``workloads/<cell>.json`` (the cell's run parameters
and the limits of its comparison), ``configs/<config>.json`` (the file
``BENCHMARK.json`` names for the configuration), ``traffic/<mix>.json``,
``systems/<system>.py`` (a configuration's ``system``: how the system
under test is built and called, and its plain reference) and
``metrics/<metric>.py`` (one reader per metric, ``read(run) -> number or
None``).
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import List


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        self.spec = _read(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        """The ``workloads`` entry of ``name`` with its file's run
        parameters and limits."""
        entry = next((w for w in self.spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        params = _read(os.path.join(self.dir, "workloads", f"{name}.json"))
        return {**params, **entry}

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return _read(os.path.join(self.root, entry["file"]))

    def traffic(self, name: str) -> dict:
        return _read(os.path.join(self.dir, "traffic", f"{name}.json"))

    def system(self, name: str):
        return load_module(os.path.join(self.dir, "systems", f"{name}.py"),
                           f"benchmark_system_{name.replace('-', '_')}")

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones, or
        with ``traced`` the per-layer ones, where their ``workloads`` (if
        given) list the cell."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        safe = "".join(c if c.isalnum() else "_" for c in metric)
        return load_module(os.path.join(self.dir, "metrics", f"{metric}.py"),
                           f"benchmark_metric_{safe}")
