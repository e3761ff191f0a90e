"""The readers of the program's spans (``metrics/_spans.py`` and the
metrics that load it) against hand counts on a planted run: durations,
self times, clipping to the window, pool hit shares and the device's idle
time under the batch driver; a tiny CPU run of the harness that records
spans yields every one of them; and they read nothing where the program
recorded nothing."""
import random
from dataclasses import dataclass

import pytest

from benchmark.harness import record
from benchmark.harness.record import CallRecord, Run, Setup
from benchmark.harness.registry import Bench
from benchmark.harness.trace import DeviceOp, Timeline
from benchmark.tests.test_bench_harness import (CELLS, REPO,  # noqa: F401
                                                 run_tiny, tiny)
from searcharray_tpu_torch.utils import profiling

NEW = ["facade.host_ms", "driver.plan_ms", "driver.enqueue_ms",
       "driver.wait_ms", "composer.self_ms", "pool.plane_hit_pct",
       "pool.tf_hit_pct", "device.idle_driver_pct", "driver.lock_wait_ms",
       "driver.order_ms", "composer.phases_ms"]
LO, HI = 1000, 11000
N_CALLS = 2


def reader(name):
    return Bench(REPO).reader(name)


def sp(name, start, end, sid, parent=0, **counts):
    """A finished span as the recorder keeps one."""
    s = object.__new__(profiling.Span)
    s.name, s.start_ns, s.end_ns, s.id, s.parent = (name, start, end, sid,
                                                     parent)
    s.counts = counts
    return s


def planted():
    """Two calls' spans (ns): a passage call that starts before the
    window, an edismax call that ends after it, and one plan outside."""
    return [
        sp("facade.score_batch", 900, 5000, 1),
        sp("batch.lock_wait", 1000, 1050, 2, 1),
        sp("batch.order", 1050, 1100, 19, 1),
        sp("batch.plan", 1100, 2100, 3, 1, plane_rows=4, plane_fills=1,
           tf_rows=10, tf_fills=2),
        sp("batch.enqueue", 2100, 4000, 4, 1),
        sp("batch.wait", 3000, 3200, 5, 4),      # a wait inside the enqueue
        sp("batch.order", 4000, 4050, 20, 1),
        sp("batch.assemble", 4050, 4900, 6, 1),
        sp("batch.wait", 4200, 4800, 7, 6),
        sp("composer.edismax", 5000, 11500, 8),
        sp("facade.score_batch_device", 5200, 7800, 10, 8),
        sp("batch.plan", 5300, 5800, 11, 10, plane_rows=0, plane_fills=0,
           tf_rows=6, tf_fills=3),
        sp("batch.enqueue", 5800, 7000, 12, 10),
        sp("batch.assemble", 7000, 7500, 13, 10),
        sp("composer.phases", 8000, 9000, 14, 8),
        sp("facade.score_batch_device", 8100, 8900, 15, 14),
        sp("batch.plan", 8100, 8300, 16, 15, plane_rows=2, plane_fills=2),
        sp("batch.wait", 10000, 11500, 17, 8),
        sp("batch.plan", 12000, 12500, 18, plane_rows=100,
           plane_fills=100, tf_rows=100, tf_fills=100),
    ]


def planted_run(ops=()):
    calls = [CallRecord(0, 0, LO, 5000, 144), CallRecord(0, 1, 5000, HI, 1)]
    timeline = Timeline(list(ops), (LO, HI)) if ops else None
    return Run(setup_s=1.0, setup=Setup(), calls=calls, window=(LO, HI),
               hold_s=0.0, peak_bytes=0, device_kind="cpu",
               timeline=timeline)


OPS = [DeviceOp("k", 1500, 2500, True), DeviceOp("k", 6000, 6500, True),
       DeviceOp("Memcpy", 9500, 10500, False)]


@pytest.fixture
def spans_of(monkeypatch):
    def plant(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return plant


def ms(ns):
    return ns / N_CALLS / 1e6


def test_each_reader_equals_a_hand_count(spans_of):
    spans_of(planted())
    run = planted_run(OPS)
    want = {
        # clipped facade [1000, 5000] less its six children; the field
        # batches less their plans, enqueues and assemblies
        "facade.host_ms": ms((4000 - 50 - 50 - 1000 - 1900 - 50 - 850)
                             + (2600 - 500 - 1200 - 500) + (800 - 200)),
        "driver.plan_ms": ms(1000 + 500 + 200),
        "driver.enqueue_ms": ms(1900 + 1200),
        "driver.wait_ms": ms(200 + 600 + 1000),
        "driver.lock_wait_ms": ms(50),
        "driver.order_ms": ms(50 + 50),
        # clipped composer [5000, 11000] less its field batch, its phases
        # and its wait; the phases less their field batch
        "composer.self_ms": ms((6000 - 2600 - 1000 - 1000) + (1000 - 800)),
        "composer.phases_ms": ms(1000),
        "pool.plane_hit_pct": 100 * (1 - 3 / 6),
        "pool.tf_hit_pct": 100 * (1 - 5 / 16),
        # idle [1000,1500] [2500,6000] [6500,9500] [10500,11000] against
        # the driver innermost: order [1050,1100], plan [1100,2100],
        # enqueue [2100,3000] and [3200,4000], order [4000,4050], plan
        # [5300,5800], enqueue [5800,7000], plan [8100,8300]
        "device.idle_driver_pct": 100 * (50 + 400 + 500 + 800 + 50 + 500
                                         + 200 + 500 + 200) / 10000,
    }
    for name, value in want.items():
        assert reader(name).read(run) == pytest.approx(value), name
    idle = reader("device.idle_pct").read(run)
    assert idle == pytest.approx(75.0)
    assert want["device.idle_driver_pct"] <= idle


def test_the_readers_read_nothing_without_spans(spans_of, monkeypatch):
    run = planted_run(OPS)
    spans_of([])
    assert all(reader(n).read(run) is None for n in NEW)
    # a port from before the recorder
    monkeypatch.delattr(profiling, "spans")
    assert all(reader(n).read(run) is None for n in NEW)
    # spans, but no device timeline and no composer: only those read none
    monkeypatch.setattr(profiling, "spans",
                        lambda: [s for s in planted() if s.end_ns <= 5000],
                        raising=False)
    run = planted_run()
    got = {n: reader(n).read(run) for n in NEW}
    assert {n for n, v in got.items() if v is None} == {
        "composer.self_ms", "composer.phases_ms", "device.idle_driver_pct"}


def test_idle_under_the_driver_never_passes_the_idle_share(spans_of):
    rng = random.Random(7)
    for _ in range(200):
        spans, sid, t = [], 0, LO - 500
        while t < HI:
            sid += 1
            root, end = sid, t + rng.randint(200, 2000)
            spans.append(sp("facade.score_batch", t, end, root))
            at = t
            for name in ("batch.plan", "batch.enqueue", "batch.assemble"):
                sid += 1
                nxt = min(end, at + rng.randint(0, 600))
                spans.append(sp(name, at, nxt, sid, root))
                at = nxt
            t = end + rng.randint(0, 300)
        ops, t = [], LO - 300
        while t < HI + 300:
            d = rng.randint(10, 900)
            ops.append(DeviceOp("k", t, t + d, True))
            t += d + rng.randint(0, 900)
        spans_of(spans)
        run = planted_run(ops)
        driver = reader("device.idle_driver_pct").read(run)
        idle = reader("device.idle_pct").read(run)
        assert 0.0 <= driver <= idle + 1e-9


@dataclass
class PlantedRun(Run):
    """A CPU run with a device timeline planted: the device busy through
    the window's first half."""

    def __post_init__(self):
        if self.timeline is None:
            lo, hi = self.window
            self.timeline = Timeline(
                [DeviceOp("k", lo, (lo + hi) // 2, True)], self.window)


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_that_records_spans_yields_every_new_metric(
        tiny, cell, capsys, monkeypatch):
    monkeypatch.setattr(record, "Run", PlantedRun)
    profiling.clear()
    with profiling.recording():
        rc, res = run_tiny(tiny, cell, capsys, trace=1)
    assert rc == 0 and res["correct"]
    listed = {m["name"] for m in Bench(tiny).metrics(cell, True)}
    want = listed & set(NEW)
    assert want >= {"facade.host_ms", "driver.plan_ms", "driver.enqueue_ms",
                    "driver.wait_ms", "pool.tf_hit_pct",
                    "device.idle_driver_pct", "driver.lock_wait_ms",
                    "driver.order_ms"}
    # an index off the card orders no streams
    want.discard("driver.order_ms")
    assert "driver.order_ms" not in res["metrics"]
    if not cell.startswith("edismax"):
        # on the CPU a passage call copies no result from a device, so
        # it never waits (the composer's final copy is a wait span)
        want.discard("driver.wait_ms")
        assert "driver.wait_ms" not in res["metrics"]
    assert want <= set(res["metrics"]), sorted(want - set(res["metrics"]))
    got = {n: res["metrics"][n]["value"] for n in want}
    assert got["device.idle_driver_pct"] <= \
        res["metrics"]["device.idle_pct"]["value"]
    for name in ("pool.tf_hit_pct", "pool.plane_hit_pct"):
        if name in got:
            assert 0.0 <= got[name] <= 100.0
    assert all(got[n] > 0 for n in ("driver.plan_ms", "driver.enqueue_ms"))
    if cell.startswith("edismax"):
        assert got["composer.self_ms"] <= \
            res["metrics"]["composer.host_ms"]["value"]
        assert got["composer.phases_ms"] > 0
