"""``driver.plan_array_pct`` (``metrics/driver.plan_array_pct.py``): the
share of the distinct queries the window's plans classified that the
batch driver's array pass took, against hand counts on a planted run;
nothing where no plan was recorded or none counted its rows; and a tiny
CPU run of each cell that records spans reports it."""
import pytest

from benchmark.harness import record
from benchmark.harness.registry import Bench
from benchmark.tests.test_bench_harness import (CELLS, REPO,  # noqa: F401
                                                 run_tiny, tiny)
from benchmark.tests.test_bench_spans import (PlantedRun, planted_run, sp,
                                              spans_of)  # noqa: F401
from searcharray_tpu_torch.utils import profiling

NAME = "driver.plan_array_pct"


def read(run):
    return Bench(REPO).reader(NAME).read(run)


def counted():
    """Plans inside the window (ns 1000-11000) with known counts, one
    that starts before it and one after it (neither read)."""
    return [
        sp("batch.plan", 900, 1500, 1, plan_rows=50, plan_loop_rows=50),
        sp("batch.plan", 1100, 2100, 2, plan_rows=63, plan_loop_rows=30,
           tf_rows=10, tf_fills=2),
        sp("batch.plan", 5300, 5800, 3, plan_rows=120, plan_loop_rows=0),
        sp("batch.plan", 8100, 8300, 4, plan_rows=4, plan_loop_rows=3),
        sp("batch.plan", 12000, 12500, 5, plan_rows=9, plan_loop_rows=9),
    ]


def test_reads_the_share_of_a_planted_run(spans_of):
    spans_of(counted())
    assert read(planted_run()) == pytest.approx(
        100 * (1 - (30 + 0 + 3) / (63 + 120 + 4)))
    # every query a single term: 100; none: 0
    spans_of([sp("batch.plan", 2000, 3000, 1, plan_rows=120,
                 plan_loop_rows=0)])
    assert read(planted_run()) == pytest.approx(100.0)
    spans_of([sp("batch.plan", 2000, 3000, 1, plan_rows=7,
                 plan_loop_rows=7)])
    assert read(planted_run()) == pytest.approx(0.0)


def test_reads_nothing_without_a_counted_plan(spans_of, monkeypatch):
    run = planted_run()
    spans_of([])
    assert read(run) is None
    # plans that count no rows (a port without the counts), or classify
    # none, and plans outside the window
    spans_of([sp("batch.plan", 2000, 3000, 1, tf_rows=4, tf_fills=1),
              sp("batch.plan", 3000, 4000, 2, plan_rows=0,
                 plan_loop_rows=0),
              sp("batch.plan", 12000, 13000, 3, plan_rows=5,
                 plan_loop_rows=1)])
    assert read(run) is None
    # a port from before the recorder
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_that_records_spans_reports_it(tiny, cell, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(record, "Run", PlantedRun)
    profiling.clear()
    with profiling.recording():
        rc, res = run_tiny(tiny, cell, capsys, trace=1)
    assert rc == 0 and res["correct"]
    assert NAME in {m["name"] for m in Bench(tiny).metrics(cell, True)}
    got = res["metrics"][NAME]["value"]
    if cell == "passage-2m.terms":
        assert got == pytest.approx(100.0)
    else:
        assert 0.0 < got < 100.0
