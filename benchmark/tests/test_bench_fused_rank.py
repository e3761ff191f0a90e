"""``kernels.fused_rank_pct`` (``metrics/kernels.fused_rank_pct.py``): the
share of the rows the window's ranked groups ranked by the fused pass,
against hand counts on a planted run; nothing where no run was recorded
or none counted its rows; and a tiny CPU run of each passage cell that
records spans reports 100 (every group there ranks its top 10 whole)."""
import pytest

from benchmark.harness import record
from benchmark.harness.registry import Bench
from benchmark.tests.test_bench_harness import (REPO,  # noqa: F401
                                                 run_tiny, tiny)
from benchmark.tests.test_bench_spans import (PlantedRun, planted_run, sp,
                                              spans_of)  # noqa: F401
from searcharray_tpu_torch.utils import profiling

NAME = "kernels.fused_rank_pct"


def read(run):
    return Bench(REPO).reader(NAME).read(run)


def counted():
    """Runs inside the window (ns 1000-11000) with known counts, one that
    starts before it and one after it (neither read), and a plan (not
    read)."""
    return [
        sp("batch.enqueue", 900, 1500, 1, ranked_rows=50,
           ranked_unfused_rows=50),
        sp("batch.enqueue", 1100, 2100, 2, ranked_rows=63,
           ranked_unfused_rows=3),
        sp("batch.plan", 4000, 5000, 3, ranked_rows=7,
           ranked_unfused_rows=7),
        sp("batch.enqueue", 5300, 5800, 4, ranked_rows=120),
        sp("batch.enqueue", 8100, 8300, 5, ranked_rows=4,
           ranked_unfused_rows=4),
        sp("batch.enqueue", 12000, 12500, 6, ranked_rows=9,
           ranked_unfused_rows=9),
    ]


def test_reads_the_share_of_a_planted_run(spans_of):
    spans_of(counted())
    assert read(planted_run()) == pytest.approx(
        100 * (1 - (3 + 0 + 4) / (63 + 120 + 4)))
    spans_of([sp("batch.enqueue", 2000, 3000, 1, ranked_rows=120)])
    assert read(planted_run()) == pytest.approx(100.0)
    spans_of([sp("batch.enqueue", 2000, 3000, 1, ranked_rows=7,
                 ranked_unfused_rows=7)])
    assert read(planted_run()) == pytest.approx(0.0)


def test_reads_nothing_without_a_ranked_row(spans_of, monkeypatch):
    run = planted_run()
    spans_of([])
    assert read(run) is None
    # runs that count no rows (a port without the counts, or full scores
    # only), and runs outside the window
    spans_of([sp("batch.enqueue", 2000, 3000, 1),
              sp("batch.enqueue", 12000, 13000, 2, ranked_rows=5,
                 ranked_unfused_rows=1)])
    assert read(run) is None
    # a port from before the recorder
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None


@pytest.mark.parametrize("cell", ["passage-2m.mixed", "passage-2m.terms"])
def test_a_tiny_run_that_records_spans_reports_it(tiny, cell, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(record, "Run", PlantedRun)
    profiling.clear()
    with profiling.recording():
        rc, res = run_tiny(tiny, cell, capsys, trace=1)
    assert rc == 0 and res["correct"]
    assert NAME in {m["name"] for m in Bench(tiny).metrics(cell, True)}
    assert res["metrics"][NAME]["value"] == pytest.approx(100.0)


def test_the_edismax_cell_does_not_list_it():
    assert NAME not in {m["name"] for m in
                        Bench(REPO).metrics("edismax-2m.single", True)}
