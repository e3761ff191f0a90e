"""``composer.field_batches`` (``metrics/composer.field_batches.py``): the
field batches an ``edismax`` call makes, the ``field_batches`` counts of
the window's ``composer.edismax`` spans over their number, against hand
counts on a planted run; nothing where no call counted them or no span
was recorded; and a tiny CPU run of the edismax cell that records spans
reports 2 (one batch a field, its terms and its grams)."""
import pytest

from benchmark.harness import record
from benchmark.harness.registry import Bench
from benchmark.tests.test_bench_harness import (REPO,  # noqa: F401
                                                 run_tiny, tiny)
from benchmark.tests.test_bench_spans import (PlantedRun, planted,
                                              planted_run, sp,
                                              spans_of)  # noqa: F401
from searcharray_tpu_torch.utils import profiling

NAME = "composer.field_batches"


def read(run):
    return Bench(REPO).reader(NAME).read(run)


def test_reads_the_mean_count_per_edismax_call(spans_of):
    """Calls that start in the window (ns 1000-11000) are read; one that
    started before it, one after it, and other spans' counts are not."""
    spans_of([
        sp("composer.edismax", 500, 1500, 1, field_batches=9),
        sp("composer.edismax", 2000, 4000, 2, field_batches=2),
        sp("facade.score_batch_device", 2100, 2500, 3, 2, field_batches=5),
        sp("composer.edismax", 5000, 12000, 4, field_batches=4),
        sp("composer.edismax", 11000, 12500, 5, field_batches=7),
    ])
    assert read(planted_run()) == pytest.approx(3.0)


@pytest.mark.parametrize("case", ["no_count", "no_composer", "no_span",
                                  "no_recorder"])
def test_reads_nothing_without_a_count(spans_of, monkeypatch, case):
    """A port that does not count its field batches (the planted calls of
    the span readers' tests), a window with no edismax call, a run with
    no spans and a port from before the recorder read nothing."""
    spans_of({
        "no_count": planted(),
        "no_composer": [sp("composer.edismax", 500, 900, 1,
                           field_batches=2),
                        sp("facade.score_batch", 1000, 5000, 2)],
        "no_span": [],
        "no_recorder": planted(),
    }[case])
    if case == "no_recorder":
        monkeypatch.delattr(profiling, "spans")
    assert read(planted_run()) is None


def test_a_tiny_run_that_records_spans_reports_it(tiny, capsys,
                                                  monkeypatch):
    cell = "edismax-2m.single"
    monkeypatch.setattr(record, "Run", PlantedRun)
    profiling.clear()
    with profiling.recording():
        rc, res = run_tiny(tiny, cell, capsys, trace=1)
    assert rc == 0 and res["correct"]
    assert NAME in {m["name"] for m in Bench(tiny).metrics(cell, True)}
    assert res["metrics"][NAME]["value"] == pytest.approx(2.0)


@pytest.mark.parametrize("cell", ["passage-2m.mixed", "passage-2m.terms"])
def test_the_passage_cells_do_not_list_it(cell):
    assert NAME not in {m["name"] for m in Bench(REPO).metrics(cell, True)}
