"""The harness on a CUDA card at a tiny size: a run is correct there, its
traced run reads the device, and a broken timed path is caught.  Skipped
without a card (the check is made inside each test)."""
import json

import pytest

from benchmark import run
from benchmark.tests.test_bench_harness import (CELLS, alter_answer,
                                                 drop_half, tiny)  # noqa: F401


def card_or_skip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_card(root, cell, capsys, trace):
    rc = run.main(["--workload", cell, "--seed", "4294967311",
                   "--seconds", "1", "--trace", str(trace)], root=root)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_card_run_is_correct_and_traced(tiny, cell, capsys):
    card_or_skip()
    rc, res = run_card(tiny, cell, capsys, 0)
    assert rc == 0 and res["correct"] and res["device"]["platform"] == "gpu"
    rc, res = run_card(tiny, cell, capsys, 1)
    assert rc == 0 and res["correct"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for name in ("kernels.launches", "device.kernel_ms", "device.idle_pct",
                 "kernels.roofline_pct"):
        assert name in res["metrics"]
    assert 0 < res["metrics"]["kernels.roofline_pct"]["value"] <= 100
    assert len(res["breakdown"]["device_ops"]) <= 10


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [alter_answer, drop_half])
def test_a_broken_timed_path_on_the_card_is_not_correct(tiny, fault, capsys,
                                                        monkeypatch):
    card_or_skip()
    import searcharray_tpu_torch as port

    inner = port.SearchArray.score_batch
    monkeypatch.setattr(port.SearchArray, "score_batch",
                        lambda *a, **kw: fault(*inner(*a, **kw)))
    rc, res = run_card(tiny, "passage-2m.mixed", capsys, 0)
    assert rc == 0 and res["correct"] is False
