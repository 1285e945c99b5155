"""On the card, at the 1-card cell's own size: the program comes out
correct and its bf16 path, the control, does not; the traced run reads
every per-layer metric of the cell."""

import time

import pytest

from cellbench.harness import cellrun, spec

pytestmark = pytest.mark.cuda


def _run(card, dtype=None, trace=False, seed=2 ** 31 + 101):
    cell = spec.resolve("pycuda_4096.solves")
    ctx = cellrun.Ctx(cell=cell, seed=seed, seconds=2.0, trace=trace,
                      device=card, dtype=dtype)
    return cellrun.run(ctx, time.perf_counter())


def test_program_correct_control_not(card):
    assert _run(card)["correct"] is True
    assert _run(card, dtype="bfloat16")["correct"] is False


def test_traced_run_reads_every_metric(card):
    res = _run(card, trace=True)
    cell = spec.resolve("pycuda_4096.solves")
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert 0 < res["metrics"]["ftcs2d_roofline"]["value"] <= 100
