"""The 3D cell, ``cube512_3d.solves``: its files found by name, its
readers on synthetic stretches (``ftcs3d_roofline``, and the transfer
paths' ``pageable_share`` and ``transfer_ms``, which the 4096² cell reads
too), each None where it has nothing to read, and the cell driven at 24³
on the CPU (the kernels' plain versions): correct, and its control, the
program's bf16 path, not."""

import time

import pytest
import torch

from cellbench.harness import cellrun, spec

CELL = "cube512_3d.solves"
PEAK = {"f32_flop_per_s": 67e12, "hbm_byte_per_s": 3.35e12}
NAMES = ("ftcs3d_roofline", "pageable_share", "transfer_ms")


@pytest.fixture(scope="module")
def read():
    return spec.readers(spec.resolve(CELL), [{"name": n} for n in NAMES])


def test_the_cell_resolves_to_its_files():
    cell = spec.resolve(CELL)
    assert cell.chips == 1 and cell.mix["loop"] == "solves"
    assert cell.config["n"] == 512 and cell.config["ndim"] == 3
    assert cell.config["ntime"] == 3200 and cell.config["bc"] == "edges"
    assert list(cell.config["reduced"]) == ["ic"]
    assert {m["name"] for m in cell.end_to_end} == {"points_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(NAMES)
    assert set(cell.limits["compared"]) == {"final_field_max_abs"}
    assert spec.reference(cell).__name__ == "cellbench_reference_ftcs3d"
    # the 4096² cell reads the transfer paths' share too
    names = {m["name"] for m in spec.resolve("pycuda_4096.solves").per_layer}
    assert "pageable_share" in names and "ftcs3d_roofline" not in names


def _marks(name, s, f):
    return [(f"heat.{name}>", s, s), (f"heat.{name}<", f, f)]


def _run(host=(), device=(), units=2, n=512, steps=3200, peak=PEAK):
    points = n ** 3
    stretch = {"seconds": 2.0, "device": list(device), "host": list(host),
               "units": units, "point_steps": units * points * steps,
               "unit_points": points, "counters": {}}
    return cellrun.Run(units=[], seconds=2.0, counters={},
                       ranks=[{"counters": {}, "stretch": stretch}],
                       config={"dtype": "float32"}, mix={}, card="cpu",
                       peak=peak)


def _solve(t, up="pinned", down="pinned"):
    """One solve's transfer spans from ``t`` s: 60 ms up, 20 ms down."""
    return (_marks("upload", t, t + .070) + _marks(f"upload.{up}", t + .005,
                                                   t + .065)
            + _marks("fetch", t + .800, t + .825)
            + _marks(f"fetch.{down}", t + .802, t + .822))


def test_ftcs3d_roofline(read):
    # two solves of 512³ x 3200: 9 operations a cell-step over 67e12 is
    # 57.7 ms a solve (the bytes take 0.32 ms); 0.77 s of kernel a solve
    kernels = [("void ftcs3d_stream_kernel<float, 8>", 0.0, 0.77),
               ("void ftcs3d_stream_kernel<float, 8>", 1.0, 1.77),
               ("Memcpy HtoD (Pinned -> Device)", 0.9, 0.95),
               ("ftcs2d_stream_kernel", 1.8, 1.9)]
    want = 100 * 9 * 512 ** 3 * 3200 / 67e12 / 0.77
    assert read["ftcs3d_roofline"](_run(device=kernels)) == pytest.approx(want)
    # a small field is bound by its bytes: read once, written once a solve
    small = _run(device=kernels, n=8, steps=1)
    assert read["ftcs3d_roofline"](small) == pytest.approx(
        100 * 2 * 2 * 4 * 8 ** 3 / 3.35e12 / 1.54)


@pytest.mark.parametrize("run", [
    _run(device=[("ftcs2d_stream_kernel", 0.0, 0.5)]),
    _run(device=[("void ftcs3d_stream_kernel<float, 8>", 0.0, 0.5)],
         peak=None),
    _run(device=[("Memcpy DtoH (Device -> Pinned)", 0.0, 0.5)])],
    ids=["other-kernel", "unknown-card", "copies-only"])
def test_ftcs3d_roofline_reads_nothing_without_its_kernel(read, run):
    assert read["ftcs3d_roofline"](run) is None


def test_transfer_paths(read):
    run = _run(_solve(0.0, "pageable", "pageable") + _solve(1.0)
               + _solve(2.0, "pinned", "pageable") + _solve(3.0), units=4)
    assert read["pageable_share"](run) == pytest.approx(3 / 8)
    assert read["transfer_ms"](run) == pytest.approx(80.0)
    pinned = _run(_solve(0.0) + _solve(1.0))
    assert read["pageable_share"](pinned) == 0.0
    assert read["transfer_ms"](pinned) == pytest.approx(80.0)


@pytest.mark.parametrize("host", [
    [],
    # the parent's program: its upload and fetch spans, no path spans
    _marks("upload", 0.0, 0.07) + _marks("fetch", 0.8, 0.825),
    [("heat.upload.pinned>", 0.1, 0.1), ("heat.fetch.pageable>", 0.2, 0.2)],
    [("heat.upload.pinned<", 0.1, 0.1), ("heat.fetch.pageable<", 0.2, 0.2)],
], ids=["empty", "no-path-spans", "only-opened", "only-closed"])
@pytest.mark.parametrize("name", ("pageable_share", "transfer_ms"))
def test_transfer_paths_read_nothing_without_a_pair(read, name, host):
    assert read[name](_run(host)) is None


@pytest.mark.parametrize("name", NAMES)
def test_no_reading_without_a_stretch(read, name):
    run = _run(_solve(0.0), [("void ftcs3d_stream_kernel<float, 8>", 0, 1)])
    run.ranks[0]["stretch"] = None
    assert read[name](run) is None


def _rehearse(dtype=None, seed=2 ** 31 + 25):
    cell = spec.resolve(CELL, overrides={"config": {"n": 24, "ntime": 43}})
    ctx = cellrun.Ctx(cell=cell, seed=seed, seconds=0.5, trace=False,
                      device=torch.device("cpu"), dtype=dtype)
    return cellrun.run(ctx, time.perf_counter())


def test_the_cell_at_24_cubed_is_correct_and_its_control_not():
    res = _rehearse()
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 3
    control = _rehearse(dtype="bfloat16")
    assert control["correct"] is False, control["compared"]
    assert control["compared"]["final_field_max_abs"]["value"] > 1e-3
