"""The readers of the program's spans on synthetic stretches: each reads
what its span holds, none reads an unpaired or missing marker, and
``program_idle_ms`` leaves out the idle between the program's spans."""

import pytest

from cellbench.harness import cellrun, spec

NAMES = ("upload_ms", "warm_ms", "fetch_ms", "program_idle_ms",
         "block_host_ms", "exchange_host_ms")


@pytest.fixture(scope="module")
def read():
    cell = spec.resolve("pycuda_4096.solves")
    return spec.readers(cell, [{"name": n} for n in NAMES])


def _marks(name, s, f):
    return [(f"heat.{name}>", s, s), (f"heat.{name}<", f, f)]


def _run(host, device=(), seconds=1.0, units=2):
    stretch = {"seconds": seconds, "device": list(device), "host": list(host),
               "units": units, "point_steps": 0, "unit_points": 0,
               "counters": {}}
    return cellrun.Run(units=[], seconds=seconds, counters={},
                       ranks=[{"counters": {}, "stretch": stretch}],
                       config={}, mix={}, card="cpu", peak=None)


def _solve(t):
    """One solve's spans from ``t`` s, with its copies and its kernel: 10 ms
    upload, 2 ms warm-up, 88 ms solve, 30 ms fetch."""
    host = (_marks("upload", t, t + .010) + _marks("warm", t + .010, t + .012)
            + _marks("solve", t + .012, t + .100)
            + _marks("fetch", t + .100, t + .130)
            + [("aten::copy_", t + .001, t + .009)])
    device = [("Memcpy HtoD (Pageable -> Device)", t + .001, t + .009),
              ("ftcs2d_stream_kernel", t + .013, t + .099),
              ("Memcpy DtoH (Device -> Pageable)", t + .101, t + .129)]
    return host, device


def _two_solves():
    (h0, d0), (h1, d1) = _solve(0.0), _solve(0.5)
    return _run(h0 + h1, d0 + d1)


def test_drive_loop_readers(read):
    run = _two_solves()
    assert read["upload_ms"](run) == pytest.approx(10.0)
    assert read["warm_ms"](run) == pytest.approx(2.0)
    assert read["fetch_ms"](run) == pytest.approx(30.0)
    # a solve's idle inside its spans: 13 ms before the kernel (the upload
    # and its copy count as idle) and 31 ms after it; the 370 ms between
    # the solves is the caller's
    assert read["program_idle_ms"](run) == pytest.approx(44.0)


def test_program_idle_leaves_out_the_callers_idle(read):
    host, _ = _solve(0.2)
    # no kernel at all: every second of the stretch is idle, and only the
    # 130 ms of the program's spans count, over one unit
    assert read["program_idle_ms"](_run(host, units=1)) == pytest.approx(130.0)
    # a span's stray end marker before the stretch adds nothing
    stray = [("heat.fetch<", 0.05, 0.05)]
    assert read["program_idle_ms"](_run(stray + host, units=1)) == \
        pytest.approx(130.0)


def _blocks():
    host = []
    for b0, b1, halo in ((0.000, 0.002, .0008), (0.003, 0.006, .0010),
                         (0.007, 0.008, .0004)):
        host += _marks("block", b0, b1)
        # four spans of a quarter each, then the next block's dispatch
        q = halo / 4
        for j, name in enumerate(("pack", "post", "finish", "unpack")):
            host += _marks(f"halo.{name}", b0 + j * q, b0 + (j + 1) * q)
    return _run(host)


def test_block_readers(read):
    run = _blocks()
    assert read["block_host_ms"](run) == pytest.approx(2.0)
    assert read["exchange_host_ms"](run) == pytest.approx(0.8)


@pytest.mark.parametrize("host", [
    [],
    [("aten::copy_", 0.1, 0.2)],
    [("heat.upload>", 0.1, 0.1), ("heat.warm>", 0.2, 0.2),
     ("heat.solve>", 0.3, 0.3), ("heat.fetch>", 0.4, 0.4),
     ("heat.block>", 0.5, 0.5), ("heat.halo.pack>", 0.5, 0.5)],
    [("heat.upload<", 0.1, 0.1), ("heat.warm<", 0.2, 0.2),
     ("heat.solve<", 0.3, 0.3), ("heat.fetch<", 0.4, 0.4),
     ("heat.block<", 0.5, 0.5), ("heat.halo.pack<", 0.5, 0.5)],
], ids=["empty", "no-markers", "only-opened", "only-closed"])
@pytest.mark.parametrize("name", NAMES)
def test_no_reading_without_a_pair(read, name, host):
    assert read[name](_run(host, [("ftcs2d", 0.0, 0.9)])) is None


@pytest.mark.parametrize("name", NAMES)
def test_no_reading_without_a_stretch(read, name):
    run = _two_solves()
    run.ranks[0]["stretch"] = None
    assert read[name](run) is None
