"""The solo path's spans (``runtime/trace.py``'s ``Span``): the drive
loop's upload, warm-up, solve and fetch on the ``solve`` track of a
``run --trace`` export, nested by time; their ``heat.<span>>`` /
``heat.<span><`` markers in a recording ``torch.profiler``'s timeline,
around the copies they should enclose; no marker without a profiler, and
markers with the ring off; the sharded backend's blocks with the halo
exchange's four spans once per axis, ``indep`` and ``overlap``."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from heat_tpu_torch import backends, cli
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.runtime import trace

CFG = HeatConfig(n=32, ntime=40, backend="cuda", heartbeat_every=16)
# the markers of one solve of CFG: three chunks of 16, 16 and 8 steps;
# on the CPU both transfers take the pageable path
MARKERS = (["heat.upload>", "heat.upload.pageable>", "heat.upload.pageable<",
            "heat.upload<", "heat.warm>", "heat.warm<",
            "heat.solve>"] + ["heat.chunk>", "heat.chunk<"] * 3
           + ["heat.final-sync>", "heat.final-sync<", "heat.solve<",
              "heat.fetch>", "heat.fetch.pageable>", "heat.fetch.pageable<",
              "heat.fetch<"])


@pytest.fixture
def ring():
    """A fresh process-global ring, the default one again afterwards."""
    yield trace.configure()
    trace.configure()


def _field(n=32):
    return np.random.default_rng(7).random((n, n), dtype=np.float32)


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``: its host events by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with contextlib.redirect_stdout(io.StringIO()):
            fn()
    return sorted(prof.events(), key=lambda e: e.time_range.start)


def _between(events, opening, closing):
    """Names of the events that start inside the first ``opening`` ..
    ``closing`` marker pair."""
    t0 = next(e.time_range.start for e in events if e.name == opening)
    t1 = next(e.time_range.start for e in events if e.name == closing)
    return [e.name for e in events if t0 < e.time_range.start < t1]


def test_run_trace_exports_the_drive_spans_nested_by_time(tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "input.dat").write_text("32 0.2 0.05 2.0 40 0\n")
    out = tmp_path / "run.trace.json"
    try:
        assert cli.main(["run", "--backend", "cuda", "--device", "cpu",
                         "--heartbeat-every", "16", "--trace", str(out)]) == 0
    finally:
        trace.configure()
    evs = [e for e in json.loads(out.read_text())["traceEvents"]
           if e["ph"] == "X"]
    tracks = {(e["pid"], e["tid"]) for e in evs}
    assert len(tracks) == 1
    by = {e["name"]: e for e in evs}
    order = [by[n] for n in ("upload", "compile", "solve", "fetch")]
    for a, b in zip(order, order[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    solve = by["solve"]
    inner = [e for e in evs if e["name"].startswith("chunk @")
             or e["name"] == "final-sync"]
    assert len(inner) == 4
    for e in inner:
        assert solve["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= solve["ts"] + solve["dur"]


def test_profiler_gets_the_markers_around_the_copies(ring):
    events = _profiled(lambda: backends.solve(CFG, T0=_field(),
                                              device="cpu"))
    assert [e.name for e in events if e.name.startswith("heat.")] == MARKERS
    # the field's copy from the host array, and the fetch's copy to it
    assert "aten::copy_" in _between(events, "heat.upload>", "heat.upload<")
    assert "aten::copy_" in _between(events, "heat.fetch>", "heat.fetch<")
    marks = [e for e in events if e.name.startswith("heat.")]
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in marks)


def test_no_marker_without_a_profiler(ring, monkeypatch):
    seen = []
    mark = trace._mark
    monkeypatch.setattr(trace, "_mark", lambda name: (seen.append(name),
                                                      mark(name)))
    with contextlib.redirect_stdout(io.StringIO()):
        backends.solve(CFG, T0=_field(), device="cpu")
    assert seen == []
    # upload and its path, compile, 3 chunks, final-sync, solve, fetch and
    # its path
    assert len(ring) == 10
    _profiled(lambda: backends.solve(CFG, T0=_field(), device="cpu"))
    assert seen == MARKERS


def test_markers_with_the_ring_off():
    tracer = trace.configure(capacity=0)
    try:
        events = _profiled(lambda: backends.solve(CFG, T0=_field(),
                                                  device="cpu"))
        assert [e.name for e in events
                if e.name.startswith("heat.")] == MARKERS
        assert len(tracer) == 0 and tracer.snapshot() == []
    finally:
        trace.configure()


# the overlap's wide form: owned extent 16 below twice the depth 10
@pytest.mark.parametrize("exchange,fuse", [("indep", 0), ("overlap", 0),
                                           ("overlap", 10)],
                         ids=["indep", "overlap", "overlap-wide"])
def test_sharded_blocks_hold_each_halo_span_once_per_axis(ring, exchange,
                                                          fuse):
    cfg = HeatConfig(n=32, ntime=40, backend="sharded", mesh_shape=(2, 2),
                     exchange=exchange, local_kernel="cuda", fuse_steps=fuse)
    with contextlib.redirect_stdout(io.StringIO()):
        res = backends.solve(cfg, T0=_field(), device="cpu",
                             virtual_devices=4)
    evs = ring.snapshot()
    blocks = [e for e in evs if e[3] == "block"]
    # one block a fused step group: the warm-up's and the solve's, each
    # one exchange of both axes
    assert len(blocks) == res.exchange["exchanges"] > 40 // res.exchange["kf"]
    names = ("halo.pack", "halo.post", "halo.finish", "halo.unpack")
    halo = [e for e in evs if e[3] in names]
    assert len(halo) == 4 * 2 * len(blocks)
    for b in blocks:
        inside = [e[3] for e in halo
                  if b[0] <= e[0] and e[0] + e[1] <= b[0] + b[1]]
        assert sorted(inside) == sorted(names * 2)


def test_each_transfer_has_one_path_span_inside_its_own(ring, monkeypatch):
    """A CPU pool of plain host tensors: the first solve of a shape moves
    its fields pageable, the second through the pool; each upload and
    fetch holds exactly one span of the path the pool chose."""
    from heat_tpu_torch.backends import pinned

    pool = pinned.PinnedPool(
        8 << 20, alloc=lambda shape, dtype: torch.empty(shape, dtype=dtype),
        device_type="cpu")
    monkeypatch.setattr(pinned, "POOL", pool)
    cfg = HeatConfig(n=512, ntime=4, backend="cuda")
    for _ in range(2):
        backends.solve(cfg, T0=_field(512), device="cpu")
    evs = [e for e in ring.snapshot() if e[2] == "X"]
    paths = [e for e in evs if e[3] in pinned.PATHS]
    want = []
    for solve, how in enumerate(("pageable", "pinned")):
        for outer in ("upload", "fetch"):
            span = [e for e in evs if e[3] == outer][solve]
            inside = [e[3] for e in paths
                      if span[0] <= e[0] and e[0] + e[1] <= span[0] + span[1]]
            assert inside == [f"{outer}.{how}"]
            want.append(f"{outer}.{how}")
    assert sorted(e[3] for e in paths) == sorted(want)
    assert pool.tally == {
        "upload.pinned": 1, "upload.pageable": 1,
        "fetch.pinned": 1, "fetch.pageable": 1}
