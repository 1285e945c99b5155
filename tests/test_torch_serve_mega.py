"""Mega-lanes of the port's serving engine against heat_tpu's.

A request whose side overflows every bucket runs as a mega-lane: one
request over every shard of the device mesh, through the sharded
padded-carry advance, co-scheduled with the packed lanes. heat_tpu's mesh
is the 8 virtual CPU devices of ``conftest.py`` (auto 4x2 in 2D); the
port's is 8 shards in this process (``mega_device_count`` patched to 8, a
4x2 ``LocalComm`` on the CPU). The same requests go through both engines
at the same knobs, and are held to:

- the reference's mega-lane field, bytes, in f64 (the ``torch`` shard step
  against ``xla``) and in f32 and bf16 (``cuda``, the kernels' plain
  bounded versions, against ``pallas`` in interpret mode) at r 0.2 and
  dispatch depths 0 and 2; bf16 also at a fuse depth whose blocks cut
  each chunk where the solo drive does not;
- every boundary vector: the remaining count and the finite bit exactly,
  the resid / min / max stats bit for bit, ``heat`` (a float32 sum in
  another order) within a relative 1e-6;
- the reference's rejection reasons and hints, character for character;
- the reference's npz bytes after an engine checkpoint of a mega occupant
  written by either package and resumed by the other.

The rest (faults, deadlines, the watchdog, the observatories, the gateway,
the solve cache, ``until=steady``, the CLI) follows the reference's own
``tests/test_serve_mega.py`` on the port.
"""

import contextlib
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.config import parse_mega_lanes as jparse_mega_lanes
from heat_tpu.runtime import faults as jfaults
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu.serve import resume as jresume
from heat_tpu.serve import scheduler as jsch
from heat_tpu_torch import cli
from heat_tpu_torch.backends import solve
from heat_tpu_torch.config import HeatConfig, parse_mega_lanes
from heat_tpu_torch.grid import initial_condition
from heat_tpu_torch.runtime import checkpoint as ckpt
from heat_tpu_torch.runtime import faults
from heat_tpu_torch.serve import Engine, ServeConfig
from heat_tpu_torch.serve import resume
from heat_tpu_torch.serve import scheduler as sch
from heat_tpu_torch.serve.gateway import (Gateway, render_metrics,
                                          render_statusz, usage_payload)

torch.set_num_threads(1)
TIMEOUT = 60
KNOBS = dict(emit_records=False, lanes=2, chunk=8, buckets=(8,))
# n=16 overflows the (8,) bucket table and divides the 4x2 mesh
MEGA = dict(n=16, ntime=37, bc="edges", sigma=0.2)
SMALL = dict(n=8, ntime=20, dtype="float32")
_REF_KERNEL = {"auto": "auto", "torch": "xla", "cuda": "pallas"}


@pytest.fixture(autouse=True)
def _eight_shards(monkeypatch):
    monkeypatch.setattr(sch, "mega_device_count", lambda device: 8)
    jfaults.reset()
    faults.reset()
    yield
    jfaults.reset()
    faults.reset()


def _engine(port: bool, **kw):
    kw = dict(KNOBS, **kw)
    if port:
        return Engine(ServeConfig(**kw), device="cpu")
    return JEngine(JServeConfig(**kw))


def _cfg(port: bool, **kw):
    if port:
        return HeatConfig(**kw)
    kw["local_kernel"] = _REF_KERNEL[kw.get("local_kernel", "auto")]
    return JHeatConfig(**kw)


def _drain(port: bool, reqs, **kw):
    """Submit ``reqs`` ((id, HeatConfig kwargs) pairs) and drain; returns
    (engine, records by id)."""
    eng = _engine(port, **kw)
    for rid, c in reqs:
        eng.submit(_cfg(port, **c), request_id=rid)
    return eng, {r["id"]: r for r in eng.results()}


@contextlib.contextmanager
def _boundaries(port: bool, monkeypatch):
    """Every mega boundary vector the engine fetches, in order (the packed
    groups fetch through their lane engines, not this seam)."""
    got = []
    module, name = (sch, "fetch_boundary") if port else (
        jsch, "engine_fetch_boundary")
    orig = getattr(module, name)

    def spy(*a, **k):
        b = orig(*a, **k)
        got.append(np.array(b))
        return b

    monkeypatch.setattr(module, name, spy)
    yield got
    monkeypatch.setattr(module, name, orig)


def _bits(a):
    return np.asarray(a).tobytes()


# --- the mega-lane against the reference's ----------------------------------

CASES = [("float64", "auto", 0), ("float32", "cuda", 0),
         ("bfloat16", "cuda", 0), ("bfloat16", "cuda", 3)]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("dtype,kernel,fuse", CASES,
                         ids=lambda v: str(v))
def test_mega_lane_bytes_and_boundaries_are_the_references(
        dtype, kernel, fuse, depth, tmp_path, monkeypatch):
    mega = dict(MEGA, dtype=dtype, local_kernel=kernel, fuse_steps=fuse)
    reqs = [("big", mega), ("small", SMALL)]
    out = {}
    bounds = {}
    for port in (True, False):
        with _boundaries(port, monkeypatch) as b:
            _, out[port] = _drain(port, reqs, dispatch_depth=depth,
                                  keep_fields=True,
                                  out_dir=str(tmp_path / str(port)))
        bounds[port] = b
    for port in (True, False):
        rec = out[port]["big"]
        assert rec["status"] == "ok", rec
        assert rec["placement"] == "mega" and rec["bucket"] is None
        assert out[port]["small"]["placement"] == "packed"
    for rid in ("big", "small"):
        assert _bits(out[True][rid]["T"]) == _bits(out[False][rid]["T"])
        assert (tmp_path / "True" / f"{rid}.npz").read_bytes() == (
            tmp_path / "False" / f"{rid}.npz").read_bytes()
    bp, bj = bounds[True], bounds[False]
    assert len(bp) == len(bj) == -(-MEGA["ntime"] // KNOBS["chunk"])
    for a, b in zip(bp, bj):
        assert (a[:2] == b[:2]).all()
        sa = np.ascontiguousarray(a[2:]).view(np.float32)
        sb = np.ascontiguousarray(b[2:]).view(np.float32)
        assert sa[:3].tobytes() == sb[:3].tobytes()
        np.testing.assert_allclose(sa[3], sb[3], rtol=1e-6)
    assert [int(b[0][0]) for b in bp] == [29, 21, 13, 5, 0]
    assert all(int(b[1][0]) == 1 for b in bp)


def test_f32_mega_lane_is_the_solo_sharded_and_single_device_field():
    cfg = HeatConfig(**dict(MEGA, dtype="float32", local_kernel="cuda"))
    _, recs = _drain(True, [("big", dict(MEGA, dtype="float32",
                                         local_kernel="cuda"))],
                     keep_fields=True)
    with contextlib.redirect_stdout(io.StringIO()):
        sharded = solve(cfg.with_(backend="sharded"), device="cpu",
                        virtual_devices=8).T
        single = solve(cfg.with_(backend="cuda"), device="cpu").T
    assert _bits(recs["big"]["T"]) == _bits(sharded) == _bits(single)


@pytest.mark.parametrize("depth", [0, 2])
def test_packed_lanes_beside_a_mega_lane_equal_a_mega_free_run(depth):
    smalls = [("s1", SMALL), ("s2", dict(n=7, ntime=11, dtype="float32",
                                          bc="ghost", ic="uniform"))]
    _, free = _drain(True, smalls, dispatch_depth=depth, keep_fields=True)
    eng, recs = _drain(True, [("big", dict(MEGA, dtype="float32"))]
                       + smalls, dispatch_depth=depth, keep_fields=True)
    for rid, _ in smalls:
        assert recs[rid]["status"] == "ok"
        assert _bits(recs[rid]["T"]) == _bits(free[rid]["T"])
    s = eng.summary()
    assert s["placement"] == {"mega": 1, "packed": 2}
    assert s["mega_lanes"] == 1 and s["mega_compiles"] == 1
    assert s["mega_chunks"] == 5


def test_warm_readmission_builds_nothing():
    eng = _engine(True)
    eng.submit(HeatConfig(**dict(MEGA, dtype="float32")))
    eng.results()
    assert eng.mega_compiles == 1
    rid = eng.submit(HeatConfig(**dict(MEGA, dtype="float32")))
    recs = {r["id"]: r for r in eng.results()}
    assert recs[rid]["status"] == "ok"
    assert eng.mega_compiles == 1


def test_ntime_zero_returns_the_ic():
    mega = dict(MEGA, dtype="float32", ntime=0, ic="hat_half")
    _, recs = _drain(True, [("z", mega)], keep_fields=True)
    _, jrecs = _drain(False, [("z", mega)], keep_fields=True)
    assert recs["z"]["status"] == "ok" and recs["z"]["steps_done"] == 0
    ic = initial_condition(HeatConfig(**mega))
    assert _bits(recs["z"]["T"]) == _bits(ic) == _bits(jrecs["z"]["T"])


# --- rejections --------------------------------------------------------------

@pytest.mark.parametrize("case", ["single-device-auto", "mega-lanes-0",
                                  "indivisible"])
def test_rejections_are_the_references(case, monkeypatch):
    kw, n = {}, MEGA["n"]
    if case == "single-device-auto":
        monkeypatch.setattr(sch, "mega_device_count", lambda device: 1)
        monkeypatch.setattr(jsch, "mega_device_count", lambda: 1)
    elif case == "mega-lanes-0":
        kw = dict(mega_lanes=0)
    else:
        n = 17
    reqs = [("big", dict(MEGA, n=n, dtype="float64")), ("small", SMALL)]
    eng, recs = _drain(True, reqs, **kw)
    _, jrecs = _drain(False, reqs, **kw)
    rec, jrec = recs["big"], jrecs["big"]
    assert rec["status"] == jrec["status"] == "rejected"
    assert rec["error"] == jrec["error"]
    assert rec.get("hint") == jrec.get("hint")
    assert rec["placement"] is None and rec["bucket"] is None
    assert recs["small"]["status"] == "ok"
    if case == "indivisible":
        assert "does not divide evenly" in rec["error"]
        assert "hint" not in rec
    else:
        assert rec["hint"] == "enable --mega-lanes"
        assert eng.mega_compiles == 0 and eng.summary()["mega_lanes"] == 0


def test_max_queue_counts_the_mega_queue():
    eng = _engine(True, mega_lanes=1, max_queue=1)
    first = eng.submit(HeatConfig(**SMALL))
    shed = eng.submit(HeatConfig(**dict(MEGA, dtype="float32")))
    recs = {r["id"]: r for r in eng.results()}
    assert recs[first]["status"] == "ok"
    assert recs[shed]["status"] == "rejected"
    assert "overloaded" in recs[shed]["error"]
    assert eng.shed == 1
    # the mega queue counts the other way too
    eng = _engine(True, mega_lanes=1, max_queue=1)
    eng.submit(HeatConfig(**dict(MEGA, dtype="float32")))
    shed = eng.submit(HeatConfig(**SMALL))
    recs = {r["id"]: r for r in eng.results()}
    assert recs[shed]["status"] == "rejected" and eng.shed == 1


# --- fault domains -----------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
def test_lane_nan_quarantines_the_mega_lane_only(depth, tmp_path):
    reqs = [("boom", dict(MEGA, dtype="float32")), ("small", SMALL)]
    kw = dict(dispatch_depth=depth, keep_fields=True,
              inject="lane-nan@10:req=boom")
    eng, recs = _drain(True, reqs, out_dir=str(tmp_path / "p"), **kw)
    _, jrecs = _drain(False, reqs, out_dir=str(tmp_path / "j"), **kw)
    assert recs["boom"]["status"] == jrecs["boom"]["status"] == "nonfinite"
    assert recs["boom"]["error"] == jrecs["boom"]["error"]
    assert "mega lane" in recs["boom"]["error"]
    assert recs["boom"]["steps_done"] == jrecs["boom"]["steps_done"]
    assert not (tmp_path / "p" / "boom.npz").exists()
    assert eng.lanes_quarantined == 1
    assert recs["small"]["status"] == "ok"
    assert _bits(recs["small"]["T"]) == _bits(jrecs["small"]["T"])


@pytest.mark.parametrize("exchange", ["indep", "overlap"])
@pytest.mark.parametrize("depth", [0, 2])
def test_rollback_heals_a_transient_nan_on_the_mega_lane(depth, exchange):
    """Snapshots hold the shards by reference (copies under the overlap
    exchange, whose blocks write into the input of the block before)."""
    mega = dict(MEGA, dtype="float32", local_kernel="cuda",
                exchange=exchange)
    _, clean = _drain(True, [("heal", mega)], keep_fields=True)
    eng, recs = _drain(True, [("heal", mega)], dispatch_depth=depth,
                       on_nan="rollback", keep_fields=True,
                       inject="lane-nan@10:req=heal")
    assert recs["heal"]["status"] == "ok", recs["heal"]
    assert eng.rollbacks == 1 and eng.lanes_quarantined == 0
    assert _bits(recs["heal"]["T"]) == _bits(clean["heal"]["T"])


@pytest.mark.parametrize("exchange", ["indep", "overlap"])
def test_a_snapshot_copies_only_under_the_overlap_exchange(exchange):
    from heat_tpu_torch.serve.engine import MegaLaneEngine

    cfg = HeatConfig(**dict(MEGA, dtype="float32", local_kernel="cuda",
                            exchange=exchange))
    eng = MegaLaneEngine(cfg, 8, 8, device="cpu")
    eng.dispatch_chunk(8)
    snap = eng.snapshot_state()
    live = [s.data_ptr() for s in eng._F.shards]
    held = [s.data_ptr() for s in snap.shards]
    assert (held == live) == (exchange == "indep")
    before = [o.clone() for o in snap.owned()]
    eng.poison_center()                  # a chaos write copies its shard
    eng.dispatch_chunk(8)                # the exchange rewrites margins only
    assert all(torch.equal(a, b) for a, b in zip(before, snap.owned()))
    eng.restore(snap, 21)
    restored = [s.data_ptr() for s in eng._F.shards]
    assert (restored == held) == (exchange == "indep")


def test_deadline_preempts_the_mega_lane_at_a_boundary(monkeypatch):
    t = {"now": 0.0}

    def fake_clock():
        t["now"] += 1.0
        return t["now"]

    monkeypatch.setattr(sch, "wall_clock", fake_clock)
    eng = _engine(True, mega_lanes=1)
    doomed = eng.submit(HeatConfig(**dict(MEGA, ntime=80,
                                          dtype="float32")),
                        deadline_ms=20_000.0)
    follower = eng.submit(HeatConfig(**dict(MEGA, ntime=8,
                                            dtype="float32")))
    recs = {r["id"]: r for r in eng.results()}
    assert recs[doomed]["status"] == "deadline"
    assert "mega lane preempted" in recs[doomed]["error"]
    assert recs[doomed]["usage"]["steps"] > 0
    assert recs[follower]["status"] == "ok"
    assert eng.deadline_misses == 1


def test_watchdog_fails_the_mega_tier_and_packed_drains(tmp_path):
    """Fetch 0 is the packed group's (the groups come first in the
    round-robin), fetch 1 the mega-lane's."""
    eng = _engine(True, inject="fetch-hang@1:ms=1500", fetch_timeout_s=0.2,
                  flight_dir=str(tmp_path))
    packed = eng.submit(HeatConfig(**SMALL))
    hung = eng.submit(HeatConfig(**dict(MEGA, dtype="float32")),
                      request_id="wedge")
    queued = eng.submit(HeatConfig(**dict(MEGA, ntime=5, dtype="float32")),
                        request_id="behind")
    recs = {r["id"]: r for r in eng.results()}
    assert len(recs) == 3
    for rid in (hung, queued):
        assert recs[rid]["status"] == "error"
        assert "fetch-watchdog" in recs[rid]["error"]
    assert recs[packed]["status"] == "ok"
    assert eng.watchdog_fired == 1


def test_watchdog_sync_fallback(tmp_path):
    eng = _engine(True, dispatch_depth=0, inject="fetch-hang:ms=1500",
                  fetch_timeout_s=0.2, flight_dir=str(tmp_path))
    rid = eng.submit(HeatConfig(**dict(MEGA, dtype="float32")))
    recs = {r["id"]: r for r in eng.results()}
    assert recs[rid]["status"] == "error"
    assert "fetch-watchdog" in recs[rid]["error"]


# --- the observatories, the gateway, the CLI ---------------------------------

def test_placement_in_usage_metrics_and_the_cost_model():
    eng = _engine(True)
    eng.submit(HeatConfig(**dict(MEGA, dtype="float32")), tenant="acme")
    eng.submit(HeatConfig(**SMALL), tenant="acme")
    eng.results()
    rows = eng.summary()["cost_model"]
    placements = {(e["placement"], e["kernel"]) for e in rows}
    assert ("mega", "sharded") in placements
    assert any(p == "packed" for p, _ in placements)
    text = render_metrics(eng)
    assert ('heat_tpu_serve_requests_by_placement_total{placement="mega"} 1'
            in text)
    assert ('heat_tpu_serve_requests_by_placement_total'
            '{placement="packed"} 1') in text
    assert 'placement="mega"' in text.split(
        "heat_tpu_serve_cost_s_per_lane_step", 1)[1]
    assert "heat_tpu_serve_mega_lanes 1" in text
    assert "heat_tpu_serve_mega_compiles_total 1" in text
    for line in text.splitlines():
        if line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    usage = usage_payload(eng)
    cell = usage["tenants"]["acme"]["classes"]["standard"]
    assert cell["by_placement"] == {"mega": 1, "packed": 1}
    assert usage["totals"]["by_placement"] == {"mega": 1, "packed": 1}
    assert "placement: 1 packed / 1 mega" in render_statusz(eng)


def test_an_oversized_request_over_http(tmp_path):
    eng = _engine(True, keep_fields=True, out_dir=str(tmp_path / "out"))
    gw = Gateway(eng, "127.0.0.1", 0).start()
    try:
        body = json.dumps(dict(id="giant", n=16, ntime=12,
                               dtype="float64")).encode()
        req = urllib.request.Request(f"http://{gw.address}/v1/solve",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.status == 200
            (rec,) = [json.loads(ln) for ln in r.read().decode().splitlines()]
        assert rec["id"] == "giant" and rec["status"] == "ok", rec
        assert rec["placement"] == "mega" and rec["bucket"] is None
        with urllib.request.urlopen(f"http://{gw.address}/statusz",
                                    timeout=TIMEOUT) as r:
            assert "1 mega" in r.read().decode()
    finally:
        gw.request_drain()
        assert gw.wait_drained(TIMEOUT)
        gw.close()
        eng.shutdown(timeout=TIMEOUT)
    cfg = HeatConfig(n=16, ntime=12, dtype="float64", backend="sharded")
    with contextlib.redirect_stdout(io.StringIO()):
        solo = solve(cfg, device="cpu", virtual_devices=8).T
    with np.load(tmp_path / "out" / "giant.npz") as z:
        assert z["T"].tobytes() == solo.tobytes()


@pytest.mark.parametrize("value", ["auto", "AUTO", "0", 3, "2", "sideways",
                                   "-1", "1.5"])
def test_parse_mega_lanes_is_the_references(value):
    try:
        want = jparse_mega_lanes(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mega_lanes(value)
        assert str(got.value) == str(e)
    else:
        assert parse_mega_lanes(value) == want
    with pytest.raises(ValueError, match="mega_lanes"):
        ServeConfig(mega_lanes=-2)
    assert ServeConfig(mega_lanes=None).mega_lanes is None


def test_serve_cli_mega_lanes(tmp_cwd, capsys):
    (tmp_cwd / "reqs.jsonl").write_text(
        '{"id": "big", "n": 16, "ntime": 8, "dtype": "float64"}\n'
        '{"id": "small", "n": 8, "ntime": 8, "dtype": "float64"}\n')
    base = ["serve", "--requests", "reqs.jsonl", "--buckets", "8", "--chunk",
            "8", "--device", "cpu"]

    def records(out):
        return {r["id"]: r for r in (json.loads(ln) for ln in out.splitlines()
                                     if ln.startswith("{")
                                     and '"serve_request"' in ln)}

    assert cli.main(base + ["--mega-lanes", "0"]) == 1
    recs = records(capsys.readouterr().out)
    assert recs["big"]["status"] == "rejected"
    assert recs["big"]["hint"] == "enable --mega-lanes"
    assert recs["small"]["status"] == "ok"
    # auto on the 8-shard mesh serves both, and the report says so
    assert cli.main(base) == 0
    out = capsys.readouterr().out
    assert records(out)["big"]["placement"] == "mega"
    assert "2 ok" in out
    assert "placement: 1 packed, 1 mega" in out
    assert cli.main(base + ["--mega-lanes", "many"]) == 2
    assert "mega-lanes" in capsys.readouterr().err


def test_info_prints_the_serve_placement_line(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert "serve placement: two-tier" in out
    assert "8-device mesh (4x2 for 2D)" in out
    assert "mega-lanes default 1" in out


# --- the solve cache and until=steady ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_solve_cache_full_and_prefix_hits(dtype, tmp_path):
    mega = dict(MEGA, dtype=dtype, local_kernel="cuda")
    cache = dict(cache=True, cache_dir=str(tmp_path / "c"))
    _drain(True, [("p", dict(mega, ntime=16))], out_dir=str(tmp_path / "o0"),
           **cache)
    eng, recs = _drain(True, [("x", mega)], out_dir=str(tmp_path / "o1"),
                       **cache)
    assert eng.summary()["cache"]["hits_prefix"] == 1
    assert recs["x"]["placement"] == "mega"
    assert recs["x"]["usage"]["steps"] == mega["ntime"] - 16
    assert recs["x"]["usage"]["steps_saved"] == 16
    eng, recs = _drain(True, [("x", mega)], out_dir=str(tmp_path / "o2"),
                       **cache)
    assert eng.summary()["cache"]["hits_full"] == 1
    assert recs["x"]["cached"] and recs["x"]["placement"] == "mega"
    assert eng.mega_chunks == 0
    _drain(False, [("x", mega)], out_dir=str(tmp_path / "o3"))
    want = (tmp_path / "o3" / "x.npz").read_bytes()
    assert (tmp_path / "o1" / "x.npz").read_bytes() == want
    assert (tmp_path / "o2" / "x.npz").read_bytes() == want


def test_until_steady_on_a_mega_lane():
    mega = dict(MEGA, ntime=400, dtype="float32", ic="sine",
                local_kernel="cuda")
    out = {}
    for port in (True, False):
        eng = _engine(port, keep_fields=True)
        eng.submit(_cfg(port, **mega), request_id="s", until="steady",
                   tol=2e-3)
        out[port] = {r["id"]: r for r in eng.results()}["s"]
    rec, jrec = out[True], out[False]
    assert rec["status"] == "ok" and rec["exit"] == "steady"
    assert 0 < rec["steps_done"] < mega["ntime"]
    for k in ("exit", "steps_done", "predicted_steps"):
        assert rec[k] == jrec[k], k
    assert _bits(rec["T"]) == _bits(jrec["T"])
    _, cut = _drain(True, [("c", dict(mega, ntime=rec["steps_done"]))],
                    keep_fields=True)
    assert _bits(rec["T"]) == _bits(cut["c"]["T"])


# --- engine checkpoints across packages --------------------------------------

CKPT_REQS = [("m", dict(n=16, ntime=37, dtype="float32", backend="sharded")),
             ("s", dict(n=8, ntime=30, dtype="float32", backend="sharded"))]


def _handoff(port: bool, ckpt_dir, monkeypatch, hold_at=2):
    """Serve CKPT_REQS online, hold the scheduler thread inside the mega
    runner's ``hold_at``-th boundary, ask for the handoff drain there."""
    module = sch if port else jsch
    orig = module.MegaLaneRunner.process_boundary
    seen, asked = [], threading.Event()

    def gated(self):
        orig(self)
        seen.append(1)
        if len(seen) == hold_at:
            asked.wait(TIMEOUT)

    monkeypatch.setattr(module.MegaLaneRunner, "process_boundary", gated)
    eng = _engine(port, engine_ckpt_dir=str(ckpt_dir))
    for rid, c in CKPT_REQS:
        eng.submit(_cfg(port, **c), request_id=rid)
    eng.start()
    try:
        for _ in range(6000):
            if len(seen) >= hold_at or not eng.online:
                break
            threading.Event().wait(0.01)
        assert len(seen) >= hold_at, "the scheduler never reached the hold"
        eng.begin_drain(handoff=True)
        asked.set()
        assert eng.shutdown(timeout=TIMEOUT)
    finally:
        asked.set()
        eng.shutdown(timeout=TIMEOUT)
        monkeypatch.setattr(module.MegaLaneRunner, "process_boundary", orig)
    assert eng.loop_error is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mega_checkpoint_resumes_across_packages(writer, tmp_path,
                                                 monkeypatch):
    _handoff(True, tmp_path / "p", monkeypatch)
    _handoff(False, tmp_path / "j", monkeypatch)
    mp, _ = ckpt.latest_engine_manifest(tmp_path / "p")
    mj, _ = ckpt.latest_engine_manifest(tmp_path / "j")
    (ep,) = [e for e in mp["inflight"] if e["id"] == "m"]
    (ej,) = [e for e in mj["inflight"] if e["id"] == "m"]
    assert ep["placement"] == ej["placement"] == "mega"
    assert ep["remaining"] == ej["remaining"] > 0
    assert ep["chunks"] == ej["chunks"]
    name = ckpt.ENGINE_FIELD_FMT.format(gen=mp["generation"], rid="m")
    assert mp["generation"] == mj["generation"]
    assert (tmp_path / "p" / name).read_bytes() == (
        tmp_path / "j" / name).read_bytes()
    # the other package finishes the generation this one wrote
    src = tmp_path / ("p" if writer == "port" else "j")
    out = tmp_path / "out"
    if writer == "port":
        eng = _engine(False, out_dir=str(out))
        known = jresume.resume_engine(eng, src)
    else:
        eng = _engine(True, out_dir=str(out))
        known = resume.resume_engine(eng, src)
    assert known == {rid for rid, _ in CKPT_REQS}
    recs = {r["id"]: r for r in eng.results()}
    assert recs["m"]["status"] == "ok" and recs["m"]["resumed"] is True
    assert recs["m"]["placement"] == "mega"
    _drain(False, CKPT_REQS, out_dir=str(tmp_path / "straight"))
    for rid, _ in CKPT_REQS:
        if rid in recs:
            assert (out / f"{rid}.npz").read_bytes() == (
                tmp_path / "straight" / f"{rid}.npz").read_bytes(), rid
