"""Serving semantics of the port's engine against heat_tpu's.

``until=steady`` retirement, the numerics observatory, ``--serve-on-nan
rollback``, the serve fault kinds (``lane-nan``, ``perturb``,
``fetch-hang``), the online loop with lane-tier growth, and the policies'
predicted-finish ranks. Each case drains the same seeded requests through
the JAX ``Engine`` (its XLA lane program, byte-equal to the lane kernels)
and the port's ``Engine(device="cpu")`` (the lane kernels' plain version)
at the same ``ServeConfig`` knobs, and compares fields (bytes), statuses,
``exit``, ``steps_done``, ``predicted_steps``, the counters and the
reference's messages. ``heat`` is a float32 sum in another order, so it is
held within a tolerance where it is compared.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.runtime import faults as jfaults
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu.serve import policy as jpolicy
from heat_tpu.serve import scheduler as jsch
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.ops import cuda_lanes
from heat_tpu_torch.runtime import faults
from heat_tpu_torch.serve import Engine, ServeConfig
from heat_tpu_torch.serve import engine as te
from heat_tpu_torch.serve import policy
from heat_tpu_torch.serve import scheduler as sch

torch.set_num_threads(1)
_REPO = Path(__file__).resolve().parent.parent

PORT = (Engine, ServeConfig, HeatConfig)
JAX = (JEngine, JServeConfig, JHeatConfig)


@pytest.fixture(autouse=True)
def _fresh_faults():
    jfaults.reset()
    faults.reset()
    yield
    jfaults.reset()
    faults.reset()


def _engine(impl, **kw):
    engine_cls, scfg_cls, _ = impl
    kw.setdefault("emit_records", False)
    kw.setdefault("keep_fields", True)
    extra = {"device": "cpu"} if engine_cls is Engine else {}
    return engine_cls(scfg_cls(**kw), **extra)


def _drain(impl, reqs, **kw):
    """Submit ``reqs`` (dicts: HeatConfig fields plus id/until/tol) and
    drain; returns (engine, records in submit order)."""
    eng = _engine(impl, **kw)
    ids = []
    for r in reqs:
        r = dict(r)
        rid, until, tol = r.pop("id"), r.pop("until", None), r.pop("tol", None)
        ids.append(eng.submit(impl[2](**r), request_id=rid, until=until,
                              tol=tol))
    by_id = {r["id"]: r for r in eng.results()}
    return eng, [by_id[i] for i in ids]


COMPARED = ("status", "exit", "steps_done", "predicted_steps", "until",
            "error", "lane", "bucket")
COUNTERS = ("rollbacks", "lanes_quarantined", "steady_exits", "steps_saved",
            "steady_lanes", "numerics_violations", "watchdog_fired",
            "lane_grows", "chunks_dispatched", "tail_chunks")


def _agree(recs_p, recs_j, eng_p=None, eng_j=None, fields=True):
    """Records equal on the compared keys, fields byte-equal, counters
    equal."""
    for rp, rj in zip(recs_p, recs_j):
        for k in COMPARED:
            assert rp.get(k) == rj.get(k), (rp["id"], k, rp.get(k), rj.get(k))
        if fields and rp["status"] == "ok":
            Tj = np.asarray(rj["T"])
            assert rp["T"].shape == Tj.shape
            assert rp["T"].tobytes() == Tj.tobytes(), rp["id"]
    if eng_p is not None:
        sp, sj = eng_p.summary(), eng_j.summary()
        for k in COUNTERS:
            assert sp[k] == sj[k], (k, sp[k], sj[k])


# --- until=steady ------------------------------------------------------------

# sine is the eigenmode IC: its residual decays as lambda**s, so these
# tolerances are crossed well inside ntime
STEADY = [
    dict(id="s2", n=12, ntime=160, dtype="float32", bc="edges", ic="sine",
         until="steady", tol=2e-3),
    dict(id="c2", n=12, ntime=40, dtype="float32", bc="edges", ic="hat"),
    dict(id="sb", n=10, ntime=120, dtype="bfloat16", bc="edges", ic="sine",
         until="steady", tol=4e-3),
    dict(id="sg", n=11, ntime=150, dtype="float32", bc="ghost", ic="hat",
         bc_value=1.0, until="steady", tol=1e-3),
]
STEADY_3D = [
    dict(id="s3", n=8, ntime=90, ndim=3, sigma=0.15, dtype="float32",
         bc="edges", ic="sine", until="steady", tol=2e-3),
    dict(id="c3", n=7, ntime=30, ndim=3, sigma=0.15, dtype="float32",
         bc="ghost", ic="hat_half"),
]


def _fixed(r, steps):
    """The same request as a fixed-step run of ``steps`` steps."""
    d = {k: v for k, v in r.items() if k not in ("until", "tol")}
    return dict(d, id=r["id"] + "-cut", ntime=int(steps))


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("reqs,bucket", [(STEADY, 12), (STEADY_3D, 8)])
def test_steady_exit_matches_jax_engine_and_a_cut_run(tmp_path, reqs, bucket,
                                                      depth):
    kw = dict(lanes=2, chunk=8, buckets=(bucket,), dispatch_depth=depth)
    eng_p, recs_p = _drain(PORT, reqs, out_dir=str(tmp_path / "p"), **kw)
    eng_j, recs_j = _drain(JAX, reqs, **kw)
    _agree(recs_p, recs_j, eng_p, eng_j)
    steady = [r for r in recs_p if r["until"] == "steady"]
    assert all(r["exit"] == "steady" for r in steady)
    assert eng_p.summary()["steps_saved"] == sum(
        r["ntime"] - r["steps_done"] for r in steady) > 0
    for r, want in zip(recs_p, reqs):
        assert r["status"] == "ok"
        if r["until"] != "steady":
            assert r["exit"] == "steps" and r["steps_done"] == r["ntime"]
            continue
        assert 0 < r["steps_done"] < r["ntime"]
        assert r["predicted_steps"] is not None
        # byte-equal to a fixed-step run cut at steps_done, in memory and
        # in the published npz
        _, (cut,) = _drain(PORT, [_fixed(want, r["steps_done"])], **kw)
        assert r["T"].tobytes() == cut["T"].tobytes(), r["id"]
        with np.load(tmp_path / "p" / f"{r['id']}.npz") as z:
            assert int(z["step"]) == r["steps_done"]
            assert z["T"].tobytes() == cut["T"].tobytes()


def test_steady_unreachable_tol_runs_every_step():
    req = dict(STEADY[0], ntime=48, tol=1e-14)
    kw = dict(lanes=1, chunk=8, buckets=(16,))
    eng_p, recs_p = _drain(PORT, [req], **kw)
    eng_j, recs_j = _drain(JAX, [req], **kw)
    _agree(recs_p, recs_j, eng_p, eng_j)
    (r,) = recs_p
    assert r["exit"] == "steps" and r["steps_done"] == 48
    assert eng_p.summary()["steady_exits"] == 0
    _, (fixed,) = _drain(PORT, [_fixed(req, 48)], **kw)
    assert r["T"].tobytes() == fixed["T"].tobytes()


def test_numerics_on_and_off_are_byte_identical_with_no_extra_fetch(
        monkeypatch):
    """The observatory only reads the boundary already fetched: on and off
    give the same bytes and the same host fetches (fixed-step requests,
    which the verdicts do not retire)."""
    calls = {"n": 0}
    orig = te.host_fetch

    def counting(x):
        calls["n"] += 1
        return orig(x)

    monkeypatch.setattr(te, "host_fetch", counting)
    reqs = [dict(r, until=None, tol=None) for r in STEADY]
    out = {}
    for mode in (True, False):
        calls["n"] = 0
        eng, recs = _drain(PORT, reqs, lanes=2, chunk=4, buckets=(12,),
                           numerics=mode, steady_tol=1e-3)
        s = eng.summary()
        assert s["numerics"] is mode
        assert (s["steady_lanes"] > 0) is mode
        out[mode] = ([r["T"].tobytes() for r in recs], calls["n"])
    assert out[True] == out[False] and out[True][1] > 0


# --- rollback ------------------------------------------------------------------

CHAOS = [
    dict(id="r0", n=10, ntime=12, dtype="float32", bc="ghost"),
    dict(id="r1", n=12, ntime=20, dtype="float32", bc="edges",
         ic="hat_small"),
    dict(id="r2", n=8, ntime=16, dtype="float32", bc="ghost", ic="uniform"),
    dict(id="r3", n=9, ntime=24, dtype="bfloat16", bc="edges", ic="hat"),
]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("spec", ["lane-nan@6:req=r1",
                                  "lane-nan@2:req=r3,lane-nan@9:req=r1",
                                  "lane-nan@0:req=r2"])
def test_rollback_heals_transient_lane_nan(depth, spec):
    """A lane poisoned once (fire-once per request) is restored from its
    last verified boundary (or, before one, its initial condition) and
    re-stepped alone: every field byte-equal to a clean run and to the JAX
    engine's, ``rollbacks`` the number of poisoned requests."""
    kw = dict(lanes=2, chunk=4, buckets=(12,), dispatch_depth=depth)
    # the bf16 request gets a bucket group of its own
    _, clean = _drain(PORT, CHAOS, **kw)
    eng_p, recs_p = _drain(PORT, CHAOS, on_nan="rollback", inject=spec, **kw)
    eng_j, recs_j = _drain(JAX, CHAOS, on_nan="rollback", inject=spec, **kw)
    _agree(recs_p, recs_j, eng_p, eng_j)
    assert all(r["status"] == "ok" for r in recs_p)
    assert eng_p.rollbacks == spec.count("lane-nan") >= 1
    for a, b in zip(recs_p, clean):
        assert a["T"].tobytes() == b["T"].tobytes(), a["id"]


@pytest.mark.parametrize("depth", [0, 2])
def test_deterministic_blowup_quarantined_after_two_rollbacks(depth):
    reqs = [dict(id="r0", n=16, ntime=200, dtype="float32", sigma=9.0),
            dict(id="r1", n=16, ntime=40, dtype="float32")]
    kw = dict(lanes=2, chunk=4, buckets=(16,), dispatch_depth=depth,
              on_nan="rollback")
    eng_p, recs_p = _drain(PORT, reqs, **kw)
    eng_j, recs_j = _drain(JAX, reqs, **kw)
    _agree(recs_p, recs_j, eng_p, eng_j)
    assert recs_p[0]["status"] == "nonfinite"
    assert "after 2 rollbacks (deterministic blow-up)" in recs_p[0]["error"]
    assert eng_p.rollbacks == 2 and eng_p.lanes_quarantined == 1
    _, (mate,) = _drain(PORT, reqs[1:], lanes=2, chunk=4, buckets=(16,))
    assert recs_p[1]["T"].tobytes() == mate["T"].tobytes()


def test_rollback_snapshot_survives_later_admissions():
    """Three requests over one lane force admissions between boundaries
    (loads into the live stack, which is a boundary snapshot); the poisoned
    request still heals from its last good state."""
    reqs = [dict(id="r0", n=10, ntime=12, dtype="float32", bc="ghost"),
            dict(id="r1", n=10, ntime=12, dtype="float32", bc="ghost",
                 ic="hat_small"),
            dict(id="r2", n=10, ntime=12, dtype="float32", bc="ghost",
                 ic="uniform")]
    kw = dict(lanes=1, chunk=4, buckets=(12,), dispatch_depth=2,
              on_nan="rollback", inject="lane-nan@6:req=r1")
    eng_p, recs_p = _drain(PORT, reqs, **kw)
    eng_j, recs_j = _drain(JAX, reqs, **kw)
    _agree(recs_p, recs_j, eng_p, eng_j)
    assert all(r["status"] == "ok" for r in recs_p) and eng_p.rollbacks == 1
    _, clean = _drain(PORT, reqs, lanes=1, chunk=4, buckets=(12,))
    assert [r["T"].tobytes() for r in recs_p] == [r["T"].tobytes()
                                                  for r in clean]


def test_rollback_mode_copies_no_stack_on_the_dispatch_path(monkeypatch):
    """Rollback keeps every in-flight boundary restorable without a stack
    copy: no clone of a whole lane stack runs while serving, and no chunk
    writes the stack it reads (the live stack is the previous boundary's
    snapshot). The 3D chunk is four passes, the case where ping-pong would
    overwrite its input. Bytes equal on-nan=fail."""
    orig_chunk = cuda_lanes.lane_chunk
    stack_shapes = set()
    written = []
    inside = []

    def watched(fields, spare, *a, **kw):
        stack_shapes.add(tuple(fields.shape))
        before = fields.numpy().tobytes()
        inside.append(1)
        try:
            out = orig_chunk(fields, spare, *a, **kw)
        finally:
            inside.pop()
        written.append(fields.numpy().tobytes() != before)
        assert kw.get("keep") is not None
        return out

    # clones outside the chunk (inside it, the plain version's own
    # arithmetic on the CPU; on the card the kernels write the stacks)
    clones = []
    orig_clone = torch.Tensor.clone

    def counting_clone(self, *a, **kw):
        if tuple(self.shape) in stack_shapes and not inside:
            clones.append(tuple(self.shape))
        return orig_clone(self, *a, **kw)

    reqs = [dict(id=f"q{i}", n=6 + i % 3, ntime=13 + 5 * i, ndim=3,
                 sigma=0.15, dtype="float32", bc=("edges", "ghost")[i % 2],
                 ic="hat") for i in range(5)]
    kw = dict(lanes=2, chunk=16, buckets=(8,), dispatch_depth=2)
    _, plain = _drain(PORT, reqs, **kw)
    monkeypatch.setattr(cuda_lanes, "lane_chunk", watched)
    monkeypatch.setattr(torch.Tensor, "clone", counting_clone)
    eng, recs = _drain(PORT, reqs, on_nan="rollback", **kw)
    monkeypatch.undo()
    assert eng.chunks_dispatched > 0 and len(written) == eng.chunks_dispatched
    assert not any(written)
    assert clones == []
    assert len(cuda_lanes.passes(3, 16)) >= 3
    assert [r["T"].tobytes() for r in recs] == [r["T"].tobytes()
                                                for r in plain]


# --- perturb and the numerics guard ----------------------------------------------


@pytest.mark.parametrize("guard", ["warn", "quarantine"])
def test_perturb_under_the_numerics_guard(guard, capsys):
    spec = "perturb@6:req=r1"
    kw = dict(lanes=2, chunk=4, buckets=(12,), dispatch_depth=2,
              numerics_guard=guard, inject=spec)
    eng_p, recs_p = _drain(PORT, CHAOS, **kw)
    eng_j, recs_j = _drain(JAX, CHAOS, **kw)
    _agree(recs_p, recs_j, eng_p, eng_j)
    assert eng_p.summary()["numerics_violations"] == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    viol = [x for x in lines if x["event"] == "numerics_violation"]
    assert len(viol) == 2 and viol[0]["why"] == viol[1]["why"]
    assert all(x["id"] == "r1" and x["guard"] == guard for x in viol)
    _, clean = _drain(PORT, CHAOS, lanes=2, chunk=4, buckets=(12,))
    if guard == "quarantine":
        assert recs_p[1]["status"] == "nonfinite"
        assert recs_p[1]["error"].startswith("numerics: max-principle "
                                             "violation at ~step")
        assert eng_p.lanes_quarantined == 1
    else:
        assert recs_p[1]["status"] == "ok"
        assert recs_p[1]["T"].tobytes() != clean[1]["T"].tobytes()
    for i in (0, 2, 3):
        assert recs_p[i]["T"].tobytes() == clean[i]["T"].tobytes()


# --- fetch-hang --------------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 2])
def test_fetch_hang_fails_the_group_as_the_jax_engine(depth):
    kw = dict(lanes=2, chunk=4, buckets=(12,), dispatch_depth=depth,
              fetch_timeout_s=1.0, inject="fetch-hang@2:ms=2500")
    eng_p, recs_p = _drain(PORT, CHAOS, **kw)
    eng_j, recs_j = _drain(JAX, CHAOS, **kw)
    _agree(recs_p, recs_j, eng_p, eng_j)
    assert eng_p.watchdog_fired == 1
    assert any(r["status"] == "error" and "fetch-watchdog" in r["error"]
               for r in recs_p)


# --- online serving and lane-tier growth -------------------------------------


ONLINE = ([dict(id="first", n=10, ntime=60, dtype="float32", bc="ghost")]
          + [dict(id=f"b{i}", n=8 + i % 3, ntime=20 + 4 * i, dtype="float32",
                  bc=("ghost", "edges")[i % 2], ic="hat_small")
             for i in range(7)])


def _online(impl, module, depth, monkeypatch):
    """One request, then (once its group has taken two boundaries at tier
    1) a burst of seven, through ``Engine.start()``. The scheduler thread
    waits inside its second boundary until the burst is queued, so both
    engines see the same arrival order and grow at the same boundary."""
    method = "sync_round" if depth == 0 else "process_boundary"
    orig = getattr(module._GroupRunner, method)
    seen, burst_in = [], threading.Event()

    def gated(self):
        orig(self)
        seen.append(1)
        if len(seen) == 2:
            burst_in.wait(30)

    monkeypatch.setattr(module._GroupRunner, method, gated)
    cfg_cls = impl[2]
    eng = _engine(impl, lanes=8, chunk=4, buckets=(12,), dispatch_depth=depth)
    eng.start()
    try:
        def submit(r):
            r = dict(r)
            rid = r.pop("id")
            return eng.submit(cfg_cls(**r), request_id=rid)

        ids = [submit(ONLINE[0])]
        for _ in range(6000):
            if len(seen) >= 2 or not eng.online:
                break
            threading.Event().wait(0.01)
        assert len(seen) >= 2, "the scheduler never took two boundaries"
        ids += [submit(r) for r in ONLINE[1:]]
        burst_in.set()
        recs = [eng.wait(rid, timeout=120) for rid in ids]
    finally:
        assert eng.shutdown(timeout=120)
        monkeypatch.undo()
    assert eng.loop_error is None
    return eng, [dict(r, T=eng._by_id[r["id"]].get("T")) for r in recs]


@pytest.mark.parametrize("depth", [0, 2])
def test_online_growth_matches_jax_online_run(depth, monkeypatch):
    eng_p, recs_p = _online(PORT, sch, depth, monkeypatch)
    eng_j, recs_j = _online(JAX, jsch, depth, monkeypatch)
    _agree(recs_p, recs_j, eng_p, eng_j)
    assert all(r["status"] == "ok" for r in recs_p)
    assert eng_p.lane_grows >= 1
    # byte-equal to the offline run of the same requests
    _, recs_o = _drain(PORT, ONLINE, lanes=8, chunk=4, buckets=(12,))
    assert [r["T"].tobytes() for r in recs_p] == [r["T"].tobytes()
                                                  for r in recs_o]
    assert eng_p.summary()["lane_grows"] == eng_p.lane_grows


def test_online_poll_cancel_listeners_and_drain():
    eng = _engine(PORT, lanes=2, chunk=4, buckets=(12,))
    seen = []
    eng.add_listener(seen.append)
    eng.start()
    assert eng.start() is eng and eng.online
    long = eng.submit(HeatConfig(n=10, ntime=4000), request_id="long")
    short = eng.submit(HeatConfig(n=8, ntime=8), request_id="short")
    assert eng.wait(short, timeout=60)["status"] == "ok"
    assert eng.poll(long)["status"] in ("queued", "running")
    assert eng.cancel(long)
    rec = eng.wait(long, timeout=60)
    assert rec["status"] == "deadline" and "cancelled" in rec["error"]
    assert not eng.cancel(long) and not eng.cancel("nope")
    with pytest.raises(KeyError):
        eng.wait("nope", timeout=0.01)
    with pytest.raises(RuntimeError, match="online"):
        eng.run()
    assert eng.shutdown(timeout=60) and not eng.online
    assert sorted(r["id"] for r in seen) == ["long", "short"]
    eng.remove_listener(seen.append)


# --- policies with predictions ------------------------------------------------------


def _reqs(module_req, cfg_cls):
    def req(seq, until="steps", predicted=None, deadline_t=None,
            slo_class="standard", tenant="default"):
        return module_req(id=f"r{seq}", cfg=cfg_cls(n=12, ntime=100),
                          submit_t=0.0, key=None, seq=seq, until=until,
                          predicted_steps=predicted, deadline_t=deadline_t,
                          slo_class=slo_class, tenant=tenant)
    return [req(0), req(1, "steady", 40), req(2, "steady", 10),
            req(3, deadline_t=5.0), req(4, "steady", None),
            req(5, slo_class="interactive"),
            req(6, "steady", 10, tenant="steady-co"),
            req(7, "steady", 10, tenant="steady-co"),
            req(8, tenant="fixed-co"), req(9, tenant="fixed-co")]


@pytest.mark.parametrize("name", ["edf", "fair", "fifo"])
def test_policy_orders_with_predictions_are_the_reference(name):
    orders = []
    for make, req_cls, cfg_cls in ((policy.make_queue, sch.Request,
                                    HeatConfig),
                                   (jpolicy.make_queue, jsch.Request,
                                    JHeatConfig)):
        q = make(name, (("steady-co", 1.0), ("fixed-co", 1.0)))
        reqs = _reqs(req_cls, cfg_cls)
        for r in reqs:
            q.push(r)
        orders.append([q.pop().id for _ in reqs])
    assert orders[0] == orders[1]
    if name == "edf":
        assert orders[0][:4] == ["r5", "r3", "r2", "r6"]


# --- fault grammar -------------------------------------------------------------------


SPECS = ["lane-nan@3", "lane-nan@3:req=a", "lane-nan@0:req=a:restart=-1",
         "perturb@6:req=r1", "perturb@6:eps=2.5", "perturb@1:req=x:eps=-3",
         "fetch-hang:ms=50", "fetch-hang@4:ms=1.5", "engine-kill@9",
         "lane-nan@2,perturb@4:req=b,fetch-hang@1:ms=5",
         "nan@6,lane-nan@1:proc=0", "sink-error@3:times=2,engine-kill@1"]
BAD = ["lane-nan", "lane-nan:req=a", "perturb", "perturb:eps=1",
       "engine-kill", "engine-kill:ms=3", "lane-nan@x", "perturb@1:eps=big",
       "lane-nan@1:who=a", "lane-nan@1:req", "fetch-hang@1:ms=slow"]


@pytest.mark.parametrize("spec", SPECS)
def test_serve_fault_specs_parse_as_the_reference(spec):
    got = [(f.kind, f.step, f.proc, f.times, f.ms, f.restart, f.req, f.eps)
           for f in faults.parse_spec(spec)]
    want = [(f.kind, f.step, f.proc, f.times, f.ms, f.restart, f.req, f.eps)
            for f in jfaults.parse_spec(spec)]
    assert got == want
    p, j = faults.FaultPlan(spec), jfaults.FaultPlan(spec)
    for rid in ("a", "b", "r1", "x"):
        assert p.lane_nan_steps(rid) == j.lane_nan_steps(rid)
        assert p.perturb_events(rid) == j.perturb_events(rid)


@pytest.mark.parametrize("spec", BAD)
def test_bad_serve_fault_specs_refused_as_the_reference(spec):
    with pytest.raises(ValueError):
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.parse_spec(spec)
    with pytest.raises(ValueError):
        ServeConfig(inject=spec)


def test_fetch_hang_and_engine_kill_fire_once(monkeypatch):
    slept = []
    monkeypatch.setattr(faults.time, "sleep", slept.append)
    plan = faults.FaultPlan("fetch-hang@2:ms=40")
    for i in range(5):
        plan.maybe_fetch_hang(i)
    assert slept == [0.04]
    killed = []
    monkeypatch.setattr(faults.os, "kill", lambda pid, sig: killed.append(sig))
    plan = faults.FaultPlan("engine-kill@3")
    for b in range(1, 6):
        plan.maybe_engine_kill(b)
    assert len(killed) == 1


def test_serve_config_validation_is_the_reference():
    for kw in (dict(on_nan="retry"), dict(numerics_guard="off"),
               dict(steady_tol=0.0), dict(steady_tol=-1.0),
               dict(inject="nope@1")):
        with pytest.raises(ValueError):
            JServeConfig(**kw)
        with pytest.raises(ValueError):
            ServeConfig(**kw)
    s, j = ServeConfig(), JServeConfig()
    for k in ("on_nan", "numerics", "steady_tol", "numerics_guard", "inject"):
        assert getattr(s, k) == getattr(j, k), k


# --- the serve CLI -------------------------------------------------------------------


def _cli(module, tmp_path, tag, lines, *extra):
    f = tmp_path / "req.jsonl"
    f.write_text("\n".join(lines) + "\n")
    dev = ["--device", "cpu"] if module == "heat_tpu_torch" else []
    env = {"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = tmp_path / tag
    proc = subprocess.run(
        [sys.executable, "-m", module, "serve", "--requests", str(f), *dev,
         "--lanes", "2", "--chunk", "4", "--buckets", "12", "--out-dir",
         str(out), "--json", *extra], capture_output=True, text=True,
        timeout=300, cwd=tmp_path, env=env)
    rows = [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]
    recs = {r["id"]: r for r in rows if r.get("event") == "serve_request"}
    return proc, recs, rows[-1] if rows else None, out


def test_cli_serve_new_flags_match_the_reference_cli(tmp_path):
    lines = ['{"id": "s", "n": 12, "ntime": 160, "ic": "sine", '
             '"until": "steady", "tol": 2e-3}',
             '{"id": "a", "n": 10, "ntime": 21, "bc": "ghost"}',
             '{"id": "b", "n": 9, "ntime": 30, "ic": "hat_small"}',
             '{"id": "c", "n": 11, "ntime": 17, "bc": "ghost", '
             '"inject": "perturb@4"}']
    flags = ("--serve-on-nan", "rollback", "--inject",
             "lane-nan@5:req=b", "--numerics", "on", "--steady-tol", "1e-9",
             "--numerics-guard", "quarantine", "--dispatch-depth", "2")
    pp, rp, sp, op = _cli("heat_tpu_torch", tmp_path, "port", lines, *flags)
    pj, rj, sj, oj = _cli("heat_tpu", tmp_path, "jax", lines, *flags)
    assert pp.returncode == pj.returncode == 1, (pp.stderr, pj.stderr)
    assert rp.keys() == rj.keys() == {"s", "a", "b", "c"}
    for rid in rp:
        for k in set(rp[rid]) & set(rj[rid]):
            # wall-clock keys, the out dir, and the trace id (a process id
            # and a counter) differ by nature; the usage stamp's lane_s is
            # wall clock, its other keys must agree
            if k.endswith("_s") or k in ("steps_per_s", "path", "trace_id"):
                continue
            if k == "usage":
                assert ({**rp[rid][k], "lane_s": None}
                        == {**rj[rid][k], "lane_s": None}), rid
                continue
            assert rp[rid][k] == rj[rid][k], (rid, k)
    assert rp["c"]["status"] == "nonfinite" and rp["s"]["exit"] == "steady"
    for k in ("rollbacks", "lanes_quarantined", "steady_exits", "steps_saved",
              "numerics", "numerics_guard", "steady_lanes",
              "numerics_violations", "ok", "nonfinite"):
        assert sp[k] == sj[k], k
    for rid in ("s", "a", "b"):
        with np.load(op / f"{rid}.npz") as a, np.load(oj / f"{rid}.npz") as b:
            assert a["T"].tobytes() == b["T"].tobytes()
            assert int(a["step"]) == int(b["step"])
    for line in ("semantic scheduling: 1 steady exit(s)", "numerics: ",
                 "fault domains: 1 quarantined, 1 rollback(s)"):
        assert line in pp.stdout and line in pj.stdout
    bad = _cli("heat_tpu_torch", tmp_path, "bad", lines, "--numerics",
               "maybe")[0]
    assert bad.returncode == 2 and "--numerics" in bad.stderr
