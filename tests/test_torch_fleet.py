"""The port's fleet router over real localhost sockets, against heat_tpu's.

Port routers over two in-process port gateways (engines on the CPU) and,
for the comparisons, the reference's router over the reference's
gateways. The contracts:

- concurrent POSTs through the router come back byte-equal to direct
  engine solves of the same configs, and to the JAX engine's bytes (the
  router adds routing, never arithmetic);
- edge admission, unroutable requests, deadline and brownout sheds give
  the reference router's records field for field (trace ids and times
  aside), and ``/metrics`` has the reference router's families;
- a port router in front of one JAX gateway and one port gateway gets the
  same bytes from each (the wire contract);
- ``backend-down``, ``stream-cut``, ``backend-flap``, the steal, hedging,
  deadlines, brownout, the shared-cache edge hit and mega routing behave
  as the reference's tests of its router say.

Every wait is on a condition with a deadline (never a bare sleep), every
socket operation has a timeout, and every router and gateway is closed in
a ``finally``.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from heat_tpu.fleet.registry import BackendRegistry as JRegistry
from heat_tpu.fleet.registry import parse_backends as jparse_backends
from heat_tpu.fleet.router import FleetConfig as JFleetConfig
from heat_tpu.fleet.router import Router as JRouter
from heat_tpu.fleet.router import render_fleet_metrics as jrender_metrics
from heat_tpu.runtime import faults as jfaults
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu.serve.gateway import Gateway as JGateway
from heat_tpu_torch import HeatConfig, solve
from heat_tpu_torch.fleet.registry import BackendRegistry, parse_backends
from heat_tpu_torch.fleet.router import (FleetConfig, Router,
                                         render_fleet_metrics,
                                         render_fleet_statusz)
from heat_tpu_torch.labs.fleet_lab import direct_solve
from heat_tpu_torch.runtime import faults
from heat_tpu_torch.serve import Engine, ServeConfig
from heat_tpu_torch.serve.gateway import Gateway

torch.set_num_threads(1)
TIMEOUT = 60
F64 = dict(n=24, dtype="float64")


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def wait_until(pred, timeout=TIMEOUT, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def make_backend(tmp_path, name, port=True, **kw):
    d = tmp_path / name
    d.mkdir(parents=True, exist_ok=True)
    kw.setdefault("emit_records", False)
    kw.setdefault("lanes", 2)
    kw.setdefault("chunk", 8)
    kw.setdefault("buckets", (32,))
    kw.setdefault("out_dir", str(d))
    kw.setdefault("engine_ckpt_interval", 2)
    kw.setdefault("engine_ckpt_dir", str(d / "ckpt"))
    if port:
        return Gateway(Engine(ServeConfig(**kw), device="cpu"), "127.0.0.1",
                       0).start()
    return JGateway(JEngine(JServeConfig(**kw)), "127.0.0.1", 0).start()


def make_router(gws, fcfg=None, port=True):
    spec = ",".join(f"b{i}={gw.address}" for i, gw in enumerate(gws))
    if port:
        reg = BackendRegistry(parse_backends(spec))
        return Router(reg, "127.0.0.1", 0,
                      fcfg or FleetConfig(health_interval_s=0.2)).start()
    reg = JRegistry(jparse_backends(spec))
    return JRouter(reg, "127.0.0.1", 0,
                   fcfg or JFleetConfig(health_interval_s=0.2)).start()


class Fleet:
    """A router over fresh gateways; always torn down."""

    def __init__(self, tmp_path, n=2, fcfg=None, port=True, names=None,
                 **kw):
        self.gws = []
        self.rt = None
        try:
            for i in range(n):
                self.gws.append(make_backend(
                    tmp_path, (names or [f"g{j}" for j in range(n)])[i],
                    port=port, **kw))
            self.rt = make_router(self.gws, fcfg, port=port)
        except BaseException:
            self.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def probed(self):
        assert wait_until(lambda: all(
            b.status is not None for b in self.rt.registry.snapshot())), \
            "the router never probed every backend"

    def close(self):
        if self.rt is not None:
            self.rt.close()
        for gw in self.gws:
            try:
                gw.request_drain()
                gw.wait_drained(TIMEOUT)
            finally:
                gw.close()
                gw.engine.shutdown(timeout=TIMEOUT)


def post_solve(rt, body, headers=(), query="", timeout=TIMEOUT):
    """Streaming POST through the router: (status, records, headers)."""
    conn = http.client.HTTPConnection(rt.host, rt.port, timeout=timeout)
    try:
        conn.request("POST", f"/v1/solve{query}", body=body.encode(),
                     headers=dict(headers))
        resp = conn.getresponse()
        recs = []
        while True:
            raw = resp.readline()
            if not raw:
                break
            raw = raw.strip()
            if raw:
                recs.append(json.loads(raw))
        return resp.status, recs, resp.headers
    finally:
        conn.close()


def get_json(rt, path, timeout=TIMEOUT):
    conn = http.client.HTTPConnection(rt.host, rt.port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def gw_http(gw, method, path, body=None, headers=(), timeout=TIMEOUT):
    host, port = gw.address.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=dict(headers))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def line(**kw):
    return json.dumps(kw) + "\n"


def npz_T(path):
    with np.load(path) as z:
        return z["T"]


def one_npz(tmp_path, rid, dirs=("g0", "g1")):
    paths = [tmp_path / d / f"{rid}.npz" for d in dirs
             if (tmp_path / d / f"{rid}.npz").exists()]
    assert len(paths) == 1, f"{rid}: {len(paths)} npz files"
    return paths[0]


def same_bytes(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# --- routing and bytes -------------------------------------------------------


def test_concurrent_posts_bit_identical_to_direct_solves(tmp_path):
    """Concurrent POSTs spread over both backends; every npz is the
    direct engine solve's bytes and the solo solve's; the fleet's usage,
    metrics and record lookups reconcile."""
    cfgs = {f"r{i}": dict(F64, ntime=48 + 16 * (i % 2), ic="hat",
                          bc="edges", nu=0.05 + 0.05 * (i % 2))
            for i in range(6)}
    results = {}
    with Fleet(tmp_path) as fl:
        rt = fl.rt
        fl.probed()

        def post(ids):
            body = "".join(line(id=i, **cfgs[i]) for i in ids)
            st, recs, _ = post_solve(rt, body)
            for r in recs:
                results[r["id"]] = (st, r)

        threads = [threading.Thread(target=post, args=(ids,))
                   for ids in (["r0", "r1", "r2"], ["r3", "r4", "r5"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        assert set(results) == set(cfgs)
        for st, rec in results.values():
            assert st == 200 and rec["status"] == "ok", rec
        snap = rt.snapshot()
        per_backend = {n: b["delivered"] for n, b in snap["backends"].items()}
        assert sum(per_backend.values()) == 6
        assert all(v > 0 for v in per_backend.values()), per_backend
        _, usage = get_json(rt, "/v1/usage")
        assert usage["kind"] == "heat-tpu-fleet-usage"
        assert usage["totals"]["requests"] == 6
        assert usage["totals"]["steps"] == sum(
            p["totals"]["steps"] for p in usage["per_backend"].values())
        metrics = render_fleet_metrics(rt)
        assert 'heat_tpu_fleet_backend_up{backend="b0"} 1' in metrics
        assert "heat_tpu_fleet_duplicates_dropped_total 0" in metrics
        st, rec = get_json(rt, "/v1/requests/r0")
        assert st == 200 and rec["status"] == "ok"
        assert get_json(rt, "/v1/requests/nope")[0] == 404
        st, status = get_json(rt, "/v1/status")
        assert st == 200 and status["kind"] == "heat-tpu-fleet-status"
    for rid, kw in cfgs.items():
        got = npz_T(one_npz(tmp_path, rid))
        assert same_bytes(got, direct_solve(kw, "cpu"))
        assert same_bytes(got, solve(HeatConfig(**kw), device="cpu").T)


def test_fleet_bytes_equal_the_jax_engine(tmp_path):
    """The fleet's npz files (f64, f32, bf16; 2D and 3D) against the JAX
    engine's for the same requests."""
    reqs = [dict(id="a", n=20, ntime=37, dtype="float32", sigma=0.2),
            dict(id="b", n=17, ntime=29, dtype="bfloat16", bc="ghost"),
            dict(id="c", n=24, ntime=40, dtype="float64", ic="hat_small"),
            dict(id="d", n=9, ntime=21, ndim=3, dtype="float32",
                 sigma=1 / 6)]
    with Fleet(tmp_path) as fl:
        fl.probed()
        st, recs, _ = post_solve(fl.rt, "".join(line(**r) for r in reqs))
        assert st == 200 and all(r["status"] == "ok" for r in recs), recs
    jdir = tmp_path / "jax"
    jdir.mkdir()
    eng = JEngine(JServeConfig(lanes=2, chunk=8, buckets=(32,),
                               emit_records=False, out_dir=str(jdir)))
    from heat_tpu.config import HeatConfig as JHeatConfig

    for r in reqs:
        eng.submit(JHeatConfig(**{k: v for k, v in r.items() if k != "id"}),
                   request_id=r["id"])
    assert all(rec["status"] == "ok" for rec in eng.run())
    for r in reqs:
        ours = one_npz(tmp_path, r["id"])
        assert same_bytes(npz_T(ours), npz_T(jdir / f"{r['id']}.npz")), r


def test_port_router_over_a_jax_and_a_port_gateway(tmp_path):
    """The wire contract: round-robin over one reference gateway and one
    port gateway; both serve, and each returns the same bytes."""
    gws = [make_backend(tmp_path, "g0", port=False),
           make_backend(tmp_path, "g1", port=True)]
    rt = None
    try:
        rt = make_router(gws, FleetConfig(health_interval_s=0.2,
                                          policy="round-robin"))
        assert wait_until(lambda: all(
            b.status is not None for b in rt.registry.snapshot()))
        kw = dict(F64, ntime=40, ic="hat", bc="edges")
        for i in range(4):
            st, recs, _ = post_solve(rt, line(id=f"w{i}", **kw))
            assert st == 200 and recs[-1]["status"] == "ok", recs
        snap = rt.snapshot()
        assert all(b["delivered"] == 2 for b in snap["backends"].values()), \
            snap["backends"]
        # both kinds of status payload feed placement the same fields
        for b in rt.registry.snapshot():
            assert {"backlog", "cost_model", "slo_burn", "mega",
                    "engine_ckpt"} <= set(b.status)
    finally:
        if rt is not None:
            rt.close()
        for gw in gws:
            try:
                gw.request_drain()
                gw.wait_drained(TIMEOUT)
            finally:
                gw.close()
                gw.engine.shutdown(timeout=TIMEOUT)
    ref = direct_solve(kw, "cpu")
    served = {d: [i for i in range(4)
                  if (tmp_path / d / f"w{i}.npz").exists()]
              for d in ("g0", "g1")}
    assert sorted(served["g0"] + served["g1"]) == [0, 1, 2, 3]
    assert served["g0"] and served["g1"]
    for i in range(4):
        assert same_bytes(npz_T(one_npz(tmp_path, f"w{i}")), ref)


# --- router-minted records and /metrics against the reference ----------------

VARYING = ("trace_id",)


def _minted(recs):
    return sorted((json.dumps({k: v for k, v in r.items()
                               if k not in VARYING}, sort_keys=True)
                   for r in recs if r.get("status") != "ok"))


def _edge_traffic(fl):
    """The same sequence through either router: edge rejections, a
    deadline shed, brownout sheds and unroutable rows. Returns every
    router-minted record."""
    rt = fl.rt
    fl.probed()
    minted = []
    body = ('this is not json\n' + line(id="ok1", ntime=16, **F64)
            + line(id="dup", ntime=16, **F64)
            + line(id="dup", ntime=16, **F64)
            + line(id="bad", n=-5, ntime=16) + '["a list"]\n'
            + line(id="neg", ntime=16, deadline_ms=-1, **F64)
            + line(id="cls", ntime=16, **{"class": "bulk"}, **F64))
    st, recs, hdrs = post_solve(rt, body,
                                headers=[("X-Trace-Id", "fleet.parity")])
    assert st == 200 and hdrs["X-Trace-Id"] == "fleet.parity"
    assert sorted(r["id"] for r in recs if r["status"] == "ok") == \
        ["dup", "ok1"]
    minted += recs
    st, recs, _ = post_solve(rt, line(id="d0", ntime=48, tenant="t0",
                                      deadline_ms=0.001, **F64))
    minted += recs
    # brownout: every backend burns in both windows
    for burn, ids in ((1.4, ("bt0", "sd0")), (2.5, ("bt1", "sd1"))):
        worse = {"mega": {"max_bucket": 64},
                 "slo_burn": {"interactive": {"fast_burn": burn,
                                              "slow_burn": 1.2}}}
        for b in rt.registry.snapshot():
            rt.registry.note_probe(b.name, True, status=worse)
        for rid in ids:
            cls = "batch" if rid.startswith("bt") else "standard"
            st, recs, _ = post_solve(rt, line(id=rid, ntime=16,
                                              **{"class": cls}, **F64))
            minted += recs
    # unroutable: every backend down
    for b in rt.registry.snapshot():
        rt.registry.set_fault_down(b.name)
    st, recs, _ = post_solve(rt, line(id="x", ntime=16, **F64))
    minted += recs
    return minted


def test_edge_records_and_metrics_equal_the_jax_router(tmp_path):
    """Rejections at the edge, a deadline shed, brownout sheds and an
    unroutable row: the port router's records equal the reference
    router's field for field, trace ids aside; ``/metrics`` has the same
    families (name, type, help, label keys) and the same counts."""
    outs, metrics = {}, {}
    for port in (True, False):
        with Fleet(tmp_path / ("port" if port else "jax"), port=port,
                   fcfg=(FleetConfig if port else JFleetConfig)(
                       health_interval_s=30.0)) as fl:
            fl.rt.registry.refresh_file()
            for b in fl.rt.registry.snapshot():
                ok = gw_http(fl.gws[int(b.name[1:])], "GET", "/v1/status")
                fl.rt.registry.note_probe(b.name, True,
                                          status=json.loads(ok[1]))
            outs[port] = _minted(_edge_traffic(fl))
            metrics[port] = (render_fleet_metrics if port
                             else jrender_metrics)(fl.rt)
    assert outs[True] == outs[False]
    assert len(outs[True]) == 11

    def families(text):
        fam, samples = {}, {}
        for ln in text.splitlines():
            if ln.startswith("# HELP "):
                _, _, name, helptext = ln.split(" ", 3)
                fam.setdefault(name, {})["help"] = helptext
            elif ln.startswith("# TYPE "):
                _, _, name, mtype = ln.split()
                fam.setdefault(name, {})["type"] = mtype
            elif ln:
                key, value = ln.rsplit(" ", 1)
                name, _, labels = key.partition("{")
                keys = tuple(sorted(kv.split("=")[0]
                                    for kv in labels.rstrip("}").split(",")
                                    if kv))
                fam[name].setdefault("labels", set()).add(keys)
                samples[key] = value
        return fam, samples

    (pf, ps), (jf, js) = families(metrics[True]), families(metrics[False])
    assert pf == jf
    timed = ("heat_tpu_fleet_uptime_seconds",
             "heat_tpu_fleet_backend_backlog_seconds",
             "heat_tpu_fleet_retry_budget_remaining")
    assert {k: v for k, v in ps.items() if not k.startswith(timed)} == \
        {k: v for k, v in js.items() if not k.startswith(timed)}


def test_router_healthz_drain_and_unroutable(tmp_path):
    """healthz follows the backends, /drainz stops admission with 503,
    and an all-down fleet answers a structured unroutable record."""
    with Fleet(tmp_path, n=1) as fl:
        rt = fl.rt
        st, h = get_json(rt, "/healthz")
        assert st == 200 and h["backends_up"] == 1
        rt.registry.set_fault_down("b0")
        st, recs, _ = post_solve(rt, line(id="x", ntime=16, **F64))
        (rec,) = recs
        assert st == 200 and rec["status"] == "rejected"
        assert rec["error"].startswith("unroutable: no eligible backend")
        rt.registry.set_fault_down("b0", False)
        st, d = get_json(rt, "/drainz")
        assert st == 200 and d["draining"]
        assert get_json(rt, "/healthz")[0] == 503
        st, _, hdrs = post_solve(rt, line(id="late", ntime=16, **F64))
        assert st == 503 and hdrs["Retry-After"] == "1"
        assert "DRAINING" in render_fleet_statusz(rt)


# --- chaos -------------------------------------------------------------------


def test_backend_down_retries_on_alternate_and_flight_dumps(tmp_path):
    """backend-down@4 drops a backend's TCP target mid-dispatch: its
    never-admitted batch retries on the alternate, every request comes
    back ok and byte-equal, and the loss flight-dumps the fleet
    timeline."""
    fcfg = FleetConfig(health_interval_s=0.2, inject="backend-down@4",
                       flightrec_dir=str(tmp_path))
    kw = dict(F64, ntime=48)
    with Fleet(tmp_path, fcfg=fcfg) as fl:
        rt = fl.rt
        fl.probed()
        body = "".join(line(id=f"k{i}", **kw) for i in range(6))
        st, recs, _ = post_solve(rt, body)
        assert st == 200
        assert {r["id"]: r["status"] for r in recs} == \
            {f"k{i}": "ok" for i in range(6)}
        snap = rt.snapshot()
        downed = [n for n, b in snap["backends"].items() if b["fault_down"]]
        assert len(downed) == 1
        survivor = [n for n in snap["backends"] if n not in downed][0]
        assert snap["backends"][survivor]["delivered"] == 6
        assert snap["router"]["duplicates"] == 0
        assert wait_until(lambda: rt.tracer.dumps >= 1)
        assert wait_until(lambda: rt.snapshot()["backends"][downed[0]]["lost"])
        assert list(tmp_path.glob("flightrec-*.trace.json"))
    ref = direct_solve(kw, "cpu")
    for i in range(6):
        assert same_bytes(npz_T(one_npz(tmp_path, f"k{i}")), ref)


def test_stream_cut_redrive_is_exactly_once(tmp_path):
    """stream-cut@2 severs the relay to a live b0 after two records: the
    re-drive polls b0 for the admitted rows, none lost or duplicated."""
    fcfg = FleetConfig(health_interval_s=0.2,
                       inject="stream-cut@2:backend=b0",
                       cut_redrive_wait_s=20.0)
    kw = dict(F64, ntime=48)
    with Fleet(tmp_path, fcfg=fcfg) as fl:
        rt = fl.rt
        fl.probed()
        body = "".join(line(id=f"c{i}", **kw) for i in range(6))
        st, recs, _ = post_solve(rt, body)
        assert st == 200
        assert sorted(r["id"] for r in recs) == [f"c{i}" for i in range(6)]
        assert all(r["status"] == "ok" for r in recs), recs
        snap = rt.snapshot()
        if snap["backends"]["b0"]["routed"] >= 3:
            assert snap["router"]["stream_cuts"] >= 1
        assert snap["router"]["duplicates"] == 0
    ref = direct_solve(kw, "cpu")
    for i in range(6):
        assert same_bytes(npz_T(one_npz(tmp_path, f"c{i}")), ref)


def test_flapping_backend_breaker_opens_then_canary_readmits(tmp_path):
    """backend-flap takes b1 down for one pulse: the breaker opens, the
    wave lands on b0, no steal fires while breakers move, and b1 comes
    back only through the half-open canary solved through the router
    path."""
    fcfg = FleetConfig(health_interval_s=0.2,
                       inject="backend-flap:period=700:backend=b1",
                       breaker_cooldown_s=0.4, steal_threshold_s=0.001,
                       steal_cooldown_s=2.0, flightrec_dir=str(tmp_path))
    kw = dict(F64, ntime=48)
    with Fleet(tmp_path, fcfg=fcfg, buckets=(32, 64)) as fl:
        rt = fl.rt
        assert wait_until(lambda: rt.registry.get("b1").fault_down)
        assert wait_until(lambda: rt.registry.get("b1").lost)
        body = "".join(line(id=f"f{i}", **kw) for i in range(4))
        st, recs, _ = post_solve(rt, body)
        assert st == 200
        assert {r["id"]: r["status"] for r in recs} == \
            {f"f{i}": "ok" for i in range(4)}
        assert rt.snapshot()["backends"]["b0"]["delivered"] == 4
        assert wait_until(lambda: rt.snapshot()["router"]["breakers"]
                          .get("b1", {}).get("state") == "closed")
        assert wait_until(lambda: (lambda b: b["healthy"] and not b["lost"])(
            rt.snapshot()["backends"]["b1"]))
        snap = rt.snapshot()
        assert snap["router"]["breakers"]["b1"]["transitions"] >= 3
        assert snap["router"]["steals"] == []
        metrics = render_fleet_metrics(rt)
        assert 'heat_tpu_fleet_breaker_state{backend="b1"} 0' in metrics
    ref = direct_solve(kw, "cpu")
    for i in range(4):
        assert same_bytes(npz_T(tmp_path / "g0" / f"f{i}.npz"), ref)


# --- work stealing as checkpoint handoff -------------------------------------


def test_steal_migrates_checkpointed_work_bit_identically(tmp_path):
    """Load b0 through the router, join an idle b1 through the backends
    file, and steal once b0 has published a checkpoint with work still
    pending: b0 drains to its manifest, b1 resumes it, every request ends
    ok, and every npz is the unmigrated solve's bytes."""
    g0 = make_backend(tmp_path, "g0")
    g1 = make_backend(tmp_path, "g1")
    rt = None
    kw = dict(F64, ntime=96)
    try:
        bfile = tmp_path / "backends.txt"
        bfile.write_text(f"b0={g0.address}\n")
        reg = BackendRegistry(backends_file=bfile)
        rt = Router(reg, "127.0.0.1", 0,
                    FleetConfig(health_interval_s=0.15)).start()
        assert wait_until(lambda: reg.get("b0").status is not None)
        gen0 = reg.get("b0").status["engine_ckpt"]["generation"]
        body = "".join(line(id=f"s{i}", inject="sink-slow:ms=400", **kw)
                       for i in range(6))
        st, accept, _ = post_solve(rt, body, query="?wait=0")
        assert st == 202 and len(accept[0]["accepted"]) == 6

        def midflight():
            s = reg.get("b0").status or {}
            return (s.get("engine_ckpt", {}).get("generation", 0) > gen0
                    and rt.pending_count() >= 3)

        assert wait_until(midflight), reg.get("b0").status
        bfile.write_text(f"b0={g0.address}\nb1={g1.address}\n")
        assert wait_until(lambda: reg.get("b1") is not None
                          and reg.get("b1").status is not None)
        ev = rt.steal("b0", "b1", reason="test")
        assert ev is not None and ev["thief"] == "b1"
        assert ev["generation"] > gen0
        assert ev["recovered"] >= 1, ev
        assert wait_until(lambda: rt.pending_count() == 0), rt.snapshot()
        for i in range(6):
            st, rec = get_json(rt, f"/v1/requests/s{i}")
            assert st == 200 and rec["status"] == "ok", rec
        assert wait_until(lambda: (reg.get("b1").status or {}).get(
            "serve_resumed", 0) >= 1)
        snap = rt.snapshot()
        assert snap["backends"]["b0"]["lost"]
        assert snap["router"]["duplicates"] == 0
        assert reg.get("b0").stolen_from == 1
        assert reg.get("b1").stolen_to == 1
        assert "b0 -> b1 [test]" in render_fleet_statusz(rt)
        assert 'heat_tpu_fleet_steals_total{backend="b0"} 1' in \
            render_fleet_metrics(rt)
    finally:
        if rt is not None:
            rt.close()
        for gw in (g0, g1):
            try:
                gw.request_drain()
                gw.wait_drained(TIMEOUT)
            finally:
                gw.close()
                gw.engine.shutdown(timeout=TIMEOUT)
    ref = direct_solve(kw, "cpu")
    for i in range(6):
        paths = [p for p in (tmp_path / "g0" / f"s{i}.npz",
                             tmp_path / "g1" / f"s{i}.npz") if p.exists()]
        assert paths, f"s{i}: npz missing"
        for p in paths:
            assert same_bytes(npz_T(p), ref)


# --- the shared cache, hedging, deadlines, brownout, mega ---------------------


def test_shared_cache_edge_hit_reconciles(tmp_path):
    """With a shared cache dir the router serves a repeat at the edge
    (placement ``fleet-cache``, no backend touched), billed to the
    pseudo-backend ``_edge``, and the fleet usage still sums its parts."""
    cache_dir = tmp_path / "solve-cache"
    fcfg = FleetConfig(health_interval_s=0.2, cache_dir=str(cache_dir))
    with Fleet(tmp_path, fcfg=fcfg, cache=True,
               cache_dir=str(cache_dir)) as fl:
        rt = fl.rt
        kw = dict(F64, ntime=48, ic="hat", bc="edges")
        st, recs, _ = post_solve(rt, line(id="c0", **kw))
        assert st == 200 and recs[-1]["status"] == "ok"
        assert recs[-1]["cached"] is False
        assert wait_until(lambda: list(cache_dir.glob("*.npz")))
        st, recs, _ = post_solve(rt, line(id="c1", **kw))
        (rec,) = [r for r in recs if r.get("id") == "c1"]
        assert rec["status"] == "ok" and rec["cached"] is True
        assert rec["placement"] == "fleet-cache" and rec["exit"] == "cached"
        assert rec["usage"]["steps"] == 0
        assert rec["usage"]["steps_saved"] == 48
        _, usage = get_json(rt, "/v1/usage")
        assert usage["per_backend"]["_edge"]["totals"]["cached"] == 1
        assert usage["totals"]["requests"] == 2
        assert usage["totals"]["steps"] == sum(
            p["totals"]["steps"] for p in usage["per_backend"].values())
        snap = rt.snapshot()
        assert snap["router"]["cache_edge_hits"] == 1
        assert snap["cache"]["readonly"] is True
        assert "heat_tpu_fleet_cache_edge_hits_total 1" in \
            render_fleet_metrics(rt)
        st, rec2 = get_json(rt, "/v1/requests/c1")
        assert st == 200 and rec2["placement"] == "fleet-cache"
        assert same_bytes(npz_T(rec["path"]), direct_solve(kw, "cpu"))


def test_hedged_interactive_row_wins_on_idle_backend(tmp_path):
    """b1 is loaded outside the router, round-robin sends the interactive
    row there, and its hedge twin on b0 (tenant ``_hedge``) wins: one ok
    record flagged ``hedged``, the real tenant billed once, the twin's
    bytes the direct solve's."""
    fcfg = FleetConfig(health_interval_s=0.1, policy="round-robin",
                       hedge_factor=0.01, hedge_floor_s=0.3)
    kw = dict(F64, ntime=48)
    with Fleet(tmp_path, fcfg=fcfg) as fl:
        rt = fl.rt
        fl.probed()
        heavy = "".join(line(id=f"h{i}", ntime=96, tenant="bulk",
                             inject="sink-slow:ms=1000", **F64)
                        for i in range(4))
        st, _ = gw_http(fl.gws[1], "POST", "/v1/solve?wait=0",
                        body=heavy.encode())
        assert st == 202
        st, recs, _ = post_solve(rt, line(id="i0", tenant="acme",
                                          **{"class": "interactive"}, **kw))
        assert st == 200
        (rec,) = [r for r in recs if r["id"] == "i0"]
        assert rec["status"] == "ok" and rec.get("hedged") is True, rec
        snap = rt.snapshot()
        assert snap["router"]["hedges"]["fired"] == 1
        assert snap["router"]["hedges"]["won"] == 1
        assert wait_until(lambda: "_hedge" in rt.fleet_usage()["tenants"])
        usage = rt.fleet_usage()
        acme = usage["tenants"].get("acme", {"classes": {}})
        assert acme["classes"].get("interactive", {}).get("requests", 0) <= 1
        assert 'heat_tpu_fleet_hedges_total{outcome="won"} 1' in \
            render_fleet_metrics(rt)
    twin = tmp_path / "g0" / "i0~hedge.npz"
    assert twin.exists()
    assert same_bytes(npz_T(twin), direct_solve(kw, "cpu"))


def test_deadline_propagates_from_edge_to_backend(tmp_path):
    """A spent edge-minted budget sheds at placement (never dispatched,
    never billed); a gateway refuses a spent ``X-Deadline-Ms`` with 504
    and a bad one with 400; a live budget rides the relay and
    completes."""
    with Fleet(tmp_path) as fl:
        rt = fl.rt
        fl.probed()
        st, recs, _ = post_solve(rt, line(id="d0", ntime=48, tenant="t0",
                                          deadline_ms=0.001, **F64))
        (rec,) = recs
        assert st == 200 and rec["status"] == "deadline"
        assert "placement" in rec["error"]
        assert "zero device steps" in rec["error"]
        snap = rt.snapshot()
        assert snap["router"]["deadline_shed"] == 1
        assert sum(b["routed"] for b in snap["backends"].values()) == 0
        assert "t0" not in rt.fleet_usage()["tenants"]
        st, data = gw_http(fl.gws[0], "POST", "/v1/solve",
                           body=line(id="x0", ntime=16, **F64).encode(),
                           headers=[("X-Deadline-Ms", "0")])
        assert st == 504 and "deadline" in json.loads(data)["error"]
        st, _ = gw_http(fl.gws[0], "POST", "/v1/solve",
                        body=line(id="x1", ntime=16, **F64).encode(),
                        headers=[("X-Deadline-Ms", "not-a-number")])
        assert st == 400
        st, recs, _ = post_solve(rt, line(id="d1", ntime=48,
                                          deadline_ms=60000, **F64))
        assert st == 200 and recs[-1]["status"] == "ok"


def test_brownout_sheds_batch_then_standard_never_interactive(tmp_path):
    """Every backend burning in both windows: level 1 sheds batch, level 2
    standard too; interactive is never shed."""
    with Fleet(tmp_path, fcfg=FleetConfig(health_interval_s=30.0)) as fl:
        rt = fl.rt

        def burn(fast):
            for name in ("b0", "b1"):
                rt.registry.note_probe(name, True, status={
                    "mega": {"max_bucket": 64},
                    "slo_burn": {"interactive": {"fast_burn": fast,
                                                 "slow_burn": 1.2}}})

        def one(rid, cls):
            st, recs, _ = post_solve(rt, line(id=rid, ntime=16,
                                              **{"class": cls}, **F64))
            assert st == 200
            return recs[-1]

        burn(1.4)
        assert rt.snapshot()["brownout_level"] == 1
        rec = one("bt0", "batch")
        assert rec["status"] == "rejected" and "level 1" in rec["error"]
        assert rec["retry_after_s"] > 0
        assert one("sd0", "standard")["status"] == "ok"
        assert one("it0", "interactive")["status"] == "ok"
        burn(2.5)
        assert rt.snapshot()["brownout_level"] == 2
        assert one("bt1", "batch")["status"] == "rejected"
        rec = one("sd1", "standard")
        assert rec["status"] == "rejected" and "level 2" in rec["error"]
        assert one("it1", "interactive")["status"] == "ok"
        assert rt.snapshot()["router"]["brownout_shed"] == 3
        assert "BROWNOUT" in render_fleet_statusz(rt)


def test_oversized_request_routes_only_to_the_mega_backend(tmp_path):
    """A request over every bucket lands only on the backend whose status
    says mega-capable; its bytes equal a direct mega-lane solve."""
    gws = [make_backend(tmp_path, "g0", mega_lanes=0),
           make_backend(tmp_path, "g1", mega_lanes=1)]
    rt = None
    kw = dict(n=48, ntime=40, dtype="float32", bc="edges", ic="hat")
    try:
        rt = make_router(gws)
        assert wait_until(lambda: all(
            b.status is not None for b in rt.registry.snapshot()))
        assert [b.status["mega"]["capable"]
                for b in rt.registry.snapshot()] == [False, True]
        for i in range(3):
            st, recs, _ = post_solve(rt, line(id=f"m{i}", **kw))
            assert st == 200 and recs[-1]["status"] == "ok", recs
            assert recs[-1]["placement"] == "mega"
        snap = rt.snapshot()
        assert snap["backends"]["b0"]["routed"] == 0
        assert snap["backends"]["b1"]["delivered"] == 3
        assert snap["backends"]["b1"]["mega_capable"]
        assert "mega" in render_fleet_statusz(rt)
    finally:
        if rt is not None:
            rt.close()
        for gw in gws:
            try:
                gw.request_drain()
                gw.wait_drained(TIMEOUT)
            finally:
                gw.close()
                gw.engine.shutdown(timeout=TIMEOUT)
    eng = Engine(ServeConfig(lanes=1, chunk=8, buckets=(32,), mega_lanes=1,
                             emit_records=False), device="cpu")
    eng.submit(HeatConfig(**kw), request_id="direct")
    (want,) = eng.run()
    for i in range(3):
        assert same_bytes(npz_T(tmp_path / "g1" / f"m{i}.npz"), want["T"])


class _StallingBackend:
    """A backend that admits one POST, streams the first request's record
    and then nothing more until ``close``; every later connection (the
    router's liveness probe) is reset."""

    def __init__(self):
        import socket

        self.srv = socket.create_server(("127.0.0.1", 0))
        self.address = "127.0.0.1:%d" % self.srv.getsockname()[1]
        self.release = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        first = True
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            if not first:
                c.close()
                continue
            first = False
            threading.Thread(target=self._stream, args=(c,),
                             daemon=True).start()

    def _stream(self, c):
        import re

        with c:
            c.settimeout(TIMEOUT)
            data = b""
            while b"\r\n\r\n" not in data:
                data += c.recv(65536)
            head, _, body = data.partition(b"\r\n\r\n")
            n = int(re.search(rb"content-length: *(\d+)", head,
                              re.I).group(1))
            while len(body) < n:
                body += c.recv(65536)
            rid = json.loads(body.splitlines()[0])["id"]
            rec = json.dumps({"id": rid, "status": "ok"}).encode() + b"\n"
            c.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: "
                      b"application/x-ndjson\r\nTransfer-Encoding: "
                      b"chunked\r\n\r\n%x\r\n%s\r\n" % (len(rec), rec))
            self.release.wait(TIMEOUT)

    def close(self):
        import socket

        self.release.set()
        try:
            self.srv.shutdown(socket.SHUT_RDWR)   # wakes the accept
        except OSError:
            pass
        self.srv.close()
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive()


def test_breaking_an_idle_relay_returns_at_once(tmp_path):
    """A relay parked in a read of a stream that sends nothing more (a
    backend whose admitted work will not finish there: a steal's victim
    after its handoff drain): ``_close_relays`` ends it at once, and the
    orphan goes to recovery. Closing the response instead, as the
    reference's router does, waits for the buffered reader's lock that
    the parked read holds, so for the backend's next byte (up to the
    600 s stream timeout)."""
    be = _StallingBackend()
    rt = None
    try:
        rt = Router(BackendRegistry(parse_backends(f"b0={be.address}")),
                    "127.0.0.1", 0,
                    FleetConfig(health_interval_s=30.0,
                                flightrec_dir=str(tmp_path))).start()
        out = {}
        poster = threading.Thread(target=lambda: out.update(
            recs=post_solve(rt, line(id="a", ntime=16, **F64)
                            + line(id="b", ntime=16, **F64))[1]))
        poster.start()
        assert wait_until(lambda: "a" in rt._requests
                          and rt._requests["a"]["delivered"])
        breaker = threading.Thread(target=rt._close_relays, args=("b0",))
        t0 = time.monotonic()
        breaker.start()
        breaker.join(10)
        assert not breaker.is_alive(), "_close_relays waited on the read"
        assert time.monotonic() - t0 < 10
        poster.join(TIMEOUT)
        assert not poster.is_alive()
        recs = {r["id"]: r for r in out["recs"]}
        assert recs["a"]["status"] == "ok"
        assert recs["b"]["status"] == "rejected"
        assert recs["b"]["error"].startswith("unroutable:")
        assert wait_until(lambda: rt.snapshot()["backends"]["b0"]["lost"])
    finally:
        if rt is not None:
            rt.close()
        be.close()
