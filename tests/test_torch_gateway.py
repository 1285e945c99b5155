"""The HTTP gateway and the canary prober of the port against heat_tpu's.

The same NDJSON body and the same sequence of calls go to a port
``Gateway`` (engine on the CPU) and to the reference's, each bound to
``127.0.0.1:0``. Status codes, the ``X-Trace-Id`` and ``Retry-After``
headers, the streamed records (time-valued keys aside), ``/metrics``
names, types and labels, and every counter value must agree. Left out:
``heat_tpu_build_info`` (it names torch and the device where the
reference names jax), the ``kernel`` label's value (the chunk body:
``torch`` here, ``xla`` there), the time-valued samples (uptime, boundary
wait, lane-seconds, latency, seconds per lane-step, compile seconds), and
the compile counters (the reference compiles a program per chunk size;
the port builds none). Both engines run with ``mega_lanes=0`` and the
port's ``mega_device_count`` sees the reference's 8 CPU devices, so a
bucket-overflow rejection carries the reference's whole reason and
``hint``. Every client call has a timeout, every drain a deadline, and
every server is closed in a ``finally``.
"""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu.serve.gateway import Gateway as JGateway
from heat_tpu_torch import cli
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.runtime import checkpoint as ckpt
from heat_tpu_torch.serve import Engine, ServeConfig
from heat_tpu_torch.serve import scheduler as sch
from heat_tpu_torch.serve.gateway import Gateway, render_metrics
from heat_tpu_torch.serve.probe import Prober, expected_probe_field

torch.set_num_threads(1)
_REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 60

LINES = [dict(id="a", n=12, ntime=37),
         dict(id="b", n=9, ntime=20, dtype="bfloat16", bc="ghost",
              tenant="t2"),
         dict(id="c", n=40, ntime=3),             # overflow: rejected
         dict(id="d", n=7, ntime=9, ndim=3, sigma=1 / 6)]
BODY = "\n".join([json.dumps(r) for r in LINES] + ["not json", ""])
TIME_VALUED = ("heat_tpu_process_uptime_seconds",
               "heat_tpu_serve_boundary_wait_seconds_total",
               "heat_tpu_usage_lane_seconds_total",
               "heat_tpu_serve_request_latency_seconds",
               "heat_tpu_serve_cost_s_per_lane_step",
               "heat_tpu_compile_seconds_total",
               "heat_tpu_compile_programs_total",
               "heat_tpu_serve_step_compiles_total",
               "heat_tpu_probe_last_latency_seconds",
               "heat_tpu_probe_last_error_norm",
               "heat_tpu_mem_")
RECORD_TIME_KEYS = ("queue_wait_s", "solve_s", "steps_per_s", "trace_id",
                    "usage")


def _engine(port: bool, **kw):
    kw = dict(dict(lanes=2, chunk=8, buckets=(16,), emit_records=False,
                   mega_lanes=0), **kw)
    if port:
        return Engine(ServeConfig(**kw), device="cpu")
    return JEngine(JServeConfig(**kw))


def _call(base, path, data=None, method=None, headers=None):
    """(status, headers, body text) of one request; HTTP errors too."""
    req = urllib.request.Request(f"{base}{path}", data=data,
                                 method=method or ("POST" if data is not None
                                                   else "GET"),
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


class _Served:
    """A gateway over a fresh engine, always drained and closed."""

    def __init__(self, port: bool, start_engine=True, **kw):
        self.eng = _engine(port, **kw)
        cls = Gateway if port else JGateway
        self.gw = cls(self.eng, "127.0.0.1", 0,
                      start_engine=start_engine).start()
        self.base = f"http://{self.gw.address}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.gw.request_drain()
            assert self.gw.wait_drained(TIMEOUT)
        finally:
            self.gw.close()
            self.eng.shutdown(timeout=TIMEOUT)


def _parse_metrics(text):
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            _, _, name, mtype = line.split()
            types[name] = mtype
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            samples[key.replace('kernel="xla"', 'kernel="torch"')] = value
    return types, samples


def _session(port: bool, tmp_path):
    """One fixed sequence of calls; returns what each answered. The
    engine starts once the streamed body's lines are all submitted, so
    both engines size their lane tiers from the same queue (an engine
    already running would admit the lines as they arrive)."""
    out = {}
    with _Served(port, start_engine=False) as s:
        answer = {}
        post = threading.Thread(target=lambda: answer.update(
            solve=_call(s.base, "/v1/solve", BODY.encode())))
        post.start()
        for _ in range(6000):
            if len(s.eng._records) >= len(LINES) or not post.is_alive():
                break
            threading.Event().wait(0.01)
        s.eng.start()
        post.join(TIMEOUT)
        assert not post.is_alive()
        st, hd, body = answer["solve"]
        out["solve"] = (st, hd, [json.loads(ln) for ln in body.splitlines()])
        calls = [("healthz", "/healthz", None),
                 ("rec", "/v1/requests/a", None),
                 ("field", "/v1/requests/a?field=1", None),
                 ("unknown", "/v1/requests/zz", None),
                 ("noroute", "/nope", None),
                 ("noroute_post", "/nope", b"{}"),
                 ("cancel_done", "/v1/cancel", b'{"id": "a"}'),
                 ("cancel_bad", "/v1/cancel", b"[]"),
                 ("empty", "/v1/solve", b"\n"),
                 ("nowait", "/v1/solve?wait=0",
                  json.dumps(dict(id="w", n=8, ntime=4)).encode()),
                 ("resume_bad", "/v1/resume", b"{}"),
                 ("resume_none", "/v1/resume",
                  json.dumps({"dir": str(tmp_path / "none")}).encode()),
                 ("tracez", "/tracez", None),
                 ("statusz", "/statusz", None)]
        for name, path, data in calls:
            out[name] = _call(s.base, path, data,
                              headers={"X-Trace-Id": "client-7"}
                              if name == "healthz" else None)
        assert s.eng.wait("w", timeout=TIMEOUT)["status"] == "ok"
        out["usage"] = _call(s.base, "/v1/usage")
        out["status"] = _call(s.base, "/v1/status")
        out["metrics"] = _call(s.base, "/metrics")
        out["drainz"] = _call(s.base, "/drainz", b"")
        out["after_drain"] = _call(s.base, "/v1/solve", BODY.encode())
        out["healthz_draining"] = _call(s.base, "/healthz")
    return out


def test_every_route_answers_like_the_reference(tmp_path, monkeypatch):
    # the reference's mesh: conftest's 8 CPU devices
    monkeypatch.setattr(sch, "mega_device_count", lambda device: 8)
    got, want = _session(True, tmp_path), _session(False, tmp_path)
    for name in got:
        assert got[name][0] == want[name][0], name
        assert "X-Trace-Id" in got[name][1], name
    assert got["solve"][0] == 200
    assert got["healthz"][1]["X-Trace-Id"] == "client-7"
    recs_p = {r.get("id"): r for r in got["solve"][2]}
    recs_j = {r.get("id"): r for r in want["solve"][2]}
    assert sorted(recs_p, key=str) == sorted(recs_j, key=str)
    for rid, r in recs_p.items():
        for k in set(r) | set(recs_j[rid]):
            if k not in RECORD_TIME_KEYS:
                assert r.get(k) == recs_j[rid].get(k), (rid, k)
    assert recs_p["c"]["hint"] == "enable --mega-lanes"
    # the solve response names the minted trace ids, one per submitted line
    tids = got["solve"][1]["X-Trace-Id"].split(",")
    assert sorted(tids) == sorted(r["trace_id"] for r in recs_p.values()
                                  if r.get("trace_id"))
    assert got["unknown"][0] == 404 and got["rec"][0] == 200
    assert json.loads(got["rec"][2])["trace_id"] == got["rec"][1][
        "X-Trace-Id"]
    field = json.loads(got["field"][2])["T"]
    assert len(field) == 12 and len(field[0]) == 12
    assert json.loads(got["cancel_done"][2]) == {"id": "a",
                                                 "cancelled": False}
    assert got["nowait"][0] == 202
    assert json.loads(got["resume_none"][2])["generation"] == 0
    chrome = json.loads(got["tracez"][2])
    assert chrome["traceEvents"] and chrome["displayTimeUnit"] == "ms"
    assert got["statusz"][2].startswith("heat_tpu_torch serving engine")
    usage = json.loads(got["usage"][2])
    assert usage["totals"]["requests"] == json.loads(want["usage"][2])[
        "totals"]["requests"] == 5
    for k in ("steps", "chunks", "bytes_written", "steps_saved", "cached"):
        assert usage["totals"][k] == json.loads(want["usage"][2])[
            "totals"][k], k
    status = json.loads(got["status"][2])
    assert status["kind"] == "heat-tpu-engine-status"
    assert status["mega"]["lanes"] == 0
    assert got["after_drain"][0] == 503
    assert got["after_drain"][1]["Retry-After"] == "1"
    assert got["healthz_draining"][0] == 503

    tp, sp = _parse_metrics(got["metrics"][2])
    tj, sj = _parse_metrics(want["metrics"][2])
    assert tp == tj
    assert "heat_tpu_serve_mega_lanes" in tp
    keys_p = {k for k in sp if not k.startswith("heat_tpu_build_info")}
    keys_j = {k for k in sj if not k.startswith("heat_tpu_build_info")}
    assert keys_p == keys_j
    for k in keys_p:
        if not k.startswith(TIME_VALUED):
            assert sp[k] == sj[k], (k, sp[k], sj[k])
    (info,) = [k for k in sp if k.startswith("heat_tpu_build_info")]
    assert f'torch="{torch.__version__}"' in info and 'device="cpu"' in info


def test_shedding_answers_429_with_retry_after():
    for port in (True, False):
        with _Served(port, start_engine=False, max_queue=1) as s:
            cfg = (HeatConfig if port else __import__(
                "heat_tpu.config", fromlist=["HeatConfig"]).HeatConfig)
            s.eng.submit(cfg(n=8, ntime=4), request_id="fill")
            st, hd, body = _call(s.base, "/v1/solve",
                                 json.dumps(dict(id="x", n=8,
                                                 ntime=4)).encode())
            assert st == 429 and hd["Retry-After"] == "1", port
            assert "X-Trace-Id" in hd
            assert json.loads(body)["records"][0]["error"].startswith(
                "overloaded:")
            s.eng.start()


def test_handoff_drainz_then_v1_resume_into_a_live_engine(tmp_path):
    """Requests far too long to finish are handed off mid-flight (the
    checkpoint carries the steps already done), adopted by a live engine
    through ``POST /v1/resume`` (marked ``resumed``), then cancelled
    there."""
    ck = tmp_path / "ck"
    with _Served(True, engine_ckpt_dir=str(ck)) as s:
        st, _, _ = _call(s.base, "/v1/solve?wait=0", "\n".join(
            json.dumps(dict(id=f"r{i}", n=12, ntime=200000))
            for i in range(3)).encode())
        assert st == 202
        for _ in range(6000):
            if s.eng.summary()["chunks_dispatched"] >= 6:
                break
            threading.Event().wait(0.01)
        st, _, body = _call(s.base, "/drainz?handoff=1", b"")
        assert st == 200 and json.loads(body)["handoff"] is True
        assert s.gw.wait_drained(TIMEOUT)
        # two lanes: two in flight, one queued; none finished
        assert sorted(s.eng.poll(f"r{i}")["status"] for i in range(3)) == [
            "queued", "running", "running"]
    man, _ = ckpt.latest_engine_manifest(ck)
    assert len(man["inflight"]) == 2 and len(man["queued"]) == 1
    assert all(e["steps_done"] > 0 for e in man["inflight"])
    with _Served(True, out_dir=str(tmp_path / "out")) as s:
        st, _, body = _call(s.base, "/v1/resume",
                            json.dumps({"dir": str(ck)}).encode())
        detail = json.loads(body)
        assert st == 200 and sorted(detail["recovered"]) == [
            "r0", "r1", "r2"]
        for rid in detail["recovered"]:
            assert s.eng.poll(rid)["resumed"] is True
            st, _, body = _call(s.base, "/v1/cancel",
                                json.dumps({"id": rid}).encode())
            assert json.loads(body) == {"id": rid, "cancelled": True}
            rec = s.eng.wait(rid, timeout=TIMEOUT)
            assert rec["status"] == "deadline" and rec["resumed"] is True


def test_prober_verifies_through_the_port_gateway():
    with _Served(True) as s:
        prober = Prober(s.base, interval_s=3600, timeout_s=TIMEOUT,
                        request={"n": 14, "ntime": 60})
        s.eng.prober = prober
        verdict = prober.run_once()
        assert verdict["ok"], verdict
        assert verdict["error_norm"] < 1e-3
        text = render_metrics(s.eng)
        assert 'heat_tpu_probe_runs_total{result="pass"} 1' in text
        assert prober.stats()["consecutive_failures"] == 0
        rec = s.eng.poll("_probe-0001")
        assert rec["tenant"] == "_probe" and rec["class"] == "batch"
    T = expected_probe_field({"n": 8, "ntime": 3, "ic": "sine"})
    assert T.shape == (8, 8)


def test_serve_listen_cli_end_to_end(tmp_path):
    req = tmp_path / "req.jsonl"
    req.write_text(json.dumps(dict(id="pre", n=10, ntime=12)) + "\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "heat_tpu_torch", "serve", "--listen",
         "127.0.0.1:0", "--device", "cpu", "--requests", str(req),
         "--buckets", "16,64", "--out-dir", str(tmp_path / "out"),
         "--probe-interval", "0.2", "--json"],
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin"})
    lines, ready = [], threading.Event()

    def drain():
        # the preloaded request may finish (and print its record) before
        # the listening line; read everything, so the pipe never fills
        for ln in proc.stdout:
            lines.append(ln)
            if "gateway listening on http://" in ln:
                ready.set()
        ready.set()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        assert ready.wait(TIMEOUT), "the gateway did not come up"
        (line,) = [ln for ln in lines if "gateway listening on http://" in ln]
        base = f"http://{line.split('http://')[1].split()[0]}"
        rec = None
        def status(rid):
            return json.loads(_call(base, f"/v1/requests/{rid}")[2]).get(
                "status")

        # the preloaded request, then the first probe, each within TIMEOUT
        for rid in ("pre", "_probe-0001"):
            deadline = time.monotonic() + TIMEOUT
            while status(rid) != "ok" and time.monotonic() < deadline:
                time.sleep(0.05)
            assert status(rid) == "ok", rid
        assert _call(base, "/drainz", b"")[0] == 200
        proc.wait(TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(TIMEOUT)
        reader.join(TIMEOUT)
    out = "".join(lines)
    assert proc.returncode == 0, out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["probe_pass"] >= 1 and summary["probe_fail"] == 0
    assert (tmp_path / "out" / "pre.npz").exists()


def test_listen_without_a_card_refuses(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert cli.main(["serve", "--listen", "127.0.0.1:0"]) == 2
    assert "error:" in capsys.readouterr().err
    assert cli.main(["serve", "--device", "cpu", "--requests", "x.jsonl",
                     "--probe-interval", "1"]) == 2
