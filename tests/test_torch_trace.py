"""The trace observatory of the port against heat_tpu's.

The same seeded population is served by the JAX ``Engine`` and the port's
``Engine(device="cpu")``; their event rings must hold the same events: the
same (phase, name, category, process track, thread track) multiset. Time
stamps, durations, trace ids and the counter samples' values are left out
(wall clock, a process id, and the numerics stats that
``test_torch_serve_semantics.py`` holds within a tolerance), as are the JAX engine's ``compile`` spans: the port
builds no program per chunk size, so it has no such span. The ring, the
Chrome export, the flight dumps and ``summarize`` are compared directly.
"""

import collections
import json
import threading

import pytest
import torch

from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.runtime import trace as jtrace
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu_torch import cli
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.runtime import trace
from heat_tpu_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

REQS = [dict(n=12, ntime=37, dtype="float32", bc="edges"),
        dict(n=9, ntime=20, dtype="bfloat16", bc="ghost", bc_value=1.0),
        dict(n=7, ntime=16, ndim=3, sigma=1 / 6, bc="edges"),
        dict(n=40, ntime=5),          # bucket overflow: a rejection
        dict(n=12, ntime=0)]


def _serve(port: bool, depth: int, **kw):
    cfg_cls = HeatConfig if port else JHeatConfig
    if not port:
        kw["mega_lanes"] = 0   # the port has no mega-lane tier: an
                               # overflow is a rejection in both
    scfg = (ServeConfig if port else JServeConfig)(
        lanes=2, chunk=8, buckets=(16,), emit_records=False, keep_fields=True,
        dispatch_depth=depth, **kw)
    eng = Engine(scfg, device="cpu") if port else JEngine(scfg)
    for i, r in enumerate(REQS):
        eng.submit(cfg_cls(**r), request_id=f"r{i}")
    eng.results()
    return eng


def _events(chrome: dict) -> collections.Counter:
    names = {}
    for ev in chrome["traceEvents"]:
        if ev["ph"] == "M":
            key = (ev["pid"], 0 if ev["name"] == "process_name" else ev["tid"])
            names[key] = ev["args"]["name"]
    out = collections.Counter()
    for ev in chrome["traceEvents"]:
        if ev["ph"] == "M" or ev.get("cat") == "compile":
            continue
        out[(ev["ph"], ev["name"], ev["cat"], names[(ev["pid"], 0)],
             names[(ev["pid"], ev["tid"])])] += 1
    return out


@pytest.mark.parametrize("depth", [0, 2])
def test_served_population_traces_like_the_jax_engine(depth):
    ep, ej = _serve(True, depth), _serve(False, depth)
    got, want = _events(ep.tracer.to_chrome()), _events(ej.tracer.to_chrome())
    assert got == want
    kinds = {k[1].split(" ")[0] for k in got}
    assert {"chunk", "boundary-fetch", "queue-wait", "enqueue", "r0",
            "request"} <= kinds
    assert any(k[1].startswith("writeback") for k in got)
    # every record carries its trace id, minted per request
    ids = [r["trace_id"] for r in ep._records]
    assert len(set(ids)) == len(REQS) and all(ids)


def test_trace_buffer_zero_records_nothing_but_mints_ids():
    eng = _serve(True, 2, trace_buffer=0)
    assert not eng.tracer.enabled and len(eng.tracer) == 0
    assert all(r["trace_id"] for r in eng._records)
    with pytest.raises(ValueError, match="trace_buffer"):
        ServeConfig(trace="x.json", trace_buffer=0)


def _fill(tr, n):
    track = tr.track("p", "t")
    for i in range(n):
        tr.instant(f"e{i}", track, ts=float(i), args={"i": i})


def test_ring_capacity_and_eviction_match_the_reference():
    for cap, n in ((3, 5), (8, 8), (4, 0)):
        tp, tj = trace.Tracer(capacity=cap), jtrace.Tracer(capacity=cap)
        _fill(tp, n)
        _fill(tj, n)
        assert len(tp) == len(tj) == min(cap, n)
        assert tp.dropped_hint == tj.dropped_hint == (n > cap)
        assert tp.to_chrome() == tj.to_chrome()
        if n:
            assert [e[3] for e in tp.snapshot()][-1] == f"e{n - 1}"


def test_flight_dumps_and_their_cap(tmp_path):
    tr = trace.Tracer(capacity=16)
    _fill(tr, 3)
    paths = [tr.flight_dump(tmp_path, f"why {i}")
             for i in range(trace.MAX_FLIGHT_DUMPS + 2)]
    assert trace.MAX_FLIGHT_DUMPS == jtrace.MAX_FLIGHT_DUMPS
    assert all(p is not None for p in paths[:trace.MAX_FLIGHT_DUMPS])
    assert paths[trace.MAX_FLIGHT_DUMPS:] == [None, None]
    assert tr.dumps == trace.MAX_FLIGHT_DUMPS
    assert sorted(tr.dump_paths) == sorted(str(p) for p in paths if p)
    assert len(list(tmp_path.glob("flightrec-*.trace.json"))) == tr.dumps
    assert trace.Tracer(capacity=0).flight_dump(tmp_path, "off") is None


def test_engine_flight_dump_lands_in_out_dir_or_nowhere(tmp_path, capsys):
    eng = Engine(ServeConfig(buckets=(16,), out_dir=str(tmp_path)),
                 device="cpu")
    eng._flight_dump("a test")
    dumps = list(tmp_path.glob("flightrec-*.trace.json"))
    assert len(dumps) == 1 and eng.tracer.dumps == 1
    rec = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert rec[-1]["event"] == "flightrec" and rec[-1]["path"] == str(dumps[0])
    eng = Engine(ServeConfig(buckets=(16,)), device="cpu")
    eng._flight_dump("no directory")
    assert eng.tracer.dumps == 0


def test_summarize_gives_the_reference_lines(tmp_path):
    eng = _serve(True, 2)
    path = eng.tracer.export(tmp_path / "port.trace.json")
    assert trace.summarize_file(path) == jtrace.summarize_file(path)
    lines = trace.summarize_file(path)
    assert lines[0].startswith("trace: ") and any(
        ln.startswith("lane utilization") for ln in lines)
    jpath = _serve(False, 2).tracer.export(tmp_path / "jax.trace.json")
    assert trace.summarize_file(jpath) == jtrace.summarize_file(jpath)
    assert trace.summarize({"traceEvents": []}) == jtrace.summarize(
        {"traceEvents": []})


def test_trace_cli_and_serve_trace_export(tmp_path, capsys):
    req = tmp_path / "req.jsonl"
    req.write_text("\n".join(json.dumps(dict(r, id=f"r{i}"))
                             for i, r in enumerate(REQS[:3])) + "\n")
    out = tmp_path / "serve.trace.json"
    rc = cli.main(["serve", "--requests", str(req), "--device", "cpu",
                   "--buckets", "16", "--trace", str(out)])
    assert rc == 0 and out.exists()
    capsys.readouterr()
    assert cli.main(["trace", str(out), "--top", "2"]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed == trace.summarize_file(out, top=2)
    assert cli.main(["trace", str(tmp_path / "missing.json")]) == 2


def test_run_trace_puts_one_chunk_span_per_launch_group(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "input.dat").write_text("32 0.2 0.05 2.0 40 0\n")
    out = tmp_path / "run.trace.json"
    try:
        assert cli.main(["run", "--backend", "cuda", "--device", "cpu",
                         "--trace", str(out), "--checkpoint-every", "16",
                         "--checkpoint-dir", str(tmp_path / "ck")]) == 0
    finally:
        trace.configure()
    evs = json.loads(out.read_text())["traceEvents"]
    chunks = [e for e in evs if e["name"].startswith("chunk @")]
    assert [e["args"]["k"] for e in chunks] == [16, 16, 8]
    names = {e["name"] for e in evs}
    assert {"compile", "solve", "final-sync", "checkpoint-snapshot",
            "checkpoint @16", "checkpoint @32"} <= names


def test_thread_names_match_the_reference():
    """The port's threads carry the reference's names, so the tracks of a
    trace read alike (and the test suite's leak guard watches them)."""
    eng = Engine(ServeConfig(buckets=(16,), emit_records=False),
                 device="cpu").start()
    try:
        names = {t.name for t in threading.enumerate()}
        assert "heat-tpu-serve-scheduler" in names
    finally:
        assert eng.shutdown(timeout=30)
