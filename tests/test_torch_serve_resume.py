"""Engine checkpoints, the handoff drain and ``serve --resume`` of the port
against heat_tpu's.

The online scheduler thread of each engine is held inside a named chunk
boundary (its third) while the test asks for ``begin_drain(handoff=True)``,
so both engines cut at the same boundary, with no sleep and no race. The
checkpoint must hold the same in-flight lanes (field files byte-equal),
queue and manifest keys as the JAX engine's (``lane_s`` is wall clock and
the numerics state's floats are the observatory's, so those two are
compared by keys). A resumed engine must finish every request with the
reference's npz bytes — from a generation the port wrote and from one the
JAX engine wrote — and fall back a generation under
``ckpt-manifest-corrupt``.
"""

import json
import threading

import pytest
import torch

from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.runtime import faults as jfaults
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu.serve import scheduler as jsch
from heat_tpu_torch import cli
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.runtime import checkpoint as ckpt
from heat_tpu_torch.runtime import faults
from heat_tpu_torch.serve import Engine, ServeConfig
from heat_tpu_torch.serve import resume
from heat_tpu_torch.serve import scheduler as sch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_faults():
    jfaults.reset()
    faults.reset()
    yield
    jfaults.reset()
    faults.reset()


REQS = [dict(id="a", n=12, ntime=60, dtype="float32", bc="edges"),
        dict(id="b", n=10, ntime=44, dtype="float32", bc="ghost",
             bc_value=1.0, ic="hat_small"),
        dict(id="c", n=11, ntime=36, dtype="float32", bc="edges",
             ic="hat_half"),
        dict(id="d", n=9, ntime=52, dtype="bfloat16", bc="edges"),
        dict(id="e", n=7, ntime=30, ndim=3, sigma=1 / 6, bc="ghost",
             ic="hat_half")]
KNOBS = dict(lanes=2, chunk=4, buckets=(16,), emit_records=False)


def _engine(port: bool, **kw):
    kw = dict(KNOBS, **kw)
    if port:
        return Engine(ServeConfig(**kw), device="cpu")
    return JEngine(JServeConfig(mega_lanes=0, **kw))


def _submit(eng, port: bool, reqs):
    cfg_cls = HeatConfig if port else JHeatConfig
    for r in reqs:
        r = dict(r)
        rid = r.pop("id")
        eng.submit(cfg_cls(**r), request_id=rid)


def _handoff(port: bool, ckpt_dir, monkeypatch, hold_at=3, **kw):
    """Serve REQS online; hold the scheduler thread inside its
    ``hold_at``-th boundary, ask for the handoff drain there, release.
    Returns the engine after its loop exited."""
    module = sch if port else jsch
    orig = module._GroupRunner.process_boundary
    seen, asked = [], threading.Event()

    def gated(self):
        orig(self)
        seen.append(1)
        if len(seen) == hold_at:
            asked.wait(60)

    monkeypatch.setattr(module._GroupRunner, "process_boundary", gated)
    eng = _engine(port, engine_ckpt_dir=str(ckpt_dir), **kw)
    _submit(eng, port, REQS)
    eng.start()
    try:
        for _ in range(6000):
            if len(seen) >= hold_at or not eng.online:
                break
            threading.Event().wait(0.01)
        assert len(seen) >= hold_at, "the scheduler never reached the hold"
        eng.begin_drain(handoff=True)
        asked.set()
        assert eng.shutdown(timeout=120)
    finally:
        asked.set()
        eng.shutdown(timeout=120)
        monkeypatch.undo()
    assert eng.loop_error is None
    return eng


def _manifest(d):
    man, path = ckpt.latest_engine_manifest(d)
    assert man is not None
    return man, path


def _strip(entry):
    e = dict(entry)
    e.pop("lane_s")
    num = e.pop("numerics", None)
    e["numerics"] = None if num is None else sorted(num)
    e["cfg"] = {k: v for k, v in e["cfg"].items() if k != "backend"}
    return e


def test_handoff_checkpoint_equals_the_jax_engines(tmp_path, monkeypatch):
    ep = _handoff(True, tmp_path / "p", monkeypatch)
    ej = _handoff(False, tmp_path / "j", monkeypatch)
    mp, pp = _manifest(tmp_path / "p")
    mj, pj = _manifest(tmp_path / "j")
    assert pp.name == pj.name
    assert sorted(mp) == sorted(mj)
    for key in ("kind", "version", "generation", "reason", "boundaries",
                "policy", "done"):
        assert mp[key] == mj[key], key
    assert mp["reason"] == "handoff"
    assert [_strip(e) for e in mp["inflight"]] == [
        _strip(e) for e in mj["inflight"]]
    assert [_strip(e) for e in mp["queued"]] == [
        _strip(e) for e in mj["queued"]]
    # the lane fields: the same file names and the same bytes
    fields = sorted(p.name for p in (tmp_path / "p").glob("*.npz"))
    assert fields == sorted(p.name for p in (tmp_path / "j").glob("*.npz"))
    assert len(fields) == len(mp["inflight"]) >= 2
    for name in fields:
        assert (tmp_path / "p" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes(), name
    # the handoff drain left lanes unfinished: running records, no result
    running = [r["id"] for r in ep._records if r["status"] == "running"]
    assert sorted(running) == sorted(e["id"] for e in mp["inflight"])
    assert ep.summary()["engine_ckpt_generation"] == mp["generation"]
    assert ej.summary()["engine_ckpt_generation"] == mj["generation"]


_STRAIGHT: dict = {}


def _uninterrupted(tmp_path):
    """The reference's npz bytes of REQS served without interruption
    (computed once per session)."""
    if not _STRAIGHT:
        out = tmp_path / "straight"
        eng = _engine(False, out_dir=str(out))
        _submit(eng, False, REQS)
        assert all(r["status"] == "ok" for r in eng.results())
        _STRAIGHT.update({r["id"]: (out / f"{r['id']}.npz").read_bytes()
                          for r in REQS})
    return _STRAIGHT


def _resume_and_finish(ckpt_dir, out_dir):
    eng = _engine(True, out_dir=str(out_dir))
    known = resume.resume_engine(eng, ckpt_dir)
    recs = {r["id"]: r for r in eng.results()}
    return eng, known, recs


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_finishes_with_the_reference_bytes(writer, tmp_path,
                                                  monkeypatch):
    d = tmp_path / "ck"
    first = _handoff(writer == "port", d, monkeypatch)
    man, _ = _manifest(d)
    eng, known, recs = _resume_and_finish(d, tmp_path / "out")
    assert known == {r["id"] for r in REQS}
    want = _uninterrupted(tmp_path)
    inflight = {e["id"] for e in man["inflight"]}
    for rid, rec in recs.items():
        assert rec["status"] == "ok", (rid, rec["error"])
        assert rec["resumed"] is True
        assert (tmp_path / "out" / f"{rid}.npz").read_bytes() == want[rid]
        if rid in inflight:
            # the usage stamp spans both incarnations
            assert rec["usage"]["steps"] == rec["ntime"]
    assert eng.summary()["serve_resumed"] == len(recs)
    # the requests finished before the cut are not replayed
    done = set(man["done"])
    assert done.isdisjoint(recs) or not done
    if first is not None and done:
        assert all(first._by_id[i]["status"] == "ok" for i in done)


def test_manifest_falls_back_a_generation_when_corrupt(tmp_path,
                                                       monkeypatch):
    # interval generations every 2 boundaries, then the handoff generation
    # at the hold; a dry run counts them (the cut is deterministic), then
    # the fault scribbles over the handoff manifest once it is published
    kw = dict(hold_at=16, engine_ckpt_interval=2)
    _handoff(True, tmp_path / "dry", monkeypatch, **kw)
    last, _ = _manifest(tmp_path / "dry")
    gen = last["generation"]
    assert last["reason"] == "handoff" and gen >= 2
    d = tmp_path / "ck"
    _handoff(True, d, monkeypatch, inject=f"ckpt-manifest-corrupt@{gen}",
             **kw)
    assert (d / f"engine_gen{gen:08d}.json").exists()
    eng, known, recs = _resume_and_finish(d, tmp_path / "out")
    assert (d / f"engine_gen{gen:08d}.json.corrupt").exists()
    assert eng._engine_ckpt_gen == gen - 1
    prev = json.loads((d / f"engine_gen{gen - 1:08d}.json").read_text())
    assert prev["inflight"], "the fallback generation holds in-flight lanes"
    want = _uninterrupted(tmp_path)
    assert {r["status"] for r in recs.values()} == {"ok"}
    for rid in recs:
        assert (tmp_path / "out" / f"{rid}.npz").read_bytes() == want[rid]
    # the lineage never re-publishes the quarantined generation number
    assert ckpt.next_engine_generation(d) == gen + 1


def test_interval_checkpoints_and_the_drain_generation(tmp_path):
    d = tmp_path / "ck"
    eng = _engine(True, engine_ckpt_interval=3, engine_ckpt_dir=str(d))
    _submit(eng, True, REQS)
    assert all(r["status"] == "ok" for r in eng.results())
    jd = tmp_path / "jck"
    jeng = _engine(False, engine_ckpt_interval=3, engine_ckpt_dir=str(jd))
    _submit(jeng, False, REQS)
    jeng.results()
    names = sorted(p.name for p in d.iterdir())
    assert names == sorted(p.name for p in jd.iterdir())
    for name in names:
        if name.endswith(".npz"):
            assert (d / name).read_bytes() == (jd / name).read_bytes()
    man, _ = _manifest(d)
    assert man["reason"] == "drain" and not man["inflight"]
    assert sorted(man["done"]) == sorted(r["id"] for r in REQS)
    # a resume of the drain generation re-admits nothing
    eng2 = _engine(True)
    assert resume.resume_engine(eng2, d) == {r["id"] for r in REQS}
    assert eng2.results() == []


def test_resume_of_an_empty_directory_starts_fresh(tmp_path):
    eng = _engine(True)
    assert resume.resume_engine_detail(eng, tmp_path / "none") == {
        "generation": 0, "recovered": [], "done": []}


def test_serve_resume_cli(tmp_path, monkeypatch, capsys):
    d = tmp_path / "ck"
    _handoff(True, d, monkeypatch)
    man, _ = _manifest(d)
    req = tmp_path / "req.jsonl"
    req.write_text("\n".join(json.dumps(r) for r in REQS
                             + [dict(id="new", n=8, ntime=12)]) + "\n")
    out = tmp_path / "out"
    rc = cli.main(["serve", "--requests", str(req), "--resume", str(d),
                   "--device", "cpu", "--lanes", "2", "--chunk", "4",
                   "--buckets", "16", "--out-dir", str(out)])
    assert rc == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"') and '"serve_request"' in ln]
    by_id = {r["id"]: r for r in recs}
    assert by_id["new"]["resumed"] is False
    assert all(by_id[e["id"]]["resumed"] for e in man["inflight"])
    want = _uninterrupted(tmp_path)
    for r in REQS:
        if r["id"] in man["done"]:
            continue
        assert (out / f"{r['id']}.npz").read_bytes() == want[r["id"]]
    assert cli.main(["serve", "--device", "cpu"]) == 2
