"""The cost observatory of the port against heat_tpu's.

``Histogram``, ``CostModel``, ``CompileLog``, ``MemWatermark``,
``UsageLedger``, ``BurnMonitor`` and the ``Observatory`` facade are fed the
same sequences in both packages and must give equal snapshots. Then a
served population's ``usage`` stamps must reconcile exactly with the
engine's ledger, and equal the JAX engine's stamps on every key that is not
time-valued (``lane_s`` is wall clock).
"""

import random

import numpy as np
import pytest
import torch

from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.runtime import prof as jprof
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu.serve import policy as jpolicy
from heat_tpu_torch.config import SLO_TARGETS, HeatConfig
from heat_tpu_torch.runtime import prof
from heat_tpu_torch.serve import Engine, ServeConfig, policy

torch.set_num_threads(1)


def _seq(seed, n=300):
    rng = random.Random(seed)
    return [rng.choice([0.0, 1e-9, 3e-4, 0.0025, 0.7, 12.0, 99.0,
                        rng.expovariate(4.0)]) for _ in range(n)]


def test_histogram_matches_the_reference():
    assert prof.LATENCY_BUCKETS == jprof.LATENCY_BUCKETS
    assert prof.DEPTH_BUCKETS == jprof.DEPTH_BUCKETS
    assert policy.Histogram is prof.Histogram   # the policy re-export
    assert jpolicy.Histogram is jprof.Histogram
    for buckets in (prof.LATENCY_BUCKETS, prof.DEPTH_BUCKETS,
                    prof.LANE_STEP_BUCKETS):
        hp, hj = prof.Histogram(buckets), jprof.Histogram(buckets)
        for v in _seq(len(buckets)):
            hp.observe(v)
            hj.observe(v)
        assert hp.snapshot() == hj.snapshot()
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert hp.quantile(q) == hj.quantile(q)
    assert prof.Histogram().quantile(0.5) is None


def test_cost_model_matches_the_reference():
    cp, cj = prof.CostModel(), jprof.CostModel()
    rng = random.Random(3)
    for _ in range(200):
        args = (rng.choice(["2d/n256/float32/edges", "3d/n64/bfloat16/ghost"]),
                rng.choice([1, 2, 4]), rng.choice([0, 2]),
                rng.choice([4, 16]), rng.uniform(-1e-3, 0.05))
        kernel = rng.choice(["cuda", "torch"])
        cp.observe(*args, kernel=kernel)
        cj.observe(*args, kernel=kernel)
    assert cp.snapshot() == cj.snapshot()
    for key in (("2d/n256/float32/edges", 4, 2), ("3d/n64/bfloat16/ghost", 1, 0)):
        for kernel in ("cuda", "torch", "none"):
            assert (cp.estimate_request_s(*key, 1000, kernel=kernel)
                    == cj.estimate_request_s(*key, 1000, kernel=kernel))


def test_compile_log_and_mem_watermark_match_the_reference():
    lp, lj = prof.CompileLog(capacity=4), jprof.CompileLog(capacity=4)
    for label, k, s in [("a", 16, 0.5), ("a", 16, 0.1), ("b", 4, 2.0),
                        ("nvcc lanes2d", 0, 30.0), ("a", 4, 0.2),
                        ("b", 4, 0.3)]:
        ep, ej = lp.note(label, k, s), lj.note(label, k, s)
        assert {k2: v for k2, v in ep.items() if k2 != "ts"} == {
            k2: v for k2, v in ej.items() if k2 != "ts"}
    assert lp.summary() == lj.summary()
    assert len(lp.snapshot()) == len(lj.snapshot()) == 4
    mp, mj = prof.MemWatermark(), jprof.MemWatermark()
    levels = ([100 << 20] * 3 + [(100 + 8 * i) << 20 for i in range(12)]
              + [50 << 20] + [(400 + 30 * i) << 20 for i in range(10)])
    warns = []
    for t, b in enumerate(levels):
        wp = mp.note(b, float(t), "device")
        assert wp == mj.note(b, float(t), "device")
        warns.append(wp is not None)
    assert sum(warns) >= 2
    assert mp.snapshot() == mj.snapshot()


def test_device_memory_source_on_the_cpu_sees_host_memory():
    nbytes, source = prof.device_memory_bytes("cpu")
    assert source == "rss" and nbytes > 0
    big = np.ones(64 << 20, dtype=np.uint8)   # 64 MiB, resident
    after, _ = prof.device_memory_bytes("cpu")
    assert after > nbytes + (32 << 20)
    del big


def _ledger_feed(ledger, rng):
    for i in range(120):
        usage = {"lane_s": round(rng.uniform(0, 2), 6),
                 "steps": rng.randrange(0, 500),
                 "chunks": rng.randrange(0, 40),
                 "bytes_written": rng.randrange(0, 1 << 20),
                 "steps_saved": rng.randrange(0, 50),
                 "cached": rng.random() < 0.2}
        ledger.add(rng.choice(["a", "b", "_probe"]),
                   rng.choice(["interactive", "standard", "batch"]),
                   rng.choice(["ok", "deadline", "rejected"]), usage,
                   placement=rng.choice(["packed", None]))


def test_usage_ledger_matches_the_reference():
    lp, lj = prof.UsageLedger(), jprof.UsageLedger()
    _ledger_feed(lp, random.Random(5))
    _ledger_feed(lj, random.Random(5))
    assert lp.snapshot() == lj.snapshot()
    assert prof.empty_usage() == jprof.empty_usage()
    assert prof.USAGE_FIELDS == jprof.USAGE_FIELDS


def test_burn_monitor_matches_the_reference():
    targets = dict(SLO_TARGETS)
    bp = prof.BurnMonitor(targets, fast_window_s=5, slow_window_s=30,
                          threshold=2.0, cooldown_s=10)
    bj = jprof.BurnMonitor(targets, fast_window_s=5, slow_window_s=30,
                           threshold=2.0, cooldown_s=10)
    rng = random.Random(7)
    alerts = 0
    for i in range(400):
        now = i * 0.25
        cls = rng.choice(["interactive", "standard", "batch"])
        ok = rng.random() > (0.4 if 100 < i < 250 else 0.02)
        ap, aj = bp.note(cls, ok, now), bj.note(cls, ok, now)
        assert ap == aj
        alerts += ap is not None
        if i % 37 == 0:
            assert bp.snapshot(now) == bj.snapshot(now)
    assert alerts > 0


def test_observatory_facade_matches_the_reference():
    kw = dict(slo_targets=dict(SLO_TARGETS), mem_poll_every=0,
              slo_fast_window_s=5.0, slo_slow_window_s=20.0,
              slo_burn_threshold=1.5)
    op, oj = prof.Observatory(**kw), jprof.Observatory(**kw)
    rng = random.Random(11)
    for i in range(150):
        snap = {"tenant": rng.choice(["t1", "t2"]),
                "class": rng.choice(["interactive", "batch"]),
                "status": rng.choice(["ok", "ok", "deadline", "rejected"]),
                "deadline_ms": rng.choice([None, 100.0]),
                "placement": "packed",
                "usage": {"lane_s": 0.5, "steps": i, "chunks": 2,
                          "bytes_written": 10 * i, "steps_saved": 1,
                          "cached": False}}
        assert op.note_terminal(snap, i * 0.1) == oj.note_terminal(snap,
                                                                   i * 0.1)
        op.observe_chunk("2d/n16/float32/edges", 2, 2, 8, 0.01 * (i % 7),
                         kernel="torch")
        oj.observe_chunk("2d/n16/float32/edges", 2, 2, 8, 0.01 * (i % 7),
                         kernel="torch")
    sp, sj = op.summary(15.0), oj.summary(15.0)
    for key in ("cost_model", "slo_burn"):
        assert sp[key] == sj[key]
    assert op.ledger.snapshot() == oj.ledger.snapshot()
    off = prof.Observatory(enabled=False)
    assert off.note_terminal({"usage": prof.empty_usage()}, 0.0) is None
    assert off.maybe_sample_memory(0.0, force=True) is None


REQS = [dict(id="a", n=12, ntime=37, dtype="float32", bc="edges"),
        dict(id="b", n=9, ntime=20, dtype="bfloat16", bc="ghost",
             bc_value=1.0, tenant="t2", slo_class="batch"),
        dict(id="c", n=7, ntime=16, ndim=3, sigma=1 / 6, bc="edges"),
        dict(id="d", n=40, ntime=5, tenant="t2"),      # overflow: rejected
        dict(id="e", n=12, ntime=60, ic="sine", until="steady", tol=1e-2),
        dict(id="f", n=12, ntime=0)]


def _drain(port: bool, out_dir):
    cfg_cls = HeatConfig if port else JHeatConfig
    kw = dict(lanes=2, chunk=8, buckets=(16,), emit_records=False,
              out_dir=str(out_dir), mem_poll_every=1)
    if port:
        eng = Engine(ServeConfig(**kw), device="cpu")
    else:
        eng = JEngine(JServeConfig(mega_lanes=0, **kw))
    for r in REQS:
        r = dict(r)
        rid = r.pop("id")
        sub = {k: r.pop(k) for k in ("tenant", "slo_class", "until", "tol")
               if k in r}
        eng.submit(cfg_cls(**r), request_id=rid, **sub)
    return eng, {r["id"]: r for r in eng.results()}


def test_usage_stamps_reconcile_with_the_ledger_and_the_reference(tmp_path):
    eng, recs = _drain(True, tmp_path / "port")
    jeng, jrecs = _drain(False, tmp_path / "jax")
    fields = ("steps", "chunks", "bytes_written", "steps_saved", "cached")
    for rid, r in recs.items():
        assert set(r["usage"]) == set(prof.USAGE_FIELDS), rid
        assert {k: r["usage"][k] for k in fields} == {
            k: jrecs[rid]["usage"][k] for k in fields}, rid
        assert r["status"] == jrecs[rid]["status"]
    led = eng.prof.ledger.snapshot()
    totals = led["totals"]
    for f in fields:
        want = sum(int(r["usage"][f]) for r in recs.values())
        assert totals[f] == want, f
    assert totals["lane_s"] == pytest.approx(
        sum(r["usage"]["lane_s"] for r in recs.values()), abs=1e-5)
    assert totals["requests"] == len(REQS)
    assert recs["d"]["usage"] == prof.empty_usage()
    assert recs["e"]["usage"]["steps_saved"] > 0     # a steady exit
    # the bytes are the published files'
    assert recs["a"]["usage"]["bytes_written"] == (
        tmp_path / "port" / "a.npz").stat().st_size
    s = eng.summary()
    assert s["prof"] is True and s["mem"]["source"] == "rss"
    assert s["mem"]["samples"] > 0
    assert [(e["bucket"], e["lanes"], e["depth"], e["chunks"])
            for e in s["cost_model"]] == [
        (e["bucket"], e["lanes"], e["depth"], e["chunks"])
        for e in jeng.summary()["cost_model"]]


def test_prof_off_keeps_the_stamps_and_skips_the_ledger(tmp_path):
    eng = Engine(ServeConfig(buckets=(16,), prof=False, emit_records=False),
                 device="cpu")
    eng.submit(HeatConfig(n=10, ntime=9), request_id="x")
    (rec,) = eng.results()
    # 9 steps in tail chunks of 4 (the 16-step chunk's quarter): 3 chunks
    assert rec["usage"]["steps"] == 9 and rec["usage"]["chunks"] == 3
    assert eng.prof.ledger.snapshot()["totals"]["requests"] == 0
    assert eng.summary()["prof"] is False
    assert eng.summary()["cost_model"] == []
