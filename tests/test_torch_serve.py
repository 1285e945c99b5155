"""The port's serving engine (heat_tpu_torch.serve) against heat_tpu's.

The reference's lane matrix (tests/test_serve_lane_kernel.py: five requests
over two lanes, mid-flight admits, an ntime=0 request) is drained by the
JAX ``Engine`` (its XLA lane program, the serving oracle) and by the port's
``Engine(device="cpu")`` (the lane kernels' plain version) at dispatch
depths 0 and 2. Statuses must be equal, and the result fields' bytes for
f32/bf16, in memory and in the published npz files. f64 has no lane
kernel: the port serves it with the serial oracle's two roundings, byte
for byte, and within 1e-12 of the JAX engine, whose jitted CPU body
contracts into FMAs. Then the engine's behaviour: quarantine, the desync
check, deadlines, admission bounds, rejections, one boundary fetch per
boundary, and ``python -m heat_tpu_torch serve --device cpu`` end to end.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.runtime import faults as jfaults
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu_torch.backends import solve
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.serve import Engine, ServeConfig, serve_requests
from heat_tpu_torch.serve import engine as te
from heat_tpu_torch.serve import scheduler as sch

torch.set_num_threads(1)
_REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_faults():
    jfaults.reset()
    yield
    jfaults.reset()


MATRIX = [
    # (ndim, dtype, bc mix)
    (2, "float32", ("ghost", "edges")),
    (2, "float32", ("edges", "ghost")),
    (2, "bfloat16", ("ghost", "edges")),
    (2, "float64", ("edges", "ghost")),
    (3, "float32", ("ghost", "edges")),
    (3, "float32", ("edges", "ghost")),
]


def matrix_requests(ndim, dtype, bcs):
    """tests/test_serve_lane_kernel.py:78-92, as keyword sets."""
    small = 6 if ndim == 3 else 8
    big = 8 if ndim == 3 else 12
    return [
        dict(n=big, ntime=13, ndim=ndim, dtype=dtype, bc=bcs[0], ic="hat"),
        dict(n=small, ntime=21, ndim=ndim, dtype=dtype, bc=bcs[1],
             ic="uniform", nu=0.1),
        dict(n=big - 2, ntime=5, ndim=ndim, dtype=dtype, bc=bcs[0],
             ic="hat_small"),
        dict(n=big, ntime=0, ndim=ndim, dtype=dtype, bc=bcs[1], ic="hat"),
        dict(n=small + 1, ntime=30, ndim=ndim, dtype=dtype, bc=bcs[0],
             ic="hat_half", bc_value=2.5),
    ]


def _drain(engine_cls, scfg_cls, cfg_cls, reqs, **kw):
    kw.setdefault("emit_records", False)
    kw.setdefault("keep_fields", True)
    extra = {"device": "cpu"} if engine_cls is Engine else {}
    eng = engine_cls(scfg_cls(**kw), **extra)
    ids = [eng.submit(cfg_cls(**r)) for r in reqs]
    by_id = {r["id"]: r for r in eng.results()}
    return eng, [by_id[i] for i in ids]


def _as_f64(T):
    return np.asarray(T, np.float64)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("ndim,dtype,bcs", MATRIX)
def test_lane_matrix_matches_jax_engine(ndim, dtype, bcs, depth):
    reqs = matrix_requests(ndim, dtype, bcs)
    kw = dict(lanes=2, chunk=4, buckets=(8,) if ndim == 3 else (12,),
              dispatch_depth=depth)
    _, recs_j = _drain(JEngine, JServeConfig, JHeatConfig, reqs, **kw)
    eng, recs_p = _drain(Engine, ServeConfig, HeatConfig, reqs, **kw)
    assert [r["status"] for r in recs_p] == [r["status"] for r in recs_j]
    assert all(r["status"] == "ok" for r in recs_p)
    assert eng.lane_kernel_fallbacks == 0
    for rj, rp, cfg in zip(recs_j, recs_p, reqs):
        Tj = np.asarray(rj["T"])
        assert rp["T"].shape == Tj.shape
        if dtype == "float64":
            # the serial oracle's arithmetic, bytes; the jitted JAX body
            # contracts some updates into FMAs
            want = solve(HeatConfig(backend="serial", **cfg)).T
            assert rp["T"].tobytes() == want.tobytes(), rp["id"]
            np.testing.assert_allclose(rp["T"], Tj, rtol=0, atol=1e-12)
        else:
            assert rp["T"].tobytes() == Tj.tobytes(), rp["id"]


@pytest.mark.parametrize("depth", [0, 2])
def test_npz_outputs_match_jax_engine(tmp_path, depth):
    """Published npz files carry the reference's arrays: T (bf16 as its
    bits), step, n, ndim, dtype."""
    for dtype in ("float32", "bfloat16"):
        reqs = matrix_requests(2, dtype, ("ghost", "edges"))
        kw = dict(lanes=2, chunk=4, buckets=(12,), dispatch_depth=depth)
        dj, dp = tmp_path / f"jax-{dtype}", tmp_path / f"port-{dtype}"
        _drain(JEngine, JServeConfig, JHeatConfig, reqs, out_dir=str(dj), **kw)
        _drain(Engine, ServeConfig, HeatConfig, reqs, out_dir=str(dp), **kw)
        names = sorted(p.name for p in dj.glob("*.npz"))
        assert names == sorted(p.name for p in dp.glob("*.npz"))
        assert len(names) == len(reqs)
        for name in names:
            with np.load(dj / name) as a, np.load(dp / name) as b:
                assert sorted(a.files) == sorted(b.files)
                assert a["T"].dtype.str == b["T"].dtype.str
                assert a["T"].tobytes() == b["T"].tobytes(), name
                for k in ("step", "n", "ndim", "dtype"):
                    assert a[k] == b[k]


CHAOS_REQS = [
    dict(n=10, ntime=12, dtype="float32", bc="ghost"),
    dict(n=12, ntime=20, dtype="float32", bc="edges", ic="hat_small"),
    dict(n=8, ntime=16, dtype="float32", bc="ghost", ic="uniform"),
]


def _drain_ids(reqs, ids, **kw):
    kw.setdefault("emit_records", False)
    kw.setdefault("keep_fields", True)
    eng = Engine(ServeConfig(**kw), device="cpu")
    for rid, cfg in zip(ids, reqs):
        eng.submit(HeatConfig(**cfg), request_id=rid)
    by_id = {r["id"]: r for r in eng.results()}
    return eng, [by_id[i] for i in ids]


@pytest.mark.parametrize("depth", [0, 2])
def test_quarantine_isolates_poisoned_lane(monkeypatch, depth):
    """A lane poisoned once its request has run 6 steps (the reference's
    ``lane-nan@6:req=r1``) fails ``nonfinite``; the co-scheduled lanes are
    byte-identical to a clean run and to the JAX engine's."""
    ids = ["r0", "r1", "r2"]
    kw = dict(lanes=2, chunk=4, buckets=(12,), dispatch_depth=depth)
    _, clean = _drain_ids(CHAOS_REQS, ids, **kw)
    orig = sch._GroupRunner._dispatch
    fired = []

    def poisoning_dispatch(self, k):
        for lane, req in enumerate(self.occupant):
            done = (req.cfg.ntime - int(self.dev_rem[lane])
                    if req is not None else -1)
            if req is not None and req.id == "r1" and done >= 6 and not fired:
                fired.append(lane)
                self.eng.poison_lane(lane, req.cfg.n)
        return orig(self, k)

    monkeypatch.setattr(sch._GroupRunner, "_dispatch", poisoning_dispatch)
    eng, recs = _drain_ids(CHAOS_REQS, ids, **kw)
    assert fired
    assert [r["status"] for r in recs] == ["ok", "nonfinite", "ok"]
    assert "non-finite" in recs[1]["error"]
    assert eng.lanes_quarantined == 1 and eng.summary()["lanes_quarantined"] == 1
    jeng = JEngine(JServeConfig(emit_records=False, keep_fields=True,
                                inject="lane-nan@6:req=r1", **kw))
    for rid, cfg in zip(ids, CHAOS_REQS):
        jeng.submit(JHeatConfig(**cfg), request_id=rid)
    jrecs = {r["id"]: r for r in jeng.results()}
    assert [jrecs[i]["status"] for i in ids] == ["ok", "nonfinite", "ok"]
    for i in (0, 2):
        assert recs[i]["T"].tobytes() == clean[i]["T"].tobytes()
        assert recs[i]["T"].tobytes() == np.asarray(jrecs[ids[i]]["T"]).tobytes()


def test_desync_raises_when_countdown_is_tampered(monkeypatch):
    """The host mirrors every lane's countdown and checks each fetched
    boundary against it: a device countdown that moved on its own is an
    error, never a silently mis-served request."""
    orig = sch._GroupRunner._dispatch

    def tampering_dispatch(self, k):
        handle = orig(self, k)
        self.eng._rem[0] += 3      # the next chunk counts from the wrong value
        return handle

    monkeypatch.setattr(sch._GroupRunner, "_dispatch", tampering_dispatch)
    eng = Engine(ServeConfig(lanes=2, chunk=4, buckets=(12,),
                             emit_records=False), device="cpu")
    eng.submit(HeatConfig(n=10, ntime=40))
    with pytest.raises(RuntimeError, match="desync"):
        eng.results()


def test_deadline_sheds_and_preempts(monkeypatch):
    """A queued request past its deadline is shed at admission; a running
    lane past it is preempted at its next boundary. Both are records."""
    now = [0.0]
    monkeypatch.setattr(sch, "wall_clock", lambda: now[0])
    orig = sch._GroupRunner._dispatch

    def slow_dispatch(self, k):
        now[0] += 1.0              # every chunk takes a "second"
        return orig(self, k)

    monkeypatch.setattr(sch._GroupRunner, "_dispatch", slow_dispatch)
    eng = Engine(ServeConfig(lanes=1, chunk=4, buckets=(12,),
                             emit_records=False), device="cpu")
    a = eng.submit(HeatConfig(n=10, ntime=40), deadline_ms=5500)
    b = eng.submit(HeatConfig(n=10, ntime=4), deadline_ms=3000)
    recs = {r["id"]: r for r in eng.results()}
    assert recs[a]["status"] == "deadline" and "preempted" in recs[a]["error"]
    assert 0 < recs[a]["steps_done"] < 40
    assert recs[b]["status"] == "deadline"
    assert "never admitted" in recs[b]["error"]
    assert eng.deadline_misses == 2


def test_max_queue_and_tenant_quota_shed_overloaded():
    eng = Engine(ServeConfig(buckets=(12,), max_queue=2, emit_records=False),
                 device="cpu")
    ids = [eng.submit(HeatConfig(n=8, ntime=2)) for _ in range(3)]
    recs = {r["id"]: r for r in eng.results()}
    assert [recs[i]["status"] for i in ids] == ["ok", "ok", "rejected"]
    assert recs[ids[2]]["error"].startswith("overloaded")
    eng = Engine(ServeConfig(buckets=(12,), tenant_quota=1,
                             emit_records=False), device="cpu")
    a = eng.submit(HeatConfig(n=8, ntime=2), tenant="acme")
    b = eng.submit(HeatConfig(n=8, ntime=2), tenant="acme")
    c = eng.submit(HeatConfig(n=8, ntime=2), tenant="other")
    recs = {r["id"]: r for r in eng.results()}
    assert [recs[i]["status"] for i in (a, b, c)] == ["ok", "rejected", "ok"]
    assert eng.summary()["shed"] == 1


def test_rejects_periodic_oversize_and_steady():
    """Periodic and oversize requests are rejected as records; an
    ``until=steady`` request is served (as the reference serves it)."""
    eng = Engine(ServeConfig(buckets=(12,), emit_records=False), device="cpu")
    p = eng.submit(HeatConfig(n=8, ntime=2, bc="periodic"))
    big = eng.submit(HeatConfig(n=13, ntime=2))
    steady = eng.submit(HeatConfig(n=8, ntime=2), until="steady")
    ok = eng.submit(HeatConfig(n=12, ntime=2))
    recs = {r["id"]: r for r in eng.results()}
    assert recs[p]["error"].startswith("unsupported-bc")
    assert recs[big]["error"].startswith("bucket-overflow")
    assert recs[steady]["status"] == "ok" and recs[steady]["error"] is None
    assert recs[steady]["until"] == "steady"
    assert recs[ok]["status"] == "ok"
    s = eng.summary()
    assert s["rejected"] == 2 and s["ok"] == 2 and s["requests"] == 4


def test_f64_under_cuda_kernel_falls_back_loudly(capsys):
    """--serve-lane-kernel cuda on an f64 bucket: a structured
    lane_kernel_fallback record and counter, the torch lane step serves it
    (the serial oracle's bytes), never an error."""
    eng = Engine(ServeConfig(lanes=2, chunk=4, buckets=(12,),
                             lane_kernel="cuda", keep_fields=True,
                             emit_records=False), device="cpu")
    cfgs = [HeatConfig(n=10, ntime=9, dtype="float64"),
            HeatConfig(n=12, ntime=9, dtype="float32")]
    ids = [eng.submit(c) for c in cfgs]
    recs = {r["id"]: r for r in eng.results()}
    assert eng.lane_kernel_fallbacks == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    fb = [x for x in lines if x["event"] == "lane_kernel_fallback"]
    assert len(fb) == 1 and fb[0]["bucket"] == "2d/n12/float64/edges"
    want = solve(cfgs[0].with_(backend="serial")).T
    assert recs[ids[0]]["T"].tobytes() == want.tobytes()
    assert recs[ids[1]]["status"] == "ok"


def test_host_fetch_once_per_boundary(monkeypatch):
    """host_fetch is the one D2H seam: each boundary is fetched once, each
    finished lane once, nothing else."""
    calls = []
    orig = te.host_fetch

    def counting(x):
        out = orig(x)
        calls.append(out.shape)
        return out

    monkeypatch.setattr(te, "host_fetch", counting)
    for depth in (0, 2):
        calls.clear()
        eng = Engine(ServeConfig(lanes=2, chunk=4, buckets=(12,),
                                 dispatch_depth=depth, emit_records=False),
                     device="cpu")
        for n, nt in ((10, 13), (8, 21), (6, 5)):
            eng.submit(HeatConfig(n=n, ntime=nt))
        eng.results()
        s = eng.summary()
        boundaries = [c for c in calls if c == (te.K_BOUNDARY, 2)]
        assert len(boundaries) == s["boundary_waits"] == s["chunks_dispatched"]
        assert len(calls) - len(boundaries) == 3


def test_dispatch_depth_and_tails_keep_bytes():
    """Depth 1, 2, 3 and the synchronous fallback give the same bytes, with
    tail chunks dispatched at depth > 0."""
    reqs = matrix_requests(2, "float32", ("ghost", "edges"))
    out = {}
    for depth in (0, 1, 2, 3):
        eng, recs = _drain(Engine, ServeConfig, HeatConfig, reqs, lanes=2,
                           chunk=8, buckets=(12,), dispatch_depth=depth)
        out[depth] = [r["T"].tobytes() for r in recs]
        assert (eng.tail_chunks > 0) == (depth > 0)
    assert out[0] == out[1] == out[2] == out[3]


def _serve_cli(tmp_path, lines, *extra):
    f = tmp_path / "req.jsonl"
    f.write_text("\n".join(lines) + "\n")
    return subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch", "serve", "--requests",
         str(f), "--device", "cpu", "--lanes", "2", "--chunk", "4",
         "--buckets", "12", "--out-dir", str(tmp_path / "out"), "--json",
         *extra], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env={"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin"})


def test_cli_serve_end_to_end(tmp_path):
    lines = ['# two buckets of work, one file',
             '{"id": "a", "n": 10, "ntime": 13, "bc": "ghost"}',
             '{"id": "b", "n": 6, "ntime": 9, "ndim": 3, "sigma": 0.15, '
             '"dtype": "bfloat16"}',
             '{"id": "c", "n": 12, "ntime": 0}']
    out = _serve_cli(tmp_path, lines)
    assert out.returncode == 0, out.stderr
    recs = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith('{"bc"')]
    assert sorted(r["id"] for r in recs) == ["a", "b", "c"]
    assert all(r["status"] == "ok" for r in recs)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"] == 3 and summary["device"] == "cpu"
    assert sorted(p.name for p in (tmp_path / "out").glob("*.npz")) == [
        "a.npz", "b.npz", "c.npz"]
    with np.load(tmp_path / "out" / "b.npz") as z:
        assert z["T"].dtype == np.dtype("V2") and z["T"].shape == (6, 6, 6)


def test_cli_serve_malformed_line_exits_1(tmp_path):
    out = _serve_cli(tmp_path, ['{"id": "a", "n": 10, "ntime": 4}',
                                '{"id": "b", "n": 10, "bogus": 1}',
                                'not json'])
    assert out.returncode == 1, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"] == 1 and summary["rejected"] == 2


def test_cli_serve_needs_a_card_unless_cpu(tmp_path):
    f = tmp_path / "req.jsonl"
    f.write_text('{"n": 8, "ntime": 2}\n')
    out = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch", "serve", "--requests",
         str(f)], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and "device='cpu'" in out.stderr


def test_serve_requests_library_call(tmp_path):
    f = tmp_path / "req.jsonl"
    f.write_text('{"id": "x", "n": 9, "ntime": 7, "tenant": "acme", '
                 '"class": "interactive"}\n{"id": "y", "n": 9, "tol": 1}\n')
    records, summary = serve_requests(
        f, ServeConfig(buckets=(12,), emit_records=False), device="cpu")
    by_id = {r["id"]: r for r in records}
    assert by_id["x"]["status"] == "ok" and by_id["x"]["tenant"] == "acme"
    assert by_id["y"]["status"] == "rejected" and "tol" in by_id["y"]["error"]
    assert summary["requests"] == 2 and summary["rejected"] == 1


@pytest.mark.parametrize("policy", ["fifo", "edf", "fair"])
def test_policy_pop_order_is_the_reference(policy):
    """The port's admission queues pop a seeded mix of tenants, classes,
    deadlines and sizes in the reference's order, pushes and pops
    interleaved (fair-share weights included)."""
    from types import SimpleNamespace

    from heat_tpu.serve import policy as jpolicy
    from heat_tpu_torch.serve import policy as tpolicy

    rng = np.random.default_rng(3)
    weights = (("acme", 3.0), ("beta", 1.0))
    jq = jpolicy.make_queue(policy, weights)
    tq = tpolicy.make_queue(policy, weights)
    got, want = [], []
    for seq in range(60):
        n = int(rng.integers(8, 64))
        req = SimpleNamespace(
            id=f"r{seq}", seq=seq, until="steps",
            tenant=str(rng.choice(["acme", "beta", "gamma"])),
            slo_class=str(rng.choice(["interactive", "standard", "batch"])),
            deadline_t=(None if rng.random() < 0.4
                        else float(rng.uniform(0, 10))),
            cfg=SimpleNamespace(points=n * n,
                                ntime=int(rng.integers(0, 500))))
        jq.push(req)
        tq.push(req)
        if rng.random() < 0.4:
            want.append(jq.pop().id)
            got.append(tq.pop().id)
    while jq:
        want.append(jq.pop().id)
        got.append(tq.pop().id)
    assert got == want and not tq and tq.pop() is None


_VALIDATOR_CASES = [
    ("parse_dispatch_depth", ("on",)), ("parse_dispatch_depth", (" OFF ",)),
    ("parse_dispatch_depth", ("3",)), ("parse_dispatch_depth", ("0",)),
    ("parse_dispatch_depth", ("x",)),
    ("parse_on_off", ("On", "--numerics")), ("parse_on_off", ("off", "--x")),
    ("parse_on_off", ("maybe", "--x")),
    ("parse_tenant_weights", ("a=4, b=1",)), ("parse_tenant_weights", ("",)),
    ("parse_tenant_weights", ("a",)), ("parse_tenant_weights", ("a=0",)),
    ("parse_tenant_weights", ("a b=1",)), ("parse_tenant_weights", ("a=x",)),
    ("validate_slo_fields", (None, None)),
    ("validate_slo_fields", ("acme", "interactive")),
    ("validate_slo_fields", ("a b", None)), ("validate_slo_fields", (None, "gold")),
    ("validate_until_fields", (None, None)),
    ("validate_until_fields", ("steady", "1e-6")),
    ("validate_until_fields", ("steps", 1e-6)),
    ("validate_until_fields", ("forever", None)),
    ("validate_until_fields", ("steady", -1)),
    ("validate_until_fields", ("steady", float("inf"))),
    ("config_from_request", ({"n": 10, "ntime": 5},)),
    ("config_from_request", ({"n": "12", "ntime": 3.0, "sigma": "0.2",
                              "ndim": 3, "bc": "ghost", "bc_value": 2},)),
    ("config_from_request", ({"n": 10, "id": "x", "deadline_ms": 5,
                              "tenant": "a", "class": "batch",
                              "until": "steps"},)),
    ("config_from_request", ({"n": 10, "bogus": 1},)),
    ("config_from_request", ({"n": 10, "backend": "xla"},)),
    ("config_from_request", ({"n": 2},)),
]
_PHYSICS = ("n", "sigma", "nu", "dom_len", "ntime", "ndim", "dtype", "ic",
            "bc", "bc_value")


@pytest.mark.parametrize("name,args", _VALIDATOR_CASES)
def test_request_validators_are_the_reference(name, args):
    """The request/CLI validators copied into heat_tpu_torch.config give the
    reference's value, or raise ValueError where it does."""
    from heat_tpu import config as jconfig
    from heat_tpu_torch import config as tconfig

    def call(mod):
        try:
            out = getattr(mod, name)(*args)
        except ValueError:
            return "ValueError"
        if name == "config_from_request":
            return {k: getattr(out, k) for k in _PHYSICS}
        return out

    assert call(tconfig) == call(jconfig)
    assert tconfig.SLO_CLASSES == jconfig.SLO_CLASSES
    assert tconfig._REQUEST_KEYS == jconfig._REQUEST_KEYS
    assert tconfig._SCHEDULER_KEYS == jconfig._SCHEDULER_KEYS
    assert (tconfig.DEFAULT_TENANT, tconfig.DEFAULT_SLO_CLASS) == \
        (jconfig.DEFAULT_TENANT, jconfig.DEFAULT_SLO_CLASS)
