"""The fleet's pure pieces of the port against heat_tpu's, socket-free.

Placement (``choose``, ``eligible``, ``burn_demoted``,
``brownout_level``, the backlog scores), the backend-spec and
backends-file grammar, the circuit breaker and retry budget under one
event script, ``backoff_s`` under one seeded ``random.Random``, the five
fleet fault kinds and ``merge_usage`` go through both packages on the same
inputs, made from ``numpy.random.default_rng(seed)``: decisions, traces
and errors must be equal, and floats equal bit for bit. The live router
is ``tests/test_torch_fleet.py``.
"""

import ast
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from heat_tpu.fleet import placement as jplacement
from heat_tpu.fleet import registry as jregistry
from heat_tpu.fleet import resilience as jresilience
from heat_tpu.fleet.router import merge_usage as jmerge_usage
from heat_tpu.runtime import faults as jfaults
from heat_tpu_torch.fleet import placement, registry, resilience
from heat_tpu_torch.fleet.router import merge_usage
from heat_tpu_torch.runtime import faults

_REPO = Path(__file__).resolve().parent.parent
SEEDS = range(8)


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _same_float(a, b) -> bool:
    return float(a).hex() == float(b).hex()


def random_status(rng, labels=("cuda", "torch")):
    """A /v1/status payload with the fields placement reads, or None (a
    backend not probed yet)."""
    if rng.random() < 0.15:
        return None
    rows = []
    for _ in range(int(rng.integers(0, 4))):
        rows.append({"bucket": f"2d/n{int(rng.choice([32, 64]))}/l2",
                     "kernel": str(rng.choice(labels)),
                     "ewma_s_per_lane_step": (
                         None if rng.random() < 0.2
                         else float(rng.uniform(1e-6, 1e-2))),
                     "chunks": int(rng.integers(0, 300))})
    burn = {}
    for cls in ("interactive", "standard", "batch"):
        if rng.random() < 0.6:
            burn[cls] = {"fast_burn": (None if rng.random() < 0.1 else
                                       float(rng.uniform(0, 3))),
                         "slow_burn": (None if rng.random() < 0.1 else
                                       float(rng.uniform(0, 3)))}
    return {"backlog": {"queued_steps": int(rng.integers(0, 50_000)),
                        "running_steps_bound": int(rng.integers(0, 5000))},
            "cost_model": rows, "slo_burn": burn,
            "mega": {"capable": bool(rng.random() < 0.3),
                     "max_bucket": int(rng.choice([0, 32, 64, 1024]))}}


def twin_fleets(rng, count):
    """The same fleet as port and reference ``Backend`` objects."""
    ours, theirs = [], []
    for i in range(count):
        st = random_status(rng)
        flags = dict(healthy=bool(rng.random() < 0.85),
                     fault_down=bool(rng.random() < 0.1),
                     lost=bool(rng.random() < 0.1),
                     pending_steps=int(rng.integers(0, 3000)))
        for mod, out in ((registry, ours), (jregistry, theirs)):
            b = mod.Backend(f"b{i}", f"127.0.0.1:{7000 + i}")
            b.status = json.loads(json.dumps(st))
            for k, v in flags.items():
                setattr(b, k, v)
            out.append(b)
    return ours, theirs


def test_constants_equal_the_reference():
    assert placement.POLICIES == jplacement.POLICIES
    for name in ("PRIOR_S_PER_LANE_STEP", "TIE_REL", "BURN_THRESHOLD"):
        assert _same_float(getattr(placement, name),
                           getattr(jplacement, name)), name
    assert resilience.STATE_CODES == jresilience.STATE_CODES
    for name in ("TRIP_THRESHOLD", "BURN_TRIP_TICKS", "COOLDOWN_MAX_S"):
        assert (getattr(resilience.Breaker, name)
                == getattr(jresilience.Breaker, name)), name


@pytest.mark.parametrize("policy", placement.POLICIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_placement_decisions_equal_the_reference(seed, policy):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ours, theirs = twin_fleets(rng, int(rng.integers(1, 6)))
        for a, b in zip(ours, theirs):
            assert placement.burn_demoted(a.status) == \
                jplacement.burn_demoted(b.status)
            assert placement.backlog_steps(a) == jplacement.backlog_steps(b)
            assert _same_float(placement.s_per_lane_step(a.status),
                               jplacement.s_per_lane_step(b.status))
            assert _same_float(placement.predicted_backlog_s(a),
                               jplacement.predicted_backlog_s(b))
        assert placement.brownout_level(ours) == \
            jplacement.brownout_level(theirs)
        for _ in range(6):
            n = (None if rng.random() < 0.1
                 else int(rng.choice([16, 32, 48, 64, 2048])))
            rr = int(rng.integers(0, 100))
            prefer = ({f"b{int(i)}" for i in rng.integers(0, 6, 2)}
                      if rng.random() < 0.3 else None)
            assert ([b.name for b in placement.eligible(ours, n)]
                    == [b.name for b in jplacement.eligible(theirs, n)])
            got, gdec = placement.choose(policy, ours, n, rr, prefer=prefer)
            want, wdec = jplacement.choose(policy, theirs, n, rr,
                                           prefer=prefer)
            assert (got and got.name) == (want and want.name)
            assert gdec == wdec
            for k, v in gdec.get("backlog_s", {}).items():
                assert _same_float(v, wdec["backlog_s"][k])


def test_cost_model_label_moves_no_decision():
    """The port's rows say cuda/torch where the reference's say
    pallas/xla: the same rows under either label give the same scores and
    choices."""
    rng = np.random.default_rng(11)
    for _ in range(50):
        ours, _ = twin_fleets(rng, 4)
        relabelled = []
        for b in ours:
            c = registry.Backend(b.name, b.address)
            c.__dict__.update(json.loads(json.dumps(
                {k: v for k, v in b.__dict__.items()})))
            for row in (c.status or {}).get("cost_model") or []:
                row["kernel"] = {"cuda": "pallas", "torch": "xla"}[
                    row["kernel"]]
            relabelled.append(c)
        for a, c in zip(ours, relabelled):
            assert _same_float(placement.predicted_backlog_s(a),
                               placement.predicted_backlog_s(c))
        for rr in range(4):
            assert (placement.choose("least-loaded", ours, 32, rr)[1]
                    == placement.choose("least-loaded", relabelled, 32,
                                        rr)[1])


GOOD_SPECS = ["10.0.0.1:8080, east=10.0.0.2:9090 ,10.0.0.3:70",
              "a=127.0.0.1:1", "127.0.0.1:1,,127.0.0.1:2",
              "x=[::1]:80,y=host.example:443", ""]
BAD_SPECS = ["nohost", "host:", ":123", "h:12x",
             "a=1.2.3.4:80,a=4.3.2.1:80", "x=1.1.1.1:1,y=1.1.1.1:1",
             "b1=1.1.1.1:1,1.1.1.1:2", "1.1.1.1:1,1.1.1.1:1"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_backends_equals_the_reference(spec):
    assert registry.parse_backends(spec) == jregistry.parse_backends(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_backends_rejects_as_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jregistry.parse_backends(spec)
    with pytest.raises(ValueError) as got:
        registry.parse_backends(spec)
    assert str(got.value) == str(want.value)


def test_backends_file_grammar_and_live_join_as_the_reference(tmp_path):
    import os

    f = tmp_path / "backends.txt"
    f.write_text("# fleet members\none=127.0.0.1:7001\n\n127.0.0.1:7002  "
                 "# unnamed -> positional\n")
    assert registry.load_backends_file(f) == \
        jregistry.load_backends_file(f)
    regs = [registry.BackendRegistry(backends_file=f),
            jregistry.BackendRegistry(backends_file=f)]
    assert [[b.name for b in r.snapshot()] for r in regs] == \
        [["one", "b1"]] * 2
    assert [r.refresh_file() for r in regs] == [[], []]
    f.write_text(f.read_text() + "late=127.0.0.1:7003\n")
    os.utime(f, (0, 2**31 - 1))
    assert [r.refresh_file() for r in regs] == [["late"], ["late"]]
    # removing every line never evicts a live member
    f.write_text("")
    os.utime(f, (0, 2**31 - 2))
    assert [r.refresh_file() for r in regs] == [[], []]
    assert [len(r.snapshot()) for r in regs] == [3, 3]
    f.write_text("dup=1.1.1.1:1\ndup=1.1.1.1:2\n")
    with pytest.raises(ValueError) as want:
        jregistry.load_backends_file(f)
    with pytest.raises(ValueError) as got:
        registry.load_backends_file(f)
    assert str(got.value) == str(want.value)


def test_registry_accounting_equals_the_reference():
    """The probe fold, fault-down, lost/found and the pending accounting
    under one script: every backend field equal after every call."""
    fields = ("healthy", "draining", "lost", "fault_down", "probe_passes",
              "probe_fails", "consecutive_failures", "status", "status_t",
              "pending_steps", "pending_requests", "routed", "delivered",
              "retried", "stolen_from", "stolen_to")
    spec = "b0=127.0.0.1:1,b1=127.0.0.1:2"
    regs = [registry.BackendRegistry(registry.parse_backends(spec)),
            jregistry.BackendRegistry(jregistry.parse_backends(spec))]
    rng = np.random.default_rng(5)
    for t in range(300):
        name = f"b{int(rng.integers(0, 3))}"     # b2 is not a member
        op = int(rng.integers(0, 8))
        args = {0: ("note_probe", (name, bool(rng.random() < 0.7)),
                    dict(draining=bool(rng.random() < 0.1),
                         status={"t": t}, now=float(t))),
                1: ("set_fault_down", (name, bool(rng.random() < 0.5)), {}),
                2: ("mark_lost", (name,), {}),
                3: ("mark_found", (name,), {}),
                4: ("note_routed", (name, 2, 96), {}),
                5: ("note_done", (name, 48), {}),
                6: ("note_unrouted", (name, 1, 64), {}),
                7: ("note_steal", (name, f"b{int(rng.integers(0, 2))}"),
                    {})}[op]
        outs = []
        for r in regs:
            out = getattr(r, args[0])(*args[1], **args[2])
            outs.append(out.name if hasattr(out, "name") else out)
        assert outs[0] == outs[1], (t, args)
        for a, b in zip(*(r.snapshot() for r in regs)):
            assert {k: getattr(a, k) for k in fields} == \
                {k: getattr(b, k) for k in fields}, (t, args)


def breaker_script(rng, length=200):
    """A feed of breaker events on a clock that only moves forward."""
    now, out = 0.0, []
    for _ in range(length):
        now += float(rng.exponential(1.5))
        kind = str(rng.choice(["success", "error", "trip", "burn",
                               "half-open", "canary"]))
        out.append((kind, now, bool(rng.random() < 0.5)))
    return out


def _feed(br, kind, now, flag):
    return {"success": lambda: br.note_success(),
            "error": lambda: br.note_error("relay", now),
            "trip": lambda: br.trip("lost", now),
            "burn": lambda: br.note_burn(flag, now),
            "half-open": lambda: br.try_half_open(now),
            "canary": lambda: br.canary_result(flag, now)}[kind]()


@pytest.mark.parametrize("seed", SEEDS)
def test_breaker_traces_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(trip_threshold=int(rng.integers(1, 5)),
              cooldown_s=float(rng.uniform(0.5, 8)),
              burn_trip_ticks=int(rng.integers(1, 10)))
    ours = resilience.Breaker("b0", **kw)
    theirs = jresilience.Breaker("b0", **kw)
    for kind, now, flag in breaker_script(rng):
        assert _feed(ours, kind, now, flag) == _feed(theirs, kind, now,
                                                     flag)
        assert ours.snapshot() == theirs.snapshot()
        assert ours.allows() == theirs.allows()
    assert (resilience.breaker_rows([ours, resilience.Breaker("a")])
            == jresilience.breaker_rows([theirs, jresilience.Breaker("a")]))


@pytest.mark.parametrize("seed", SEEDS)
def test_retry_budget_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    cap, ratio = float(rng.uniform(1, 30)), float(rng.uniform(0.05, 1))
    ours = resilience.RetryBudget(cap, ratio)
    theirs = jresilience.RetryBudget(cap, ratio)
    for _ in range(300):
        if rng.random() < 0.55:
            assert ours.take() == theirs.take()
        else:
            n = int(rng.integers(1, 4))
            ours.credit(n)
            theirs.credit(n)
        assert ours.snapshot() == theirs.snapshot()


@pytest.mark.parametrize("seed", SEEDS)
def test_backoff_equals_the_reference_for_a_seeded_rng(seed):
    ours, theirs = random.Random(seed), random.Random(seed)
    for hop in list(range(-1, 12)) * 3:
        for base, cap in ((0.05, 2.0), (0.2, 0.3), (1e-3, 10.0)):
            a = resilience.backoff_s(hop, base, cap, rng=ours)
            b = jresilience.backoff_s(hop, base, cap, rng=theirs)
            assert _same_float(a, b)
            assert 0.5 * min(cap, base) <= a <= cap
    # the module RNG when none is given: the reference's bounds
    for hop in range(6):
        v = resilience.backoff_s(hop)
        assert min(2.0, 0.05 * 2 ** hop) * 0.5 <= v <= min(2.0,
                                                           0.05 * 2 ** hop)


FLEET_SPECS = ["backend-down@3:backend=b1", "backend-down@1",
               "backend-slow:ms=25", "backend-flap:period=500:backend=b1",
               "backend-flap:period=40:times=3", "stream-cut@2:backend=b0",
               "stream-cut@5", "backend-partition", "backend-partition:"
               "backend=b1:ms=250", "backend-down@2,stream-cut@1:backend=b1,"
               "backend-flap:period=100:restart=-1",
               "lane-nan@3,backend-slow:ms=1"]
BAD_FLEET_SPECS = ["backend-down", "backend-down:backend=b1", "stream-cut",
                   "backend-flap", "backend-flap:period=0",
                   "backend-flap:period=-5:backend=b0",
                   "backend-slow:ms=fast", "backend-down@x",
                   "backend-partition:who=b1", "backend-flap:period=x"]


def _fields(f):
    return (f.kind, f.step, f.proc, f.times, f.ms, f.restart, f.req, f.eps,
            f.backend, f.period)


@pytest.mark.parametrize("spec", FLEET_SPECS)
def test_fleet_fault_kinds_parse_and_fire_as_the_reference(spec,
                                                           monkeypatch):
    assert [_fields(f) for f in faults.parse_spec(spec)] == \
        [_fields(f) for f in jfaults.parse_spec(spec)]
    slept = []     # both modules sleep through the one time module
    monkeypatch.setattr(faults.time, "sleep", slept.append)
    p, j = faults.plan_for_spec(spec), jfaults.plan_for_spec(spec)
    assert faults.plan_for_spec(spec) is p          # cached per spec
    for nth in range(12):
        assert p.backend_down_target(nth) == j.backend_down_target(nth)
        p.backend_slow()
        ours = slept[:]
        slept.clear()
        j.backend_slow()
        assert ours == slept
        slept.clear()
        for b in ("b0", "b1", "b2"):
            assert p.stream_cut_fire(b, nth) == j.stream_cut_fire(b, nth)
            assert p.backend_partition_ms(b) == j.backend_partition_ms(b)
    for t in np.arange(0.0, 3.0, 0.013):
        assert p.backend_flap_states(100.0 + t) == \
            j.backend_flap_states(100.0 + t)


@pytest.mark.parametrize("spec", BAD_FLEET_SPECS)
def test_bad_fleet_fault_specs_refused_as_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        faults.parse_spec(spec)
    assert str(got.value) == str(want.value)


def test_fleet_faults_are_restart_gated(monkeypatch):
    monkeypatch.setenv(faults.RESTART_ENV_VAR, "1")
    p = faults.plan_for_spec("backend-down@1,backend-partition:ms=5")
    assert p.backend_down_target(3) is None
    assert p.backend_partition_ms("b0") is None
    q = faults.plan_for_spec("backend-down@1:restart=1")
    assert q.backend_down_target(1) == ""


def test_empty_spec_stays_none():
    assert faults.plan_for_spec("") is None
    assert faults.plan_for_spec(None) is None
    assert faults.plan_for_spec("  ") is None


def test_merge_usage_equals_the_reference():
    rng = np.random.default_rng(3)
    per_backend = {}
    for name in ("b0", "b1", "_edge"):
        tenants, totals = {}, {}
        for t in ("acme", "default", "_hedge"):
            c = {"lane_s": float(rng.uniform(0, 5)),
                 "steps": int(rng.integers(0, 10_000)),
                 "chunks": int(rng.integers(0, 600)),
                 "bytes_written": int(rng.integers(0, 10**7)),
                 "steps_saved": int(rng.integers(0, 100)),
                 "cached": int(rng.integers(0, 3)),
                 "requests": int(rng.integers(1, 20))}
            tenants[t] = {"classes": {"standard": c}}
            for k, v in c.items():
                totals[k] = totals.get(k, 0) + v
        per_backend[name] = {"tenants": tenants, "totals": totals}
    got = merge_usage(json.loads(json.dumps(per_backend)))
    want = jmerge_usage(json.loads(json.dumps(per_backend)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_fleet_modules_stay_import_light():
    """``placement`` and the package init import nothing; ``registry``
    and ``resilience`` only the standard library; importing
    ``fleet.placement`` loads neither torch nor the HTTP stack."""
    pkg = _REPO / "heat_tpu_torch" / "fleet"
    assert list(_imports(pkg / "__init__.py")) == []
    assert set(_imports(pkg / "placement.py")) <= {"__future__", "typing"}
    for name in ("registry.py", "resilience.py"):
        assert set(_imports(pkg / name)) <= {
            "__future__", "typing", "pathlib", "threading", "random"}, name
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, heat_tpu_torch.fleet.placement, "
         "heat_tpu_torch.fleet.registry, heat_tpu_torch.fleet.resilience; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'http', 'numpy', 'jax', 'heat_tpu')))"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
