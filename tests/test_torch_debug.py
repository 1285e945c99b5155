"""The lock-order watchdog and the race sanitizer of the port
(``heat_tpu_torch.runtime.debug``) against heat_tpu's on the same scripts,
armed the same way; the port's ``make_lock`` / ``instrument_races`` sites
against the reference's; armed port engines on the CPU with zero
inversions and zero races.

Each script runs once per package with the same environment; what it
returns (the error raised and its message, the stats) must be equal.
"""

import ast
import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from heat_tpu.runtime import debug as ref_debug
from heat_tpu_torch.runtime import debug as port_debug

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"ref": ref_debug, "port": port_debug}


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_LOCKCHECK", "1")
    monkeypatch.setenv("HEAT_TPU_RACECHECK", "1")
    for d in PACKAGES.values():
        d.reset_lock_order_stats()
        d.reset_race_stats()
    yield
    for d in PACKAGES.values():
        d.reset_lock_order_stats()
        d.reset_race_stats()
        d.set_flight_dump_hook(None)


def _outcome(fn, d):
    try:
        res = fn(d)
        err = None
    except Exception as e:   # noqa: BLE001 — the outcome is compared
        res, err = None, (type(e).__name__, str(e))
    stats = d.lock_order_stats()
    return dict(result=res, error=err, edges=stats["edges"],
                violations=stats["violations"],
                findings=d.race_stats()["findings"],
                instrumented=d.race_stats()["instrumented"])


def _both(fn):
    return {name: _outcome(fn, d) for name, d in PACKAGES.items()}


# --- (d) the watchdog on inverted acquisition sequences ----------------------

def _inversion(d):
    eng = d.make_lock("engine")
    obs = d.make_lock("observatory:ledger")
    with eng:
        with obs:
            pass
    with obs:
        with eng:
            pass


def _same_rank(d):
    a = d.make_lock("observatory:a")
    b = d.make_lock("observatory:b")
    with a:
        with b:
            pass


def _reentrant(d):
    eng = d.make_lock("engine")
    with eng:
        with eng:
            pass


def _fleet_order(d):
    router = d.make_lock("fleet:router")
    gate = d.make_lock("gateway:drain")
    eng = d.make_lock("engine")
    cache = d.make_lock("cache:solve")
    with router:
        with gate:
            with eng:
                with cache:
                    pass
    with cache:
        with d.make_lock("writer:exc"):
            pass


def _condition(d):
    lk = d.make_lock("engine")
    cond = threading.Condition(lk)
    hits = []

    def waiter():
        with cond:
            hits.append("in")
            cond.wait(timeout=2.0)
            hits.append("out")

    t = threading.Thread(target=waiter)
    t.start()
    while "in" not in hits:
        pass
    with cond:
        cond.notify_all()
    t.join(timeout=5)
    return hits, d.held_locks()


def _try_acquire(d):
    lk = d.make_lock("engine")
    obs = d.make_lock("observatory:x")
    with obs:
        got = lk.acquire(blocking=False)
    return got


@pytest.mark.parametrize("script", [_inversion, _same_rank, _reentrant,
                                    _fleet_order, _condition, _try_acquire],
                         ids=lambda f: f.__name__.strip("_"))
def test_watchdog_matches_the_reference(script, armed):
    got = _both(script)
    assert got["port"] == got["ref"]
    if script in (_inversion, _same_rank, _reentrant, _try_acquire):
        assert got["port"]["error"][0] == "LockOrderError"


def test_unknown_rank_raises_as_the_reference():
    msgs = []
    for d in PACKAGES.values():
        with pytest.raises(ValueError) as e:
            d.make_lock("mystery:thing")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_unarmed_make_lock_is_a_plain_lock(monkeypatch):
    monkeypatch.delenv("HEAT_TPU_LOCKCHECK", raising=False)
    monkeypatch.delenv("HEAT_TPU_RACECHECK", raising=False)
    lk = port_debug.make_lock("engine")
    assert type(lk) is type(threading.Lock())

    class Box:
        def __init__(self):
            self.counter = 0

    b = Box()
    assert port_debug.instrument_races(b, label="Box") is b
    assert type(b) is Box
    assert port_debug.race_stats()["instrumented"] == 0
    assert port_debug.guard_report() is None


def test_lock_table_is_the_reference_table():
    assert port_debug.LOCK_RANKS == ref_debug.LOCK_RANKS


# --- (d) the sanitizer on the same two-thread scripts ------------------------

class _Box:
    def __init__(self, d, exempt=frozenset()):
        self.lock = d.make_lock("engine:box")
        self.counter = 0
        d.instrument_races(self, label="Box", exempt=exempt)


def _run_thread(fn, name):
    t = threading.Thread(target=fn, name=name)
    t.start()
    t.join(timeout=10)


def _bare_write(d):
    b = _Box(d)
    b.counter = 1
    err = []

    def bad():
        try:
            b.counter = 2
        except d.RaceError as e:
            err.append(str(e))

    _run_thread(bad, "second-writer")
    return err


def _guarded(d):
    b = _Box(d)

    def work():
        for _ in range(50):
            with b.lock:
                b.counter += 1

    ts = [threading.Thread(target=work, name=f"w{i}") for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    return b.counter


def _cond_and_try(d):
    b = _Box(d)
    cond = threading.Condition(b.lock)

    def via_cond():
        for _ in range(20):
            with cond:
                b.counter += 1

    def via_try():
        for _ in range(20):
            while not b.lock.acquire(blocking=False):
                pass
            try:
                b.counter += 1
            finally:
                b.lock.release()

    ts = [threading.Thread(target=via_cond, name="cond"),
          threading.Thread(target=via_try, name="try")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    return b.counter


def _exempt(d):
    b = _Box(d, exempt=frozenset({"counter"}))
    b.counter = 1
    _run_thread(lambda: setattr(b, "counter", 2), "second-writer")
    return b.counter


@pytest.mark.parametrize("script", [_bare_write, _guarded, _cond_and_try,
                                    _exempt],
                         ids=lambda f: f.__name__.strip("_"))
def test_sanitizer_matches_the_reference(script, armed):
    got = _both(script)
    assert got["port"] == got["ref"]
    if script is _bare_write:
        (msg,) = got["port"]["result"]
        assert "Box.counter" in msg and "empty lockset intersection" in msg
        assert len(got["port"]["findings"]) == 1


def test_record_mode_logs_as_the_reference(monkeypatch, capsys):
    monkeypatch.setenv("HEAT_TPU_RACECHECK", "record")
    out = {}
    for name, d in PACKAGES.items():
        d.reset_race_stats()
        dumps = []
        d.set_flight_dump_hook(dumps.append)
        try:
            b = _Box(d)
            b.counter = 1
            _run_thread(lambda: setattr(b, "counter", 2), "second-writer")
            lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                     if x.startswith("{")]
            out[name] = (lines, dumps, d.race_stats()["findings"])
        finally:
            d.set_flight_dump_hook(None)
            d.reset_race_stats()
    assert out["port"] == out["ref"]
    (rec,), dumps, findings = out["port"]
    assert rec["event"] == "race_detected" and rec["field"] == "counter"
    assert dumps and "race" in dumps[0] and len(findings) == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_thread_crash_record_as_the_reference(capsys):
    out = {}
    for name, d in PACKAGES.items():
        d.install_thread_excepthook()
        dumps = []
        d.set_flight_dump_hook(dumps.append)
        try:
            def boom():
                raise ValueError("seeded crash")

            _run_thread(boom, "crash-fixture")
            lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                     if x.startswith('{"')]
            out[name] = ([x for x in lines if x["event"] == "thread_crash"],
                         [x for x in dumps if "crash-fixture" in x])
        finally:
            d.set_flight_dump_hook(None)
    # both hooks chain: each crash reaches every installed hook once
    assert out["port"][0] and out["port"][0][0] == out["ref"][0][0]
    assert out["port"][0][0]["thread"] == "crash-fixture"
    assert out["port"][1] and out["ref"][1]


# --- (e) the sites: every reference make_lock / instrument_races has its
# counterpart in the port --------------------------------------------------

def _const(node):
    """A call argument as text: a constant, or an f-string with its
    fields as {}."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.JoinedStr):
        return "".join(v.value if isinstance(v, ast.Constant) else "{}"
                       for v in node.values)
    return None


def _sites(pkg: Path):
    """{(module path, kind, name or label): exempt set} over a package."""
    out = {}
    for p in sorted(pkg.rglob("*.py")):
        rel = p.relative_to(pkg).as_posix()
        if rel.startswith(("analysis/", "runtime/debug.py")):
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            if name == "make_lock" and node.args:
                out[(rel, "make_lock", _const(node.args[0]))] = None
            elif name == "instrument_races":
                kw = {k.arg: k.value for k in node.keywords}
                label = _const(kw["label"]) if "label" in kw else None
                exempt = kw.get("exempt")
                names = (sorted(_const(e) for e in exempt.args[0].elts)
                         if exempt is not None else [])
                out[(rel, "instrument_races", label)] = names
            elif name in ("install_thread_excepthook", "set_flight_dump_hook"):
                out[(rel, name, None)] = None
    return out


# Sites the port has and the reference lacks, or the other way round, with
# the reason; empty: every site has its counterpart.
DEPARTURES: dict = {}


def test_every_reference_site_has_its_counterpart():
    ref = _sites(REPO / "heat_tpu")
    port = _sites(REPO / "heat_tpu_torch")
    assert len(ref) >= 25
    missing = sorted(set(ref) - set(port) - set(DEPARTURES))
    extra = sorted(set(port) - set(ref) - set(DEPARTURES))
    assert missing == [] and extra == [], (missing, extra)
    for key in set(ref) & set(port):
        assert port[key] == ref[key], key


# --- armed port engines on the CPU --------------------------------------------

def _wave(**kw):
    from heat_tpu_torch.config import HeatConfig
    from heat_tpu_torch.serve import Engine, ServeConfig

    eng = Engine(ServeConfig(lanes=2, chunk=4, buckets=(32,),
                             emit_records=False, keep_fields=True, **kw),
                 device="cpu")
    for i in range(4):
        eng.submit(HeatConfig(n=16 + i, ntime=12 + 3 * i,
                              dtype=("float32", "bfloat16")[i % 2]))
    return eng


@pytest.mark.parametrize("depth", [0, 2])
def test_armed_engine_wave_has_no_violation(depth, armed, tmp_path):
    eng = _wave(dispatch_depth=depth, out_dir=str(tmp_path / "out"),
                cache=True, cache_dir=str(tmp_path / "cache"),
                engine_ckpt_interval=2,
                engine_ckpt_dir=str(tmp_path / "ck"))
    assert [r["status"] for r in eng.results()] == ["ok"] * 4
    locks, races = port_debug.lock_order_stats(), port_debug.race_stats()
    assert locks["violations"] == [] and races["findings"] == []
    assert any(e[0] == "engine" and e[1].startswith("observatory")
               for e in locks["edges"])
    assert set(locks["taken"]) >= {"engine", "writer", "cache",
                                   "observatory"}
    assert races["instrumented"] >= 4   # engine, writer, tracer, cache


def test_armed_online_engine_has_no_violation(armed):
    from heat_tpu_torch.config import HeatConfig
    from heat_tpu_torch.serve import Engine, ServeConfig

    eng = Engine(ServeConfig(lanes=2, chunk=4, buckets=(32,),
                             emit_records=False, keep_fields=True),
                 device="cpu")
    eng.start()
    try:
        for i in range(4):
            eng.submit(HeatConfig(n=16, ntime=12 + i, dtype="float32"))
        eng.begin_drain()
        assert eng.shutdown(timeout=120)
    finally:
        eng.shutdown(timeout=120)
    assert eng.loop_error is None
    assert port_debug.lock_order_stats()["violations"] == []
    assert port_debug.race_stats()["findings"] == []


def test_armed_serve_cli_reports_the_guard(tmp_path):
    """``serve --json`` carries ``invariant_guard`` only when armed."""
    req = tmp_path / "req.jsonl"
    req.write_text('{"id": "a", "n": 20, "ntime": 30}\n'
                   '{"id": "b", "n": 12, "ntime": 20, "ndim": 3}\n')
    base = [sys.executable, "-m", "heat_tpu_torch", "serve", "--requests",
            str(req), "--device", "cpu", "--buckets", "32", "--json",
            "--out-dir", str(tmp_path / "out")]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    summaries = {}
    for armed_env in ({}, {"HEAT_TPU_LOCKCHECK": "1",
                           "HEAT_TPU_RACECHECK": "record"}):
        proc = subprocess.run(base, capture_output=True, text=True,
                              timeout=300, env={**env, **armed_env})
        assert proc.returncode == 0, proc.stderr[-2000:]
        summaries[bool(armed_env)] = json.loads(
            proc.stdout.strip().splitlines()[-1])
    assert "invariant_guard" not in summaries[False]
    guard = summaries[True]["invariant_guard"]
    assert guard["lockcheck"] and guard["racecheck"]
    assert guard["lock_order_violations"] == guard["races_detected"] == 0
    assert guard["race_instrumented"] >= 3
