"""``check`` over heat_tpu_torch: the AST rule families of the port held
against heat_tpu's on the same fixture trees, the port's own tree clean,
every family firing on a seeded fixture, the CUDA-source rules on mutated
copies of the shipped sources, and the rules seeing the real surface.

Families whose logic the port keeps unchanged (the allow markers, lock
discipline, races, record schema, dead code) must give the same
``(rule, path, line, message)`` as ``heat_tpu.analysis`` on the same tree;
the messages differ only in the command they name (``heat-tpu-torch
check`` for ``heat-tpu check``) and in the tree's own path.
"""

import json
import shutil
import textwrap
from pathlib import Path

import pytest

from heat_tpu.analysis import run_checks as ref_run_checks
from heat_tpu.analysis.deadcode import dead_code_report as ref_dead_code
from heat_tpu_torch.analysis import RULE_FAMILIES, run_checks
from heat_tpu_torch.analysis.core import Context
from heat_tpu_torch.analysis.deadcode import dead_code_report
from heat_tpu_torch.cli import main

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "heat_tpu_torch"


def _tree(base: Path, files: dict) -> Path:
    root = base / "pkg"
    for rel, body in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
    return root


def _norm(vs, root: Path):
    return [(v.rule, v.path, v.line,
             v.message.replace(str(root), "<root>").replace(
                 "heat-tpu-torch ", "heat-tpu "))
            for v in vs]


def _both(tmp_path, files, rules, **kw):
    """The same tree through both packages (two copies: a registry update
    writes into its tree). Returns ((ref violations, stats), (port ...),
    (ref root, port root))."""
    ra = _tree(tmp_path / "ref", files)
    rb = _tree(tmp_path / "port", files)
    a = ref_run_checks(ra, rules=rules, **kw)
    b = run_checks(rb, rules=rules, **kw)
    return a, b, (ra, rb)


def _same(a, b, roots):
    assert _norm(b[0], roots[1]) == _norm(a[0], roots[0])
    assert b[1]["stale_allows"] == a[1]["stale_allows"]
    assert b[1]["allow_markers"] == a[1]["allow_markers"]


# --- (a) the port against the reference on the same trees --------------------

_LOCK_TREES = {
    "seeded": {"serve/scheduler.py": """
        class Engine:
            def _emit(self, rec):
                with self._lock:
                    json_record("serve_request", id=rec["id"])
                    self.prof.note_terminal(rec, 0.0)
                    T = host_fetch(rec["T"])
    """},
    "reverse": {"runtime/prof.py": """
        class UsageLedger:
            def add(self, engine):
                with self._lock:
                    engine.submit(None)
    """},
    "nested": {"serve/scheduler.py": """
        class Engine:
            def poll(self):
                with self._lock:
                    with self._cond:
                        pass
    """, "runtime/trace.py": """
        _GLOBAL_LOCK = None

        class Tracer:
            def dump(self):
                with self._lock:
                    with _GLOBAL_LOCK:
                        pass
    """},
    "clean": {"serve/scheduler.py": """
        class Engine:
            def submit(self, cfg):
                with self._lock:
                    self._records.append(cfg)
                self.prof.observe_chunk("b", 1, 1, 1, 0.0)
    """, "runtime/prof.py": """
        class CostModel:
            def observe(self, v):
                with self._lock:
                    self._entries[v] = v
    """},
    "marked": {"serve/scheduler.py": """
        class Engine:
            def _emit(self, rec):
                with self._cond:
                    # heat-tpu: allow[lock-discipline] the engine lock IS
                    # the serialization point for record lines
                    json_record("serve_request", id=rec["id"])
    """},
}


@pytest.mark.parametrize("name", sorted(_LOCK_TREES))
def test_lock_discipline_matches_the_reference(name, tmp_path):
    a, b, roots = _both(tmp_path, _LOCK_TREES[name], ["lock-discipline"],
                        strict_allows=True)
    _same(a, b, roots)
    if name in ("seeded", "reverse", "nested"):
        assert b[0], "the seeded tree must fire"
    else:
        assert b[0] == []


_MARKER_TREES = {
    "bare": {"serve/scheduler.py": """
        class Engine:
            def _emit(self, rec):
                with self._lock:
                    # heat-tpu: allow[lock-discipline]
                    print(rec)
    """},
    "stale": {"serve/scheduler.py": """
        def pure(x):
            # heat-tpu: allow[lock-discipline] fixed long ago
            return x + 1
    """},
    "unknown": {"serve/scheduler.py": """
        def f(x):
            # heat-tpu: allow[no-such-rule] typo'd family id
            return x
    """},
    "string": {"docs_mod.py": """
        HINT = "write `# heat-tpu: allow[lock-discipline] reason` markers"
    """},
    "consumed": {"serve/scheduler.py": """
        class Engine:
            def _emit(self, rec):
                with self._lock:
                    print(rec)  # heat-tpu: allow[lock-discipline] the one seam
    """},
}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", sorted(_MARKER_TREES))
def test_allow_markers_match_the_reference(name, strict, tmp_path):
    a, b, roots = _both(tmp_path, _MARKER_TREES[name], ["lock-discipline"],
                        strict_allows=strict)
    _same(a, b, roots)


_PUMP = """
    import threading

    class Pump:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self._thread = None

        def start(self):
            self._thread = threading.Thread(target=self._worker,
                                            name="pump-worker")
            self._thread.start()

        def _worker(self):
            self.count += 1

        def bump(self):
            self.count += 1
"""
_GUARDED = _PUMP.replace("            self.count += 1",
                         "            with self._lock:\n"
                         "                self.count += 1")
_RACE_TREES = {
    "racy": {"serve/pump.py": _PUMP},
    "guarded": {"serve/pump.py": _GUARDED},
    "marked": {"serve/pump.py": _PUMP.replace(
        "            self.count += 1",
        "            self.count += 1  "
        "# heat-tpu: allow[races] GIL-atomic advisory counter")},
    "helper": {"serve/pump.py": """
        import threading

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def start(self):
                t = threading.Thread(target=self._worker, name="pump-worker")
                t.start()

            def _worker(self):
                with self._lock:
                    self._bump_locked()

            def bump(self):
                with self._lock:
                    self._bump_locked()

            def _bump_locked(self):
                self.count += 1
    """},
    "runner": {"serve/engine.py": """
        import threading

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self._cond = threading.Condition(self._lock)
                self.chunks = 0
                self.writer = SnapshotWriter()

            def start(self):
                threading.Thread(target=self._loop,
                                 name="heat-serve-scheduler").start()

            def _loop(self):
                r = _Runner(self)
                r.step()

            def submit(self, x):
                with self._cond:
                    self.chunks += 0

        class _Runner:
            def __init__(self, outer: "Engine"):
                self.outer = outer
                self.seq = 0

            def step(self):
                self.seq += 1
                with self.outer._lock:
                    self.outer.chunks += 1
                self.outer.writer.submit(self.step)

        class SnapshotWriter:
            def __init__(self):
                self._exc_lock = threading.Lock()
                self.done = 0

            def submit(self, job):
                self.done += 1
    """},
}


@pytest.mark.parametrize("name", sorted(_RACE_TREES))
def test_races_match_the_reference(name, tmp_path):
    files = _RACE_TREES[name]
    a, b, roots = _both(tmp_path, files, ["races"], update_schemas=True)
    _same(a, b, roots)
    ga = json.loads((roots[0] / "analysis/schemas/guards.json").read_text())
    gb = json.loads((roots[1] / "analysis/schemas/guards.json").read_text())
    assert gb["fields"] == ga["fields"]
    # the committed map in place: both gate the same way
    a, b, _ = (ref_run_checks(roots[0], rules=["races"]),
               run_checks(roots[1], rules=["races"]), None)
    _same(a, b, roots)


def test_races_drift_matches_the_reference(tmp_path):
    """No committed map, then a new shared field, then every field gone:
    the same drift findings from both packages."""
    files = {"serve/pump.py": _GUARDED}
    ra, rb = _tree(tmp_path / "ref", files), _tree(tmp_path / "port", files)
    a, b = ref_run_checks(ra, rules=["races"]), run_checks(rb, rules=["races"])
    _same(a, b, (ra, rb))
    assert b[0], "no committed map: the gate demands one"
    ref_run_checks(ra, rules=["races"], update_schemas=True)
    run_checks(rb, rules=["races"], update_schemas=True)
    for body in (_GUARDED.replace("        def _worker(self):",
                                  "        def tag(self):\n"
                                  "            self.flag = True\n\n"
                                  "        def _worker(self):"),
                 """
                 import threading

                 class Pump:
                     def __init__(self):
                         self._lock = threading.Lock()
                 """):
        for r in (ra, rb):
            (r / "serve/pump.py").write_text(textwrap.dedent(body))
        a = ref_run_checks(ra, rules=["races"])
        b = run_checks(rb, rules=["races"])
        _same(a, b, (ra, rb))
        assert b[0]


_EMITTER = """
    from .logging import json_record

    def tick(n):
        json_record("heartbeat", step=n, ok=True)
"""
_SCHEMA_STEPS = [
    _EMITTER,
    _EMITTER.replace("ok=True)", "ok=True, lag_s=0.0)"),
    _EMITTER.replace("ok=True)",
                     "ok=True)\n        json_record(\"surprise\", boom=1)"),
    """
    from .logging import json_record

    def tick(payload):
        json_record("mystery", **payload)
    """,
    """
    from .logging import json_record

    def tick(n):
        rec = {"step": n, "ok": True}
        rec["extra"] = 1
        json_record("heartbeat", **rec)
    """,
    """
    from .logging import json_record

    def tick(name):
        json_record(name, a=1)
    """,
]


def test_record_schema_matches_the_reference(tmp_path):
    ra = _tree(tmp_path / "ref", {"runtime/beat.py": _EMITTER})
    rb = _tree(tmp_path / "port", {"runtime/beat.py": _EMITTER})
    # no registry yet: both gates demand one
    _same(ref_run_checks(ra, rules=["record-schema"]),
          run_checks(rb, rules=["record-schema"]), (ra, rb))
    ref_run_checks(ra, rules=["record-schema"], update_schemas=True)
    run_checks(rb, rules=["record-schema"], update_schemas=True)
    for body in _SCHEMA_STEPS:
        for r in (ra, rb):
            (r / "runtime/beat.py").write_text(textwrap.dedent(body))
        a = ref_run_checks(ra, rules=["record-schema"])
        b = run_checks(rb, rules=["record-schema"])
        _same(a, b, (ra, rb))
    regs = [json.loads((r / "analysis/schemas/records.json").read_text())
            for r in (ra, rb)]
    assert regs[1]["events"] == regs[0]["events"]


_DEAD_TREE = {"mod.py": """
    def used():
        return 1

    def dead_helper():
        return 2

    def _private_dead():
        return 3

    VALUE = used()
""", "hooks.py": """
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.chain()

        def chain(self):
            pass
"""}


@pytest.mark.parametrize("external", [False, True])
def test_dead_code_matches_the_reference(external, tmp_path):
    root = _tree(tmp_path, _DEAD_TREE)
    extra = []
    if external:
        driver = tmp_path / "driver.py"
        driver.write_text("from pkg.mod import dead_helper\ndead_helper()\n")
        extra = [driver]
    got = dead_code_report(root, extra_sources=extra)
    assert got == ref_dead_code(root, extra_sources=extra)
    assert [r["qualname"] for r in got] == ([] if external
                                            else ["dead_helper"])


def test_committed_registries_match_the_reference_records():
    """The port emits the reference's records key for key: the two
    committed record-schema registries hold the same events and keys."""
    ref = json.loads((REPO / "heat_tpu/analysis/schemas/records.json")
                     .read_text())["events"]
    port = json.loads((PKG / "analysis/schemas/records.json")
                      .read_text())["events"]
    assert {k: v["keys"] for k, v in port.items()} == {
        k: v["keys"] for k, v in ref.items()}


# --- (b) the port's tree is clean; every family fires on a seeded tree --------

def test_the_port_is_clean_under_every_family():
    vs, stats = run_checks(PKG, strict_allows=True)
    assert vs == [], [v.format() for v in vs]
    assert stats["stale_allows"] == []
    assert sorted(stats["rules"]) == sorted(RULE_FAMILIES) == [
        "cuda-kernel-safety", "hot-path-purity", "lock-discipline",
        "races", "record-schema", "traced-determinism"]
    assert stats["cuda_files"] >= 12
    gmap = json.loads((PKG / "analysis/schemas/guards.json").read_text())
    assert "UNGUARDED" not in set(gmap["fields"].values())


_SEEDED = {
    "hot-path-purity": ({"serve/scheduler.py": """
        import numpy as np
        import torch

        class _Runner:
            def dispatch_fill(self):
                handle = self.eng.dispatch_chunk(4)
                a = np.asarray(handle)
                b = handle.item()
                c = handle.cpu()
                d = handle.numpy()
                e = handle.tolist()
                torch.cuda.synchronize()
                v = float(handle[0])
    """}, 7),
    "lock-discipline": (_LOCK_TREES["seeded"], 3),
    "traced-determinism": ({"ops/cuda_stencil.py": """
        import os
        import random
        import time

        import torch

        def _kernel_fn(name):
            return None

        def _launch(T, k):
            fn = _kernel_fn("ftcs2d")
            if os.environ.get("FAST"):
                k = 1
            return fn(T, k, time.perf_counter())

        def ftcs_multistep_plain(T):
            noise = torch.rand(T.shape)
            for d in {1, 2}:
                T = T + d
            return T + noise + random.random()

        def seeded_plain(T, g):
            return T + torch.rand(T.shape, generator=g)
    """}, 5),
    "record-schema": ({"runtime/beat.py": """
        from .logging import json_record

        def tick(name, payload):
            json_record(name, a=1)
            json_record("mystery", **payload)
    """}, 2),
    "races": ({"serve/pump.py": _PUMP}, 2),
}


@pytest.mark.parametrize("rule", sorted(_SEEDED))
def test_every_family_fires_on_its_seeded_tree(rule, tmp_path):
    files, n = _SEEDED[rule]
    root = _tree(tmp_path, files)
    vs, _ = run_checks(root, rules=[rule], update_schemas=True)
    got = [v for v in vs if v.rule == rule]
    assert len(got) == n, [v.format() for v in got]


def test_determinism_spares_a_seeded_draw(tmp_path):
    root = _tree(tmp_path, {"ops/cuda_lanes.py": _SEEDED[
        "traced-determinism"][0]["ops/cuda_stencil.py"]})
    vs, _ = run_checks(root, rules=["traced-determinism"])
    assert not any("seeded_plain" in v.message for v in vs)


def _shipped(tmp_path) -> Path:
    """A copy of the shipped kernel sources, _build.py and pyproject.toml
    in the layout the CUDA rules read."""
    root = tmp_path / "heat_tpu_torch"
    shutil.copytree(PKG / "ops" / "csrc", root / "ops" / "csrc")
    shutil.copy(PKG / "ops" / "_build.py", root / "ops" / "_build.py")
    shutil.copy(REPO / "pyproject.toml", tmp_path / "pyproject.toml")
    return root


# (file under the copy's root or "..", text, replacement, detector)
_MUTATIONS = {
    "fmad-dropped": ("ops/_build.py", '"-fmad=false",', "", "fmad-false"),
    "fast-math": ("ops/_build.py", '"-fmad=false",',
                  '"-fmad=false", "--use_fast_math",', "fmad-false"),
    "multiply-mask": (
        "ops/csrc/lanes2d.cu",
        "u[c] = __uint_as_float((__float_as_uint(u[c]) & k) |\n"
        "                             (__float_as_uint(cc[c]) & ~k));",
        "u[c] = cc[c] + (float)(lmask[c] & 1u) * (u[c] - cc[c]);",
        "select-not-mask"),
    "mask-in-common": (
        "ops/csrc/lanes_common.cuh", "  return isnan(v) ? "
        "__int_as_float(0x7fc00000) : v;",
        "  return v * live_mask;", "select-not-mask"),
    "storage-round-dropped": (
        "ops/csrc/lanes2d.cu",
        "const float u = to_storage<T>(__fmaf_rn(r_l, lap, c));",
        "const float u = __fmaf_rn(r_l, lap, c);", "storage-round"),
    "policy-round-dropped": (
        "ops/csrc/lanes3d.cu", "__floats2bfloat162_rn(", "__halves2bfloat162(",
        "storage-round"),
    "update-unfused": (
        "ops/csrc/lanes3d.cu",
        "v = to_storage<T>(__fmaf_rn(r_l, lap, c));",
        "v = to_storage<T>(c + r_l * lap);", "explicit-fma"),
    "cuh-not-shipped": ("../pyproject.toml", '"csrc/*.cu", "csrc/*.cuh"',
                        '"csrc/*.cu", "csrc/storage.cuh"', "cuh-shipped"),
    "cuh-not-hashed": ("ops/_build.py", 'glob("*.cuh")',
                       'glob("stencil*.cuh")', "cuh-shipped"),
}


def test_cuda_rules_pass_the_shipped_sources(tmp_path):
    vs, _ = run_checks(_shipped(tmp_path), rules=["cuda-kernel-safety"])
    assert vs == [], [v.format() for v in vs]


@pytest.mark.parametrize("name", sorted(_MUTATIONS))
def test_cuda_rules_fire_on_a_mutated_source(name, tmp_path):
    rel, old, new, kind = _MUTATIONS[name]
    root = _shipped(tmp_path)
    path = (root / rel).resolve()
    text = path.read_text()
    assert text.count(old) >= 1, f"{old!r} not in {rel}"
    path.write_text(text.replace(old, new, 1))
    vs, _ = run_checks(root, rules=["cuda-kernel-safety"])
    assert vs and all(v.rule == "cuda-kernel-safety" for v in vs)
    assert any(v.message.startswith(f"{kind}:") for v in vs), \
        [v.format() for v in vs]


def test_cuda_marker_sanctions_a_site(tmp_path):
    root = _shipped(tmp_path)
    path = root / "ops/csrc/lanes3d.cu"
    old = "v = to_storage<T>(__fmaf_rn(r_l, lap, c));"
    path.write_text(path.read_text().replace(
        old, "v = to_storage<T>(c + r_l * lap);  "
             "// heat-tpu: allow[cuda-kernel-safety] seeded for the test"))
    vs, stats = run_checks(root, rules=["cuda-kernel-safety"],
                           strict_allows=True)
    assert vs == [] and stats["allow_markers"] == 1


# --- (c) the rules see the real surface --------------------------------------

def test_determinism_finds_the_kernel_entries():
    from heat_tpu_torch.analysis.determinism import entry_points

    entries = entry_points(Context(PKG))
    assert len(entries) >= 20
    names = {q for _, q in entries}
    for want in ("lane_chunk", "_launch", "ftcs_multistep_2d_plain",
                 "lane_multistep_2d_plain", "ftcs_step_edges", "_run"):
        assert want in names, want
    assert {p for p, _ in entries} == {
        "ops/cuda_stencil.py", "ops/cuda_lanes.py", "ops/cuda_lab.py",
        "ops/stencil.py"}


def test_purity_hot_list_names_exist():
    from heat_tpu_torch.analysis import purity

    ctx = Context(PKG)
    for suffix, quals in purity.HOT_FILES.items():
        src = ctx.source(suffix)
        assert src is not None, suffix
        have = {getattr(f, "_qualname", f.name) for f in src.functions()}
        for q in quals:
            assert any(h == q or h.endswith("." + q) for h in have), \
                f"{suffix}: {q}"


def test_lock_table_is_the_watchdogs():
    from heat_tpu_torch.analysis import locks
    from heat_tpu_torch.runtime import debug

    assert locks.RANKS == debug.LOCK_RANKS
    assert set(r for _, _, r in locks.LOCK_EXPRS) <= set(debug.LOCK_RANKS)


# --- the CLI ----------------------------------------------------------------

def test_check_cli(tmp_path, capsys):
    assert main(["check", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULE_FAMILIES:
        assert rule in out
    assert main(["check", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["violations"] == [] and payload["stats"]["files"] > 60
    root = _tree(tmp_path, _SEEDED["hot-path-purity"][0])
    assert main(["check", "--root", str(root),
                 "--rules", "hot-path-purity"]) == 1
    assert "[hot-path-purity]" in capsys.readouterr().out
    assert main(["check", "--rules", "no-such-rule"]) == 2
    assert main(["check", "--root", str(tmp_path / "missing")]) == 2
    stale = _tree(tmp_path / "s", _MARKER_TREES["stale"])
    assert main(["check", "--root", str(stale),
                 "--rules", "lock-discipline"]) == 0
    assert "warning:" in capsys.readouterr().out
    assert main(["check", "--root", str(stale), "--rules",
                 "lock-discipline", "--strict-allows"]) == 1
    dead = _tree(tmp_path / "d", _DEAD_TREE)
    assert main(["check", "--root", str(dead), "--dead-code"]) == 0
    assert "dead_helper" in capsys.readouterr().out
