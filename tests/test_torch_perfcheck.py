"""``python -m heat_tpu_torch perfcheck`` against the reference's
``heat-tpu perfcheck``, and the static roofline prior it bands the cost
model against.

- The gate table equals the reference's entry for entry (read from
  ``heat_tpu/cli.py`` with ``ast``, the source only), with the compile
  check's record renamed to the port's build check's.
- ``_band_ok`` and ``roofline_lane_step_bytes`` agree with the reference's;
  ``lane_static_prior`` is those bytes over the H100's 3.35 TB/s.
- Over a fixture directory of records whose gates all hold, ``perfcheck
  --no-fresh`` exits 0; one gate field flipped or one record missing makes
  it exit 1 naming the field or the file; the static-prior band and the
  lane-kernel card gate are hard on a ``cuda`` record and informational on
  a ``cpu`` one; ``--fresh --device cpu`` runs the lab and both armed waves.
- The committed records come from the card, and over them every check
  that ``chip_smoke.py``'s phase 5g counts as correctness passes.
"""

import ast
import contextlib
import io
import json
import time
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from heat_tpu import cli as jcli
from heat_tpu.analysis import programs as jprograms
from heat_tpu_torch import cli
from heat_tpu_torch.analysis import programs
from heat_tpu_torch.labs._util import ARTIFACTS
from heat_tpu_torch.runtime.prof import static_prior_s_per_lane_step

_REPO = Path(__file__).resolve().parent.parent
RENAMES = {"lane_kernel_compile_check.json": "lane_kernel_build_check.json"}
H100_BYTES_PER_S = 3.35e12


def _table(node) -> list:
    """[(record, [(field, predicate source)])] of a gate-table literal."""
    return [(rec.elts[0].value,
             [(g.elts[0].value, ast.unparse(g.elts[1]))
              for g in rec.elts[1].elts])
            for rec in node.elts]


def _reference_table() -> list:
    tree = ast.parse((_REPO / "heat_tpu" / "cli.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "cmd_perfcheck")
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For)
                and ast.unparse(n.target) == "(fname, gates)")
    return _table(loop.iter)


def _port_table() -> list:
    tree = ast.parse((_REPO / "heat_tpu_torch" / "cli.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == "PERFCHECK_GATES")
    return _table(node.value)


def test_gate_table_is_the_references():
    want = [(RENAMES.get(f, f), gates) for f, gates in _reference_table()]
    assert len(want) == 13
    assert _port_table() == want
    # and the table the command runs is the one in the source
    assert [(f, [g for g, _ in gates]) for f, gates in cli.PERFCHECK_GATES] \
        == [(f, [g for g, _ in gates]) for f, gates in want]


@pytest.mark.parametrize("tolerance", (0.0, 0.1, 0.25, 0.5, 0.75))
def test_band_ok_is_the_references(tolerance):
    for ratio in np.concatenate([np.linspace(0.05, 5.0, 100),
                                 [1 - tolerance, 1 / (1 - tolerance)]]):
        assert cli._band_ok(float(ratio), tolerance) == \
            jcli._band_ok(float(ratio), tolerance), (ratio, tolerance)


@pytest.mark.parametrize("ndim", (2, 3))
@pytest.mark.parametrize("dtype", ("float64", "float32", "bfloat16"))
def test_roofline_bytes_and_prior(ndim, dtype):
    for n in (24, 32, 48, 256):
        want = jprograms.roofline_lane_step_bytes(ndim, n, dtype)
        assert programs.roofline_lane_step_bytes(ndim, n, dtype) == want
        label = f"{ndim}d/n{n}/{dtype}/edges"
        for kernel in ("cuda", "torch"):
            assert programs.lane_static_prior(label, kernel) == \
                want / H100_BYTES_PER_S
            assert static_prior_s_per_lane_step(label, kernel) == \
                want / H100_BYTES_PER_S


@pytest.mark.parametrize("label", ("", "garbage", "2d/n32/float16/edges",
                                   "d/n32/float32/edges", "2d/32/float32/"))
def test_prior_of_a_bad_label_is_none(label):
    assert programs.lane_static_prior(label) is None
    assert static_prior_s_per_lane_step(label) is None


# --- the fixture records ----------------------------------------------------

def _passing(pred):
    for v in (1.0, 10.0, True):
        if pred(v):
            return v
    raise AssertionError("no passing value")


def _failing(pred):
    for v in (None, False, 0.0, -1.0, 100.0):
        if not pred(v):
            return v
    raise AssertionError("no failing value")


def make_fixture(d: Path, platform: str = "cpu",
                 learned_over_prior: float = 2.0) -> Path:
    """Every record perfcheck reads, each gate holding; the baseline's cost
    model ``learned_over_prior`` times the static prior."""
    d.mkdir(parents=True, exist_ok=True)
    bucket = "2d/n32/float64/edges"
    prior = programs.lane_static_prior(bucket)
    (d / "prof_overhead_lab.json").write_text(json.dumps({
        "bench": "prof_overhead_lab", "platform": platform,
        "on_within_2pct_of_off": True, "on_overhead_frac": 0.01,
        "bit_identical_depth0": True, "bit_identical_depth2": True,
        "usage_reconciles": True, "on": {"points_per_s": 1.0e8},
        "cost_model": [{"bucket": bucket, "kernel": "torch",
                        "ewma_s_per_lane_step":
                            learned_over_prior * prior}]}))
    for fname, gates in cli.PERFCHECK_GATES:
        rec = {"platform": platform}
        rec.update({f: _passing(pred) for f, pred in gates})
        if fname == "serve_lane_kernel_lab.json":
            rec.update(cuda_beats_torch=True, cuda_vs_torch=2.0,
                       cuda_vs_solo=1.5)
            for side, per, wall in (("cuda", 1e-5, 1.0),
                                    ("torch", 2e-5, 2.0)):
                rec[side] = {"wall_s": wall, "compile_s": 0.0,
                             "cost_model": [{
                                 "bucket": "2d/n32/float32/edges",
                                 "kernel": side, "wall_s": wall / 2,
                                 "mean_s_per_lane_step": per}]}
        (d / fname).write_text(json.dumps(rec))
    return d


def perfcheck(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["perfcheck", *argv])
    return rc, buf.getvalue()


def test_whole_fixture_passes(tmp_path):
    d = make_fixture(tmp_path / "a")
    rc, out = perfcheck("--no-fresh", "--artifacts", str(d))
    assert rc == 0, out
    assert "FAIL" not in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("perfcheck: OK")
    n = 3 + sum(len(g) for _, g in cli.PERFCHECK_GATES) + 2 + 1 + 1
    assert f"{n}/{n} checks passed" in last


GATES = [(f, field, pred) for f, gates in cli.PERFCHECK_GATES
         for field, pred in gates]


@pytest.mark.parametrize("fname,field,pred", GATES,
                         ids=[f"{f}:{g}" for f, g, _ in GATES])
def test_one_flipped_gate_fails_and_is_named(tmp_path, fname, field, pred):
    d = make_fixture(tmp_path / "a")
    rec = json.loads((d / fname).read_text())
    rec[field] = bad = _failing(pred)
    (d / fname).write_text(json.dumps(rec))
    rc, out = perfcheck("--no-fresh", "--artifacts", str(d))
    assert rc == 1
    fails = [ln for ln in out.splitlines() if ln.startswith("FAIL ")]
    assert fails == [f"FAIL {fname}: {field}={bad}"], out


@pytest.mark.parametrize("fname", [f for f, _ in cli.PERFCHECK_GATES])
def test_a_missing_record_fails_and_is_named(tmp_path, fname):
    d = make_fixture(tmp_path / "a")
    (d / fname).unlink()
    rc, out = perfcheck("--no-fresh", "--artifacts", str(d))
    assert rc == 1
    assert f"FAIL {fname}: committed artifact missing" in out


def test_missing_baseline_exits_2(tmp_path, capsys):
    d = make_fixture(tmp_path / "a")
    (d / "prof_overhead_lab.json").unlink()
    rc, _ = perfcheck("--no-fresh", "--artifacts", str(d))
    assert rc == 2
    assert "baseline" in capsys.readouterr().err


@pytest.mark.parametrize("platform", ("cuda", "cpu"))
def test_static_prior_band_is_hard_on_the_card_only(tmp_path, platform):
    # within the band: OK on both platforms
    d = make_fixture(tmp_path / "in", platform=platform)
    rc, out = perfcheck("--no-fresh", "--artifacts", str(d))
    assert rc == 0, out
    # a learned model 10^3 times its bytes floor: hard on cuda only
    d = make_fixture(tmp_path / "out", platform=platform,
                     learned_over_prior=1e3)
    rc, out = perfcheck("--no-fresh", "--artifacts", str(d))
    line = next(ln for ln in out.splitlines() if "static-prior band" in ln)
    assert "1000.00x the static roofline prior" in line
    if platform == "cuda":
        assert rc == 1 and line.startswith("FAIL static-prior band: ")
    else:
        assert rc == 0 and line.startswith(
            "OK   static-prior band (informational, platform=cpu): ")


@pytest.mark.parametrize("platform", ("cuda", "cpu"))
def test_lane_kernel_gate_is_hard_on_the_card_only(tmp_path, platform):
    d = make_fixture(tmp_path / "a", platform=platform)
    rec = json.loads((d / "serve_lane_kernel_lab.json").read_text())
    rec.update(cuda_beats_torch=False, cuda_vs_torch=0.8)
    (d / "serve_lane_kernel_lab.json").write_text(json.dumps(rec))
    rc, out = perfcheck("--no-fresh", "--artifacts", str(d))
    if platform == "cuda":
        assert rc == 1
        assert "FAIL lane-kernel card gate: cuda_vs_torch=0.8" in out
    else:
        assert rc == 0
        assert ("OK   lane-kernel perf (informational, platform=cpu): "
                "cuda_vs_torch=0.8") in out


def test_lane_kernel_cost_rows_keyed_and_banded(tmp_path):
    d = make_fixture(tmp_path / "a")
    rec = json.loads((d / "serve_lane_kernel_lab.json").read_text())
    rec["cuda"]["cost_model"][0]["kernel"] = "torch"
    rec["torch"]["cost_model"][0]["mean_s_per_lane_step"] = 1e-3
    (d / "serve_lane_kernel_lab.json").write_text(json.dumps(rec))
    rc, out = perfcheck("--no-fresh", "--artifacts", str(d))
    assert rc == 1
    assert "FAIL lane-kernel cost rows: " in out
    assert "FAIL lane-kernel cost band: " in out


def test_fresh_on_the_cpu_runs_the_lab_and_both_armed_waves(tmp_path):
    d = make_fixture(tmp_path / "a")
    t0 = time.perf_counter()
    rc, out = perfcheck("--fresh", "--device", "cpu", "--artifacts", str(d),
                        "--requests", "6", "--repeats", "1")
    assert rc in (0, 1)
    ok = {ln[5:].split(":")[0] for ln in out.splitlines()
          if ln.startswith("OK   ")}
    # the lab's rc is 1 when its own 2% gate misses, so "fresh lab run"
    # may fail on a loaded host; what it computed is checked here
    assert {"fresh bit-identity", "lockcheck inversions",
            "racecheck findings"} <= ok, out
    names = [ln[5:].split(":")[0] for ln in out.splitlines()
             if ln.startswith(("OK   ", "FAIL "))]
    for name in ("fresh lab run", "fresh overhead gate",
                 "fresh-vs-baseline band",
                 "lockcheck overhead", "racecheck overhead"):
        assert name in names
    assert time.perf_counter() - t0 < 120


# --- the committed records ---------------------------------------------------

RECORDS = ["prof_overhead_lab.json"] + [f for f, _ in cli.PERFCHECK_GATES]


@pytest.mark.parametrize("fname", RECORDS)
def test_committed_record_comes_from_the_card(fname):
    rec = json.loads((ARTIFACTS / fname).read_text())
    assert rec["platform"] == "cuda"
    assert "H100" in rec["card"]["name"]
    assert rec["card"]["smi"] and "W" in rec["card"]["smi"]
    assert len(rec["source_sha256"]) == 64


def test_committed_records_pass_every_correctness_check():
    """What phase 5g holds on the card: a FAIL over the committed records
    is one of the speed and band checks it names, never a correctness
    check."""
    rc, out = perfcheck("--no-fresh")
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("OK   ", "FAIL "))]
    assert len(lines) >= 3 + sum(len(g) for _, g in cli.PERFCHECK_GATES)
    wrong = [ln for ln in lines if ln.startswith("FAIL ")
             and chip_smoke.perfcheck_key(ln) not in
             chip_smoke.PERFCHECK_SPEED]
    assert not wrong, wrong
    assert rc == (1 if any(ln.startswith("FAIL ") for ln in lines) else 0)


def test_phase_5g_names_real_checks():
    """Every name in ``chip_smoke.PERFCHECK_SPEED`` is a gate of the table
    or a check perfcheck prints, and no identity gate is among them."""
    gates = {f"{f}: {g}" for f, gates in cli.PERFCHECK_GATES
             for g, _ in gates}
    checks = {"baseline overhead gate", "lane-kernel cost band",
              "lane-kernel card gate", "calibration cross-check",
              "static-prior band"}
    assert chip_smoke.PERFCHECK_SPEED <= gates | checks
    assert not any("identical" in k or "zero_" in k or "recovered" in k
                   or "quarantined" in k or "compile" in k
                   or "reconcile" in k or "export" in k
                   for k in chip_smoke.PERFCHECK_SPEED)
    assert chip_smoke.perfcheck_key(
        "FAIL serve_mega_lab.json: packed_within_10pct=False") == \
        "serve_mega_lab.json: packed_within_10pct"
    assert chip_smoke.perfcheck_key(
        "OK   static-prior band (informational, platform=cpu): x") == \
        "static-prior band"
