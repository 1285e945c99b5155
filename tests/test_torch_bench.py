"""The port's headline benchmark and its front doors on the CPU, held
against the reference where it defines something.

- ``benchmark``: the headline advance (the ``cuda`` backend's, its plain
  version on CPU tensors) against the reference's Pallas advance
  (interpret mode), byte for byte, at r = 0.25 and 0.2, in fused passes
  and with a remainder; the record's keys; the one-pass bound's
  arithmetic; the spare buffer never the live input.
- ``bench`` through ``cli.main``: the reference's own asserts
  (``tests/test_cli.py``), and no fallback to the CPU.
- ``python -m heat_tpu_torch.bench``: the cases of the reference's
  ``tests/test_bench_capture.py`` (one parseable line, always), and a
  supervisor that loads no torch.
- ``labs/run_all.py``: the cases of ``tests/test_run_all.py`` (rows merged
  as they land, failures recorded, a corrupt file), the five
  configurations equal to the reference's at both sizes, a smoke row.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu.config as ref_config
from heat_tpu.backends.pallas import make_advance as ref_make_advance
from heat_tpu.grid import initial_condition as ref_initial_condition
from heat_tpu_torch import bench, benchmark, cli
from heat_tpu_torch.labs import run_all

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parent.parent
_REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline",
                   "raw_single_call", "platform", "baseline_chip"}


def _last_json_line(out: str) -> dict:
    lines = [l for l in out.strip().splitlines() if l.strip().startswith("{")]
    assert lines, f"no JSON line in output: {out!r}"
    return json.loads(lines[-1])


# -- the measurement ----------------------------------------------------------

@pytest.mark.parametrize("steps", [32, 37])
@pytest.mark.parametrize("sigma", [0.25, 0.2])
def test_headline_advance_is_the_reference_pallas_advance(sigma, steps):
    """32 steps are two fused 16-step passes; 37 add five one-step
    passes. At r = 0.2 the update's single rounding shows."""
    cfg = benchmark.headline_config(64, steps).with_(sigma=sigma)
    x, advance, warm = benchmark.headline_advance(cfg, "cpu")
    warm(x.clone(), steps)
    got = advance(x, steps)

    ref = ref_config.HeatConfig(n=64, ntime=steps, dtype="float32", ic="hat",
                                backend="pallas", sigma=sigma)
    T0 = ref_initial_condition(ref).astype("float32")
    want = np.asarray(ref_make_advance(ref)(jnp.asarray(T0), steps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_the_spare_buffer_is_never_the_live_input(monkeypatch):
    """``warm`` on the field itself leaves the field as the edges spare;
    the next ``advance`` must not pass it as its own output."""
    from heat_tpu_torch.ops import cuda_stencil

    real = cuda_stencil._multistep
    aliased = []

    def spy(T, r, k, out=None, plain=False):
        aliased.append(out is T)
        return real(T, r, k, out=out, plain=plain)

    monkeypatch.setattr(cuda_stencil, "_multistep", spy)
    cfg = benchmark.headline_config(32, 48)
    want, advance, _ = benchmark.headline_advance(cfg, "cpu")
    for _ in range(3):
        want = advance(want, 48)
    got, advance, warm = benchmark.headline_advance(cfg, "cpu")
    warm(got, 48)
    for _ in range(3):
        got = advance(got, 48)
    assert len(aliased) == 3 * 3 + 1 + 3 * 3 and not any(aliased)
    assert torch.equal(got, want)


def test_headline_record_on_the_cpu():
    rec = benchmark.headline_measure(n=64, steps=8, repeats=1, device="cpu")
    assert set(rec) >= _REFERENCE_KEYS
    assert rec["metric"] == "grid_points_per_sec_per_chip_64x64_f32_cuda"
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    assert rec["vs_baseline"] is None and "no published" in rec["baseline_chip"]
    assert rec["value"] > 0 and rec["raw_single_call"] > 0
    assert rec["kernel"] == "ftcs2d plain version (cpu)"
    # the plain version on CPU tensors launches nothing
    assert rec["launches_per_call"] == 0 and rec["calls"] == 4
    assert rec["n"] == 64 and rec["steps"] == 8 and rec["repeats"] == 1


def test_the_one_pass_bound_is_the_data_sheets(monkeypatch):
    from heat_tpu_torch import machine

    def model(device=None):
        return machine.DeviceModel("NVIDIA H100 80GB HBM3", 132, None, None,
                                   80 << 30, machine.PEAKS["H100"])

    monkeypatch.setattr(machine, "device_model", model)
    rate, label = benchmark.one_pass_bound("cuda")
    assert rate == 3.35e12 / 8 == 4.1875e11
    assert label.startswith("NVIDIA H100 80GB HBM3: one-pass HBM bound 3.35 TB/s")
    assert "data sheet" in label
    assert benchmark.one_pass_bound("cuda", 2)[0] == 3.35e12 / 4
    assert benchmark.one_pass_bound("cpu") == (None,
                                               "cpu (no published roofline)")


# -- bench through the CLI ----------------------------------------------------

def test_cli_bench_subcommand(capsys):
    """The reference's asserts (``tests/test_cli.py``) on the port's line,
    with the port's metric name."""
    assert cli.main(["bench", "--device", "cpu", "--n", "64", "--steps", "8",
                     "--repeats", "1"]) == 0
    out = capsys.readouterr().out
    rec = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    assert out.strip().splitlines()[-1].startswith("{")
    assert rec["metric"] == "grid_points_per_sec_per_chip_64x64_f32_cuda"
    assert rec["value"] > 0 and rec["raw_single_call"] > 0
    assert set(rec) >= _REFERENCE_KEYS
    assert rec["platform"] == "cpu"
    assert "points/s on cpu" in out.splitlines()[0]


def test_cli_bench_refuses_bad_repeats(capsys):
    assert cli.main(["bench", "--device", "cpu", "--repeats", "0"]) == 2
    assert "--repeats must be >= 1" in capsys.readouterr().err


def test_cli_bench_does_not_fall_back_to_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch", "bench", "--n", "64",
         "--steps", "8", "--repeats", "1"], capture_output=True, text=True,
        timeout=120, cwd=_REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert "{" not in out.stdout


# -- the supervised entry -----------------------------------------------------

@pytest.fixture
def restore_signals():
    """``supervise`` installs SIGTERM/SIGINT/SIGHUP handlers; undo after."""
    saved = {s: signal.getsignal(s)
             for s in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.fixture
def no_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "_LAST_GOOD", str(tmp_path / "none.json"))


def test_success_prints_result_line(monkeypatch, capsys, restore_signals,
                                    no_cache):
    record = {"metric": bench.METRIC, "value": 1.0e12, "unit": "points/s",
              "vs_baseline": 4.2}

    def fake_run(holder, timeout):
        return subprocess.CompletedProcess(
            "worker", 0, stdout="chatter\n" + json.dumps(record), stderr="")

    monkeypatch.setattr(bench, "_run_worker", fake_run)
    assert bench.supervise() == 0
    assert _last_json_line(capsys.readouterr().out) == record


def test_all_attempts_fail_stays_within_budget(monkeypatch, capsys,
                                               restore_signals, no_cache):
    calls = []

    def fake_run(holder, timeout):
        calls.append(timeout)
        raise subprocess.TimeoutExpired(cmd="worker", timeout=timeout)

    monkeypatch.setattr(bench, "_run_worker", fake_run)
    monkeypatch.setattr(bench, "TOTAL_BUDGET_S", 2)
    monkeypatch.setattr(bench, "ATTEMPT_TIMEOUT_S", 1)
    monkeypatch.setattr(bench, "_MIN_ATTEMPT_S", 0.5)
    monkeypatch.setattr(bench, "BACKOFF_S", (0.1,))
    t0 = time.monotonic()
    rc = bench.supervise()
    assert rc == 1
    assert time.monotonic() - t0 < 10
    out = _last_json_line(capsys.readouterr().out)
    assert out["metric"] == bench.METRIC and out["value"] == 0.0
    assert "error" in out and "last_good" not in out
    assert calls and all(t <= bench.ATTEMPT_TIMEOUT_S for t in calls)


def test_a_deterministic_failure_ends_the_ladder(monkeypatch, capsys,
                                                 restore_signals, no_cache):
    calls = []

    def fake_run(holder, timeout):
        calls.append(timeout)
        return subprocess.CompletedProcess(
            "worker", 1, stdout="", stderr="RuntimeError: CUDA is not "
            "available on this host; pass device='cpu'")

    monkeypatch.setattr(bench, "_run_worker", fake_run)
    assert bench.supervise() == 1
    out = _last_json_line(capsys.readouterr().out)
    assert len(calls) == 1 and "CUDA is not available" in out["error"]


def test_budget_exhaustion_is_reported(monkeypatch, capsys, restore_signals,
                                       no_cache):
    def fake_run(holder, timeout):
        time.sleep(timeout)
        raise subprocess.TimeoutExpired(cmd="worker", timeout=timeout)

    monkeypatch.setattr(bench, "_run_worker", fake_run)
    monkeypatch.setattr(bench, "TOTAL_BUDGET_S", 1)
    monkeypatch.setattr(bench, "ATTEMPT_TIMEOUT_S", 0.6)
    monkeypatch.setattr(bench, "_MIN_ATTEMPT_S", 0.5)
    assert bench.supervise() == 1
    out = _last_json_line(capsys.readouterr().out)
    assert "budget exhausted" in out["error"]


def test_sigterm_leaves_parseable_line(tmp_path):
    """An external deadline SIGTERMs the supervisor mid-attempt: the
    backstop prints the verdict line and reaps the worker (here a worker
    that sleeps, in place of a hung card)."""
    code = ("import sys, heat_tpu_torch.bench as b\n"
            "b._worker_argv = lambda: [sys.executable, '-c', "
            "'import time; time.sleep(300)']\n"
            "sys.exit(b.main())\n")
    env = {**os.environ, "HEAT_BENCH_TIMEOUT_S": "300",
           "HEAT_BENCH_TOTAL_BUDGET_S": "300",
           "HEAT_BENCH_LAST_GOOD": str(tmp_path / "none.json"),
           "PYTHONPATH": str(_REPO)}
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True, env=env)

    def our_worker_pids():
        r = subprocess.run(["pgrep", "-P", str(proc.pid)],
                           capture_output=True, text=True)
        return {int(p) for p in r.stdout.split()}

    # the worker starts only after the handlers are installed, so its
    # existence proves the backstop is live
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        ours = our_worker_pids()
        if ours:
            break
        if proc.poll() is not None:
            out, _ = proc.communicate()
            raise AssertionError(f"supervisor exited early "
                                 f"rc={proc.returncode}; stdout: {out!r}")
        time.sleep(0.1)
    else:
        proc.kill()
        raise AssertionError("worker never appeared within 60s")
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 1
    parsed = _last_json_line(out)
    assert parsed["metric"] == bench.METRIC and parsed["value"] == 0.0
    assert "signal 15" in parsed["error"]
    time.sleep(1.0)
    leaked = set()
    for pid in ours:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue  # gone
        if state != "Z" and b"time.sleep" in cmdline:
            leaked.add((pid, state))
    assert not leaked, f"orphaned worker pids: {leaked}"


def test_worker_constants_match_library():
    assert bench.N == benchmark.N
    assert bench.STEPS == benchmark.STEPS
    assert bench.REPEATS == benchmark.REPEATS
    assert bench.METRIC == benchmark.metric_name(bench.N)
    assert bench.METRIC.endswith("_f32_cuda")


def test_the_worker_runs_the_measurement_and_caches_it(tmp_path, monkeypatch,
                                                       capsys):
    """``measure`` as the worker runs it, the measurement stubbed: the
    literals are checked, the line printed, the cache written atomically."""
    rec = {"metric": bench.METRIC, "value": 1.5e12}
    seen = {}

    def fake(n, steps, repeats):
        seen.update(n=n, steps=steps, repeats=repeats)
        return dict(rec)

    monkeypatch.setattr(benchmark, "headline_measure", fake)
    monkeypatch.setattr(bench, "_LAST_GOOD", str(tmp_path / "a" / "lb.json"))
    bench.measure()
    assert seen == {"n": 4096, "steps": 8192, "repeats": 3}
    assert _last_json_line(capsys.readouterr().out) == rec
    cached = json.loads((tmp_path / "a" / "lb.json").read_text())
    assert cached["metric"] == bench.METRIC and "measured_ts" in cached
    assert not (tmp_path / "a" / "lb.json.tmp").exists()


def test_error_line_carries_last_good(tmp_path, monkeypatch):
    cache = tmp_path / "last_bench.json"
    cache.write_text(json.dumps({"metric": bench.METRIC, "value": 1.78e12,
                                 "measured_ts": 1792300000.0}))
    monkeypatch.setattr(bench, "_LAST_GOOD", str(cache))
    rec = json.loads(bench._error_line("card gone"))
    assert rec["value"] == 0.0 and rec["error"] == "card gone"
    assert rec["last_good"]["value"] == 1.78e12

    monkeypatch.setattr(bench, "_LAST_GOOD", str(tmp_path / "missing.json"))
    assert "last_good" not in json.loads(bench._error_line("card gone"))


def test_error_line_rejects_mismatched_last_good(tmp_path, monkeypatch):
    cache = tmp_path / "last_bench.json"
    for metric in ("grid_points_per_sec_per_chip_1024x1024_f32_cuda",
                   "grid_points_per_sec_per_chip_4096x4096_f32_pallas"):
        cache.write_text(json.dumps({"metric": metric, "value": 9.9e10}))
        monkeypatch.setattr(bench, "_LAST_GOOD", str(cache))
        rec = json.loads(bench._error_line("card gone"))
        assert rec["value"] == 0.0 and "last_good" not in rec


def test_the_supervisor_loads_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, heat_tpu_torch.bench as b\n"
         "assert b.METRIC.endswith('_cuda')\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'numpy', 'jax', 'heat_tpu')))"],
        capture_output=True, text=True, timeout=120, cwd=_REPO,
        env={**os.environ, "PYTHONPATH": str(_REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_supervised_entry_without_a_card_prints_the_error_line(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "HEAT_BENCH_LAST_GOOD": str(tmp_path / "lb.json")}
    out = subprocess.run([sys.executable, "-m", "heat_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=300,
                         cwd=_REPO, env=env)
    assert out.returncode == 1
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == bench.METRIC and rec["value"] == 0.0
    assert "device='cpu'" in rec["error"]
    assert not (tmp_path / "lb.json").exists()


# -- run_all ------------------------------------------------------------------

def _reference_run_all():
    spec = importlib.util.spec_from_file_location(
        "_ref_run_all", _REPO / "benchmarks" / "run_all.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_merge_rows_preserves_order_and_updates(tmp_path):
    out = tmp_path / "run_all.json"
    run_all._merge_rows(out, [{"name": "a", "v": 1}, {"name": "b", "v": 1}])
    run_all._merge_rows(out, [{"name": "a", "v": 2}])
    run_all._merge_rows(out, [{"name": "c", "v": 1}])
    rows = json.loads(out.read_text())["rows"]
    assert [r["name"] for r in rows] == ["a", "b", "c"]
    assert rows[0]["v"] == 2 and rows[1]["v"] == 1


def test_supervise_rows_records_failures_keeps_rest(tmp_path, monkeypatch):
    out = tmp_path / "run_all.json"
    cmds = []

    def fake_run(cmd, timeout=None, **kw):
        cmds.append(cmd)
        name = cmd[cmd.index("--only") + 1]
        if name == "hangs":
            raise subprocess.TimeoutExpired(cmd, timeout)
        if name == "crashes":
            return subprocess.CompletedProcess(cmd, 1)
        run_all._merge_rows(out, [{"name": name, "points_per_s": 1.0}])
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    run_all.supervise_rows(["ok1", "hangs", "crashes", "ok2"], out,
                           row_timeout=5)
    rows = {r["name"]: r for r in json.loads(out.read_text())["rows"]}
    assert rows["ok1"]["points_per_s"] == 1.0
    assert rows["ok2"]["points_per_s"] == 1.0
    assert "timed out" in rows["hangs"]["error"]
    assert "rc=1" in rows["crashes"]["error"]
    # each child runs its row in process and merges into the same record
    assert cmds[0][1:3] == ["-m", "heat_tpu_torch.labs.run_all"]
    assert cmds[0][cmds[0].index("--out") + 1] == str(out)
    assert cmds[0][cmds[0].index("--row-timeout") + 1] == "0"


def test_supervise_keeps_row_when_child_dies_post_measurement(
        tmp_path, monkeypatch):
    out = tmp_path / "run_all.json"

    def fake_run(cmd, timeout=None, **kw):
        name = cmd[cmd.index("--only") + 1]
        run_all._merge_rows(out, [{"name": name, "points_per_s": 7.0,
                                   "measured_ts": time.time()}])
        raise subprocess.TimeoutExpired(cmd, timeout)  # teardown hang

    monkeypatch.setattr(subprocess, "run", fake_run)
    run_all.supervise_rows(["slow_teardown"], out, row_timeout=5)
    (row,) = json.loads(out.read_text())["rows"]
    assert row["points_per_s"] == 7.0 and "error" not in row


def test_merge_survives_corrupt_results_file(tmp_path):
    out = tmp_path / "run_all.json"
    out.write_text('{"ts": 1, "rows": [{"na')  # torn by a SIGKILL
    run_all._merge_rows(out, [{"name": "a", "v": 1}])
    assert json.loads(out.read_text())["rows"] == [{"name": "a", "v": 1}]


_RENAMED = {"pallas": "cuda", "serial": "serial", "sharded": "sharded"}


@pytest.mark.parametrize("smoke", [True, False])
def test_run_all_configs_are_the_references(smoke, monkeypatch):
    """The reference's ``main`` run with its measurement and both writers
    stubbed (nothing under ``benchmarks/`` is written) hands the five
    configurations to ``bench_one``; the port's are the same, renamed."""
    import jax

    ref = _reference_run_all()
    seen = []
    monkeypatch.setattr(ref, "bench_one",
                        lambda name, cfg, repeat=1: seen.append((name, cfg))
                        or {"name": name})
    monkeypatch.setattr(ref, "write_atomic", lambda *a, **k: None)
    monkeypatch.setattr(ref, "_merge_rows", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["run_all.py", "--row-timeout", "0"]
                        + (["--smoke"] if smoke else []))
    ref.main()
    ndev = len(jax.devices())
    port = run_all.configs(smoke, ndev)
    assert len(seen) == len(port) == 5
    for (rname, rcfg), (pname, pcfg) in zip(seen, port):
        assert pname == rname.replace("pallas", "cuda")
        assert pcfg.backend == _RENAMED[rcfg.backend]
        for f in ("n", "ndim", "ntime", "dtype", "sigma", "nu", "dom_len",
                  "bc", "ic", "fuse_steps", "mesh_shape"):
            assert getattr(pcfg, f) == getattr(rcfg, f), (pname, f)


def test_run_all_smoke_row_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "artifacts" / "run_all_smoke.json"
    assert run_all.main(["--smoke", "--device", "cpu", "--only", "2_",
                         "--row-timeout", "0", "--out", str(out)]) == 0
    rows = {r["name"]: r for r in json.loads(out.read_text())["rows"]}
    # --only is the reference's substring filter: "2_" is in "f32_mesh" too
    assert sorted(rows) == ["2_cuda_4096sq_f32", "3_sharded_16384sq_f32_mesh"]
    row = rows["2_cuda_4096sq_f32"]
    ref_keys = {"baseline_chip", "name", "measured_ts", "n", "ndim", "steps",
                "dtype", "backend", "mesh", "solve_s", "per_step_s",
                "points_per_s", "points_per_s_two_point", "roofline_frac",
                "roofline_frac_two_point", "devices", "platform"}
    assert set(row) >= ref_keys | {"kernel", "launches_per_solve", "launches",
                                   "commit", "source_sha256"}
    assert row["name"] == "2_cuda_4096sq_f32" and row["n"] == 256
    assert row["steps"] == 20 and row["backend"] == "cuda"
    assert row["platform"] == "cpu" and row["roofline_frac"] is None
    assert row["kernel"] == "ftcs2d plain version (cpu)"
    assert row["points_per_s"] > 0 and row["points_per_s_two_point"] > 0
    # 20 steps: one 16-step pass and four one-step passes; none launched
    assert row["launches_per_solve"] == 5
    assert row["launches"] == {"ftcs2d": 0, "ftcs3d": 0}
    assert "wrote" in capsys.readouterr().out


def test_run_all_does_not_fall_back_to_the_cpu(tmp_path):
    out = tmp_path / "run_all.json"
    res = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch.labs.run_all", "--smoke",
         "--only", "2_", "--out", str(out)], capture_output=True, text=True,
        timeout=120, cwd=_REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 2
    assert "--device cpu" in res.stderr
    assert not out.exists()
