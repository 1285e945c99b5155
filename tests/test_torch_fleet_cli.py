"""The port's ``fleet`` subcommand and the two fleet labs on the CPU.

``python -m heat_tpu_torch fleet`` has the reference's flags and defaults
and runs end to end in a subprocess in front of two in-process port
gateways; ``info`` names the fleet without a gate file; each lab runs
once at a tiny population (``--device cpu``) and its correctness fields
hold (its timing gates are measurements, not checks, on a shared host).
Every wait is bounded and every server closed in a ``finally``.
"""

import argparse
import contextlib
import io
import json
import os
import select
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from heat_tpu import cli as jcli
from heat_tpu_torch import cli
from heat_tpu_torch.serve import Engine, ServeConfig
from heat_tpu_torch.serve.gateway import Gateway

torch.set_num_threads(1)
_REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 60


def _fleet_actions(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for a in sub.choices["fleet"]._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.dest] = (tuple(a.option_strings), a.default, a.type,
                       tuple(a.choices) if a.choices else None, a.metavar,
                       a.nargs, a.const, a.required, type(a).__name__)
    return out


def test_fleet_flags_and_defaults_equal_the_reference():
    ours = _fleet_actions(cli.build_parser())
    theirs = _fleet_actions(jcli.build_parser())
    assert ours == theirs


def test_info_names_the_fleet_without_a_gate_file():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["info"]) == 0
    text = buf.getvalue()
    fleet = [ln for ln in text.splitlines() if ln.startswith("fleet ")]
    assert len(fleet) == 2, text
    assert "least-loaded|round-robin" in fleet[0]
    assert "fast&slow > 1" in fleet[0]
    assert "trip after 3 errors or 8 burn ticks" in fleet[1]
    assert "benchmarks/" not in text


def test_fleet_without_backends_exits_2(capsys):
    assert cli.main(["fleet"]) == 2
    assert "--backends" in capsys.readouterr().err
    assert cli.main(["fleet", "--backends", "nohost"]) == 2


def _gateway(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    eng = Engine(ServeConfig(emit_records=False, lanes=2, chunk=8,
                             buckets=(32,), out_dir=str(d)), device="cpu")
    return Gateway(eng, "127.0.0.1", 0).start()


def test_fleet_cli_end_to_end(tmp_path):
    """``fleet --backends ... --json`` in a process of its own: it prints
    its address, routes a POST over both gateways, drains on ``/drainz``
    and ends with the ``fleet_summary`` line."""
    gws = [_gateway(tmp_path, f"g{i}") for i in range(2)]
    proc = None
    try:
        spec = ",".join(f"b{i}={gw.address}" for i, gw in enumerate(gws))
        proc = subprocess.Popen(
            [sys.executable, "-m", "heat_tpu_torch", "fleet", "--backends",
             spec, "--health-interval", "0.2", "--json", "--trace",
             str(tmp_path / "fleet.trace.json")],
            cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, "PYTHONPATH": str(_REPO)})
        assert select.select([proc.stdout], [], [], TIMEOUT)[0], \
            "the fleet CLI printed nothing"
        first = proc.stdout.readline()
        assert "fleet router listening on http://" in first, first
        base = "http://" + first.split("http://")[1].split()[0]
        deadline = time.monotonic() + TIMEOUT
        while True:
            with urllib.request.urlopen(f"{base}/v1/status",
                                        timeout=TIMEOUT) as r:
                st = json.loads(r.read())
            if all(b["probe_passes"] for b in st["backends"].values()):
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.05)
        body = "".join(json.dumps(dict(id=f"q{i}", n=24, ntime=32,
                                       dtype="float64")) + "\n"
                       for i in range(4)).encode()
        req = urllib.request.Request(f"{base}/v1/solve", data=body)
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            recs = [json.loads(x) for x in r.read().splitlines() if x]
        assert sorted(r["id"] for r in recs) == [f"q{i}" for i in range(4)]
        assert all(r["status"] == "ok" for r in recs)
        req = urllib.request.Request(f"{base}/drainz", data=b"")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert json.loads(r.read())["draining"] is True
        out, _ = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, out
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["event"] == "fleet_summary"
        assert summary["requests"] == 4 and summary["duplicates"] == 0
        assert (tmp_path / "fleet.trace.json").exists()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(TIMEOUT)
        for gw in gws:
            try:
                gw.request_drain()
                gw.wait_drained(TIMEOUT)
            finally:
                gw.close()
                gw.engine.shutdown(timeout=TIMEOUT)


def _lab(module, tmp_path, *argv):
    out = tmp_path / "lab.json"
    proc = subprocess.run(
        [sys.executable, "-m", module, "--device", "cpu", "--out", str(out),
         "--workdir", str(tmp_path / "work"), *argv],
        cwd=_REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(_REPO), "OMP_NUM_THREADS": "1"})
    assert out.exists(), proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc, json.loads(out.read_text())


def test_fleet_lab_runs_on_the_cpu(tmp_path):
    """Scaling over 1, 2 and 4 backend processes, the byte sample, the
    kill drill and the steal drill, at 6 requests."""
    proc, rec = _lab("heat_tpu_torch.labs.fleet_lab", tmp_path,
                     "--requests", "6", "--sink-ms", "50")
    assert rec["bench"] == "fleet_lab" and rec["config"]["device"] == "cpu"
    for nb in (1, 2, 4):
        s = rec["scaling"][f"fleet_{nb}"]
        assert s["ok"] == s["records"] == 6
        assert sum(s["per_backend_delivered"].values()) == 6
    assert rec["fleet_bit_identical"]
    kill = rec["kill_drill"]
    assert rec["kill_zero_lost"] and rec["kill_zero_duplicates"], kill
    assert kill["victim_recovered"] and kill["flight_dumps"] >= 1
    # killed only after a checkpoint of its own wave: the recovery resumes
    # that manifest, not one left by the scaling waves
    assert kill["generation_at_kill"] > kill["generation_before"]
    assert kill["resumed_generation"] >= kill["generation_at_kill"]
    steal = rec["steal_drill"]
    assert steal["all_ok"] and steal["duplicates"] == 0, steal
    assert steal["generation"] >= 1
    assert steal["recovered_requests"] + steal["redriven_requests"] >= 1
    assert "fleet_lab: " in proc.stdout


def test_fleet_resilience_lab_runs_on_the_cpu(tmp_path):
    """The flap, stream-cut, hedge and deadline drills at 8 requests."""
    proc, rec = _lab("heat_tpu_torch.labs.fleet_resilience_lab", tmp_path,
                     "--requests", "8")
    flap = rec["flap_drill"]
    assert rec["flap_availability"] == 1.0 and rec["flap_bit_identical"]
    assert flap["breaker_transitions"] >= 1 and flap["steals"] == 0
    assert rec["cut_zero_lost"] and rec["cut_zero_duplicates"]
    assert rec["cut_drill"]["stream_cuts"] >= 1
    hedge = rec["hedge_drill"]
    assert hedge["status"] == "ok" and hedge["fired"] == 1
    assert rec["hedge_bit_identical"]
    assert rec["deadline_shed_exact"]
    assert "fleet_resilience_lab: " in proc.stdout


def test_labs_default_to_the_card(tmp_path):
    """Without ``--device cpu`` a lab's backends serve on the card: on a
    host without one they fail instead of dropping to the CPU."""
    from heat_tpu_torch.labs import fleet_lab, fleet_resilience_lab

    env = {**os.environ, "PYTHONPATH": str(_REPO),
           "CUDA_VISIBLE_DEVICES": ""}
    b = fleet_lab.BackendProc("nocard", tmp_path, env)
    try:
        with pytest.raises(RuntimeError, match="exited rc=2"):
            b.wait_address(timeout=TIMEOUT)
    finally:
        b.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fleet_resilience_lab.make_backend(tmp_path, "nocard2")
