"""A fenced round counts its boundary before it judges, as the reference
does, so ``engine-kill@N`` at a request's final fenced boundary kills the
engine BEFORE that request retires.

Both packages serve the same JSONL file in a subprocess on the CPU with
``--dispatch-depth off``, interval engine checkpoints and
``--inject engine-kill@N``, N the final boundary of the first request to
finish: once for a packed bucket, once for a mega-lane
(``--mega-lanes 1``, a request over every bucket). A probe wrapped around
``Engine._note_boundary`` prints, at boundary N and before the kill, which
requests the engine has retired so far (the records stamped with
``steps_done``), and drains the writer thread, so that whatever was queued
before the kill is on disk, and the outcome does not hang on a race with
the SIGKILL. Then each package resumes its own
checkpoint directory with ``serve --resume``. The killed runs' records and
npz files, the manifest ``--resume`` reads and the resumed runs' records
and npz bytes must equal the reference's.
"""

import json
import math
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# Wrap Engine._note_boundary: at boundary N (argv[2]) print the retired
# request ids and let the writer thread finish every job queued so far (the
# checkpoint generations, and any result a premature verdict queued), then
# run the real method, which fires engine-kill@N.
PROBE = r"""
import json, sys
pkg, n_kill = sys.argv[1], int(sys.argv[2])
if pkg == "heat_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
sch = __import__(pkg + ".serve.scheduler", fromlist=["Engine"])
cli = __import__(pkg + ".cli", fromlist=["main"])
orig = sch.Engine._note_boundary
def probed(self):
    if self.boundaries_total + 1 == n_kill:
        with self._lock:
            retired = sorted(r["id"] for r in self._records
                             if r.get("steps_done") is not None)
        print("PROBE " + json.dumps({"boundary": n_kill,
                                     "retired": retired}), flush=True)
        self._active_writer.drain()
    orig(self)
sch.Engine._note_boundary = probed
sys.exit(cli.main(sys.argv[3:]))
"""


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
            "PYTHONPATH": str(ROOT) + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def _serve(pkg, argv, n_kill=0):
    return subprocess.run(
        [sys.executable, "-c", PROBE, pkg, str(n_kill), "serve", *argv]
        + (["--device", "cpu"] if pkg == "heat_tpu_torch" else []),
        env=_env(), capture_output=True, timeout=300, cwd=str(ROOT))


def _lines(out: bytes, prefix: str):
    return [ln for ln in out.decode().splitlines() if ln.startswith(prefix)]


def _records(out: bytes):
    """Request records by id, without the wall-clock and per-package
    fields (timings, trace ids, the port's device and kernel names)."""
    keep = ("id", "status", "steps_done", "ntime", "n", "ndim", "dtype",
            "placement", "resumed", "exit", "error")
    recs = {}
    for ln in _lines(out, "{"):
        r = json.loads(ln)
        if r.get("event") == "serve_request":
            recs[r["id"]] = {k: r.get(k) for k in keep}
    return recs


def _manifest(d: Path):
    gens = sorted(d.glob("engine_gen*.json"))
    assert gens, f"no engine checkpoint generation under {d}"
    man = json.loads(gens[-1].read_text())
    for e in man["inflight"] + man["queued"]:
        e.pop("lane_s", None)
        num = e.pop("numerics", None)
        e["numerics"] = None if num is None else sorted(num)
        e["cfg"] = {k: v for k, v in e["cfg"].items() if k != "backend"}
    return gens[-1].name, man


def _npz(d: Path):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.npz"))}


CHUNK = 8
CASES = {
    # two lanes of one bucket: "a" finishes first, at boundary 3
    "packed": ([dict(id="a", n=12, ntime=24),
                dict(id="b", n=10, ntime=40, bc="ghost", bc_value=1.0,
                     ic="hat_small")],
               ["--buckets", "16", "--lanes", "2"], "a"),
    # one request over every bucket, served as a mega-lane
    "mega": ([dict(id="big", n=24, ntime=40, ic="hat_half")],
             ["--buckets", "16", "--lanes", "2", "--mega-lanes", "1"],
             "big"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_kill_at_a_final_fenced_boundary_matches_the_reference(
        case, tmp_path):
    reqs, knobs, first = CASES[case]
    path = tmp_path / "reqs.jsonl"
    path.write_text("".join(json.dumps(dict(r, dtype="float32")) + "\n"
                            for r in reqs))
    n_kill = math.ceil(next(r["ntime"] for r in reqs if r["id"] == first)
                       / CHUNK)
    base = ["--requests", str(path), "--chunk", str(CHUNK),
            "--dispatch-depth", "off", "--engine-ckpt-interval", "2",
            *knobs]
    got = {}
    for pkg in ("heat_tpu", "heat_tpu_torch"):
        d = tmp_path / pkg
        ck = d / "ck"
        killed = _serve(pkg, base + ["--out-dir", str(d / "killed"),
                                     "--engine-ckpt-dir", str(ck),
                                     "--inject", f"engine-kill@{n_kill}"],
                        n_kill)
        assert killed.returncode == -signal.SIGKILL, (
            pkg, killed.returncode, killed.stderr.decode()[-2000:])
        probe = _lines(killed.stdout, "PROBE ")
        assert len(probe) == 1, (pkg, killed.stdout.decode()[-2000:])
        manifest = _manifest(ck)
        resumed = _serve(pkg, base + ["--out-dir", str(d / "resumed"),
                                      "--engine-ckpt-dir", str(ck),
                                      "--resume", str(ck)])
        assert resumed.returncode == 0, (pkg,
                                         resumed.stderr.decode()[-2000:])
        got[pkg] = dict(probe=json.loads(probe[0][len("PROBE "):]),
                        killed_records=_records(killed.stdout),
                        killed_npz=_npz(d / "killed"),
                        manifest=manifest,
                        resumed_records=_records(resumed.stdout),
                        resumed_npz=_npz(d / "resumed"))
    ref, port = got["heat_tpu"], got["heat_tpu_torch"]
    # the kill lands before the request's last verdict, in both
    assert ref["probe"] == {"boundary": n_kill, "retired": []}
    assert port["probe"] == ref["probe"]
    assert port["killed_records"] == ref["killed_records"] == {}
    assert port["killed_npz"] == ref["killed_npz"] == {}
    assert port["manifest"] == ref["manifest"]
    assert {e["id"] for e in ref["manifest"][1]["inflight"]} >= {first}
    assert port["resumed_records"] == ref["resumed_records"]
    assert sorted(ref["resumed_records"]) == sorted(r["id"] for r in reqs)
    assert all(r["status"] == "ok" and r["resumed"]
               for r in ref["resumed_records"].values())
    assert port["resumed_npz"] == ref["resumed_npz"]
    assert sorted(ref["resumed_npz"]) == sorted(f"{r['id']}.npz"
                                                for r in reqs)
