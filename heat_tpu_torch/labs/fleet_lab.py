"""Fleet-router scaling and chaos lab: 1/2/4 backend processes behind one
router (the port of ``benchmarks/fleet_lab.py``).

Four claims, one harness:

- **Scaling**: a 64-request population (sides 24/32/48, f64), each
  request carrying ``inject: sink-slow:ms=200`` (a writer-sink sleep that
  stands in for per-request device/IO time on a host that has little;
  results are untouched; ``--sink-ms 0`` turns it off), drained through
  the router over 1, 2 and 4 backend PROCESSES. The gate is >= 1.7x at 2
  backends and no worse at 4.
- **Bit-identity**: a sample of the fleet's npz outputs must be byte-equal
  to a direct engine solve of the same request on the same device — the
  router routes, it never does arithmetic.
- **Kill drill**: at 2 backends, one backend process is SIGKILLed
  mid-wave, once it has published an engine checkpoint of that wave
  (the processes are reused from the scaling waves, so an older
  manifest would resume lanes already delivered). The router sees the
  loss, flight-dumps its fleet timeline, resumes the victim's newest
  engine-checkpoint manifest on the survivor and re-drives the rest:
  every request reaches one terminal ok record, none lost, none
  delivered twice.
- **Steal**: a forced ``/drainz?handoff=1`` checkpoint-handoff steal from
  a loaded backend to an idle one, with the recovery wall (drain +
  manifest pickup + resume) and the requests migrated mid-flight.

Backends are ``python -m heat_tpu_torch serve --listen`` subprocesses on
localhost ports, on the card unless ``--device cpu``; the router runs in
this process, so its counters and steal events can be read directly.
Walls run from the first POST with every backend already probed
(start-up and first launches are paid before the clock starts). Four
processes serve every phase: the scaling fleet, then two of them for the
kill drill and the other two for the steal.

    python -m heat_tpu_torch.labs.fleet_lab [--requests 64] [--device cpu]

The functions take the request lines and backends as arguments, so a
caller (``chip_smoke.py``) drives them with its own population.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

from . import _util
from ._util import ARTIFACTS, REPO, write_atomic

LISTEN_RE = re.compile(r"listening on http://([0-9.]+):(\d+)")
MANIFEST_RE = re.compile(r"engine_gen(\d{8})\.json$")
SINK_MS = 200
# the reference lab's backend: lanes 4, chunk 16, buckets (32, 48)
SERVE_ARGS = ("--lanes", "4", "--chunk", "16", "--buckets", "32,48")
TIMEOUT = 600.0


def require(cond, msg: str) -> None:
    """A drill's precondition or outcome: raise, whatever ``-O`` says."""
    if not cond:
        raise RuntimeError(msg)


def wait_for(pred, timeout: float, interval: float = 0.05) -> bool:
    """Poll ``pred`` until it holds or ``timeout`` seconds pass."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


class BackendProc:
    """One ``serve --listen`` subprocess; its output goes to a log file
    that is polled for the bound port (``--listen 127.0.0.1:0``)."""

    def __init__(self, name: str, workdir: Path, env: dict,
                 device: str = "cuda", serve_args=SERVE_ARGS,
                 ckpt_interval: int = 2):
        self.name = name
        self.dir = workdir / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.log = self.dir / "serve.log"
        self.ckpt_dir = self.dir / "ckpt"
        cmd = [sys.executable, "-m", "heat_tpu_torch", "serve",
               "--listen", "127.0.0.1:0", *serve_args,
               "--out-dir", str(self.dir),
               "--engine-ckpt-interval", str(ckpt_interval),
               "--engine-ckpt-dir", str(self.ckpt_dir)]
        if device == "cpu":
            cmd += ["--device", "cpu"]
        with self.log.open("wb") as log:
            self.proc = subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT, env=env,
                                         cwd=str(REPO))
        self.address = None

    def wait_address(self, timeout: float = 180.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"backend {self.name} exited rc={self.proc.returncode}:"
                    f"\n{self.log.read_text()[-2000:]}")
            m = LISTEN_RE.search(self.log.read_text(errors="replace"))
            if m:
                self.address = f"{m.group(1)}:{m.group(2)}"
                return self.address
            time.sleep(0.1)
        raise RuntimeError(f"backend {self.name} never bound a port")

    def wait_healthy(self, timeout: float = 60.0) -> None:
        host, _, port = self.address.rpartition(":")

        def up():
            try:
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=5)
                conn.request("GET", "/healthz")
                ok = conn.getresponse().status == 200
                conn.close()
                return ok
            except OSError:
                return False

        if not wait_for(up, timeout, 0.1):
            raise RuntimeError(f"backend {self.name} never went healthy")

    def ckpt_generation(self) -> int:
        """The newest engine manifest generation in this backend's
        checkpoint directory (0 before the first), read from the files."""
        gens = [int(m.group(1)) for p in self.ckpt_dir.glob("engine_gen*")
                for m in [MANIFEST_RE.match(p.name)] if m]
        return max(gens, default=0)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.kill()


def build_requests(count: int, dtype: str = "float64"):
    """The serve lab's population (``_util.build_requests``) as request
    keyword dicts."""
    return [dict(n=c.n, ntime=c.ntime, dtype=c.dtype, bc=c.bc, ic=c.ic,
                 nu=c.nu) for c in _util.build_requests(count, dtype)]


def build_lines(count: int, prefix: str, sink_ms: int = SINK_MS):
    """The population as request lines, each carrying the writer-sink
    sleep (none at ``sink_ms`` 0)."""
    lines = []
    for i, kw in enumerate(build_requests(count)):
        lines.append(dict(id=f"{prefix}-r{i}", **kw))
        if sink_ms:
            lines[-1]["inject"] = f"sink-slow:ms={sink_ms}"
    return lines


def cell_steps(lines) -> int:
    return sum(int(ln["n"]) ** int(ln.get("ndim", 2)) * int(ln["ntime"])
               for ln in lines)


def post_stream(rt, lines, timeout: float = TIMEOUT):
    """One streaming POST through the router; returns the terminal
    records (the wall the caller measures around this IS the wave)."""
    body = "".join(json.dumps(ln) + "\n" for ln in lines).encode()
    conn = http.client.HTTPConnection(rt.host, rt.port, timeout=timeout)
    try:
        conn.request("POST", "/v1/solve", body=body)
        resp = conn.getresponse()
        recs = []
        while True:
            raw = resp.readline()
            if not raw:
                break
            raw = raw.strip()
            if raw:
                recs.append(json.loads(raw))
    finally:
        conn.close()
    return recs


def wait_probed(rt, timeout: float = 60.0) -> None:
    """Block until every backend has answered one status probe, so the
    first placement sees real payloads."""
    if not wait_for(lambda: all(b.status is not None
                                for b in rt.registry.snapshot()), timeout):
        raise RuntimeError("the router never probed every backend")


def make_router(addresses, **fcfg_kw):
    from ..fleet.registry import BackendRegistry, parse_backends
    from ..fleet.router import FleetConfig, Router

    spec = ",".join(f"{n}={a}" for n, a in addresses)
    fcfg_kw.setdefault("health_interval_s", 0.5)
    rt = Router(BackendRegistry(parse_backends(spec)), "127.0.0.1", 0,
                FleetConfig(**fcfg_kw))
    return rt.start()


def warm_backend(b, lines, timeout: float = 300.0):
    """Pay a backend's first launches before any timed wave: a short
    sink-free wave POSTed DIRECTLY to it."""
    host, _, port = b.address.rpartition(":")
    body = "".join(json.dumps(dict(ln, id=f"{b.name}-{ln['id']}")) + "\n"
                   for ln in lines).encode()
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("POST", "/v1/solve", body=body)
        resp = conn.getresponse()
        while resp.readline():
            pass
    finally:
        conn.close()


def run_wave(backends, lines):
    """Drain the wave through a fresh router over already-warm backends;
    returns (wall_s, records, snapshot)."""
    rt = make_router([(b.name, b.address) for b in backends])
    try:
        wait_probed(rt)
        t0 = time.perf_counter()
        recs = post_stream(rt, lines)
        wall = time.perf_counter() - t0
        snap = rt.snapshot()
    finally:
        rt.close()
    return wall, recs, snap


def direct_solve(line: dict, device: str, chunk: int = 16, buckets=None):
    """The field of one request served by a direct engine (no router) on
    ``device`` (by default in this lab's chunk, in a bucket of its side):
    what the fleet's bytes must equal."""
    from ..config import config_from_request
    from ..serve import Engine, ServeConfig

    kw = {k: v for k, v in line.items()
          if k not in ("id", "inject", "tenant", "class", "deadline_ms")}
    cfg = config_from_request(kw)
    eng = Engine(ServeConfig(lanes=1, chunk=chunk, emit_records=False,
                             buckets=buckets or (max(32, int(cfg.n)),)),
                 device=device)
    eng.submit(cfg, request_id="direct")
    (rec,) = eng.run()
    if rec["status"] != "ok":
        raise RuntimeError(f"direct solve failed: {rec}")
    return rec["T"]


def check_sample(backends, lines, sample_idx, reference=None,
                 device: str = "cuda"):
    """npz byte-identity of a sample: each fleet output is found in
    exactly one backend's directory and its field equals ``reference``
    (``line -> array``; default a direct engine solve on ``device``) in
    dtype, shape and bytes."""
    import numpy as np

    reference = reference or (lambda ln: direct_solve(ln, device))
    for i in sample_idx:
        rid = lines[i]["id"]
        paths = [b.dir / f"{rid}.npz" for b in backends
                 if (b.dir / f"{rid}.npz").exists()]
        if len(paths) != 1:
            return False
        with np.load(paths[0]) as z:
            got = z["T"]
        want = np.asarray(reference(lines[i]))
        if (got.dtype != want.dtype or got.shape != want.shape
                or got.tobytes() != want.tobytes()):
            return False
    return True


def _resumed_total(b) -> int:
    """The requests a backend has re-admitted from checkpoint manifests
    (``serve_resumed`` of its ``/v1/status``)."""
    host, _, port = b.address.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", "/v1/status")
        return int(json.loads(conn.getresponse().read())
                   .get("serve_resumed", 0))
    finally:
        conn.close()


def kill_drill(backends, lines, flight_dir):
    """SIGKILL the first of two backends mid-wave, once it has published
    an engine checkpoint of this wave with work still pending there; the
    router must recover the victim's checkpointed work onto the survivor
    and still deliver every request exactly once. Waiting for a new
    generation keeps the recovery from resuming a manifest of an earlier
    wave (whose lanes were delivered already)."""
    rt = make_router([(b.name, b.address) for b in backends],
                     flightrec_dir=str(flight_dir))
    victim, survivor = backends[0], backends[1]
    try:
        wait_probed(rt)
        gen0 = victim.ckpt_generation()
        resumed0 = _resumed_total(survivor)
        recs = []
        t0 = time.perf_counter()
        waver = threading.Thread(
            target=lambda: recs.extend(post_stream(rt, lines)))
        waver.start()
        # kill the victim once it is genuinely mid-wave: a checkpoint of
        # this wave on disk, requests still pending there
        wait_for(lambda: (victim.ckpt_generation() > gen0
                          or not waver.is_alive()), TIMEOUT)
        gen_kill = victim.ckpt_generation()
        require(gen_kill > gen0
                and rt.registry.get(victim.name).pending_requests > 0,
                "the victim finished its share of the wave before its "
                "first checkpoint of it")
        t_kill = time.perf_counter()
        victim.kill()
        waver.join(timeout=TIMEOUT)
        wall = time.perf_counter() - t0
        require(not waver.is_alive(), "kill-drill wave never finished")
        # the loss is seen by a relay's broken stream or, once the wave
        # is over, by the next health probe: wait for its recovery
        wait_for(lambda: (rt.registry.get(victim.name).lost
                          and rt.tracer.dumps >= 1), 60)
        snap = rt.snapshot()
    finally:
        rt.close()
    statuses = [r.get("status") for r in recs]
    ids = [r.get("id") for r in recs]
    return {
        "generation_before": gen0,
        "generation_at_kill": gen_kill,
        # the newest manifest on disk is the one the recovery resumed
        "resumed_generation": victim.ckpt_generation(),
        "resumed_requests": _resumed_total(survivor) - resumed0,
        "wall_s": round(wall, 3),
        "after_kill_s": round(wall - (t_kill - t0), 3),
        "records": len(recs),
        "ok": statuses.count("ok"),
        "zero_lost": (sorted(ids) == sorted(ln["id"] for ln in lines)
                      and statuses.count("ok") == len(lines)),
        "zero_duplicates": (snap["router"]["duplicates"] == 0
                            and len(ids) == len(set(ids))),
        "victim_recovered": snap["backends"][victim.name]["lost"],
        "victim_delivered_before_kill": snap["backends"][victim.name][
            "delivered"],
        "flight_dumps": len(list(Path(flight_dir).glob(
            "flightrec-*.trace.json"))),
    }


def steal_drill(victim, thief, lines, workdir):
    """Forced checkpoint-handoff steal from a loaded backend to an idle
    one; records the end-to-end recovery wall. The victim drains to its
    checkpoint and exits."""
    from ..fleet.registry import BackendRegistry
    from ..fleet.router import FleetConfig, Router

    bfile = workdir / "steal_backends.txt"
    bfile.write_text(f"{victim.name}={victim.address}\n")
    rt = Router(BackendRegistry(backends_file=bfile), "127.0.0.1", 0,
                FleetConfig(health_interval_s=0.3)).start()
    try:
        wait_probed(rt)
        body = "".join(json.dumps(ln) + "\n" for ln in lines).encode()
        conn = http.client.HTTPConnection(rt.host, rt.port, timeout=60)
        conn.request("POST", "/v1/solve?wait=0", body=body)
        require(conn.getresponse().status == 202, "the wave was refused")
        conn.close()
        # the victim mid-wave: an engine checkpoint published since the
        # wave began, seen through its /v1/status, with work still pending
        vb = rt.registry.get(victim.name)

        def generation():
            return int(((vb.status or {}).get("engine_ckpt")
                        or {}).get("generation") or 0)

        gen0 = generation()
        wait_for(lambda: generation() > gen0 or not rt.pending_count(),
                 TIMEOUT)
        require(generation() > gen0 and rt.pending_count(),
                "the victim finished the wave before its first checkpoint")
        bfile.write_text(f"{victim.name}={victim.address}\n"
                         f"{thief.name}={thief.address}\n")
        require(wait_for(lambda: rt.registry.get(thief.name) is not None,
                         30), "the thief never joined")
        pending_at_steal = rt.pending_count()
        ev = rt.steal(victim.name, thief.name, reason="lab")
        require(ev is not None, "steal refused")
        wait_for(lambda: rt.pending_count() == 0, TIMEOUT, 0.1)
        ok = 0
        for ln in lines:
            conn = http.client.HTTPConnection(rt.host, rt.port,
                                              timeout=30)
            conn.request("GET", f"/v1/requests/{ln['id']}")
            resp = conn.getresponse()
            rec = json.loads(resp.read())
            conn.close()
            ok += resp.status == 200 and rec.get("status") == "ok"
        dup = rt.snapshot()["router"]["duplicates"]
    finally:
        rt.close()
    return {
        "pending_at_steal": pending_at_steal,
        "recovered_requests": ev["recovered"],
        "redriven_requests": ev["redriven"],
        "recovery_s": ev["wall_s"],
        "drain_s": ev["drain_s"],
        "resume_s": ev["resume_s"],
        "generation": ev["generation"],
        "duplicates": dup,
        "all_ok": ok == len(lines),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--sink-ms", type=int, default=SINK_MS)
    ap.add_argument("--out", default=str(ARTIFACTS / "fleet_lab.json"))
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh TemporaryDirectory)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the backends serve (default cuda)")
    args = ap.parse_args(argv)

    import tempfile

    tmp = None
    if args.workdir:
        workdir = Path(args.workdir)
        workdir.mkdir(parents=True, exist_ok=True)
    else:
        tmp = tempfile.TemporaryDirectory(prefix="heat-tpu-torch-fleet-lab-")
        workdir = Path(tmp.name)

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    work = cell_steps(build_requests(args.requests))
    # a short sink-free wave covering all three sides pays each backend's
    # first launches before any timed wave
    warmup = build_lines(6, "w", sink_ms=0)

    print(f"fleet_lab: starting 4 backend processes on {args.device} under "
          f"{workdir}", flush=True)
    fleet = [BackendProc(f"s{i}", workdir, env, device=args.device)
             for i in range(4)]
    rec = {}
    try:
        for b in fleet:
            b.wait_address()
        for b in fleet:
            b.wait_healthy()
        for b in fleet:
            warm_backend(b, warmup)

        walls, scaling = {}, {}
        sample = sorted({0, args.requests // 2, args.requests - 1})
        bit_identical = True
        for nb in (1, 2, 4):
            lines = build_lines(args.requests, f"f{nb}",
                                sink_ms=args.sink_ms)
            wall, recs, snap = run_wave(fleet[:nb], lines)
            per_backend = {n: b["delivered"]
                           for n, b in snap["backends"].items()}
            oks = sum(r.get("status") == "ok" for r in recs)
            walls[nb] = wall
            scaling[f"fleet_{nb}"] = {
                "wall_s": round(wall, 3),
                "points_per_s": round(work / wall, 1),
                "ok": oks, "records": len(recs),
                "per_backend_delivered": per_backend,
                "retries": snap["router"]["retries"],
            }
            print(f"fleet_lab: F={nb} wall {wall:.2f}s ok {oks}/"
                  f"{len(lines)} split {per_backend}", flush=True)
            require(oks == len(lines), f"{scaling[f'fleet_{nb}']}")
            if nb == 2:
                bit_identical = check_sample(fleet[:nb], lines, sample,
                                             device=args.device)

        kill = kill_drill(fleet[2:4],
                          build_lines(args.requests, "kd",
                                      sink_ms=args.sink_ms),
                          workdir / "flightrec")
        print(f"fleet_lab: kill drill {kill}", flush=True)
        # double the sink on a deeper wave so the victim is genuinely
        # mid-flight when the steal fires (lanes occupied and queue work
        # for the manifest to cover)
        steal = steal_drill(fleet[1], fleet[0],
                            build_lines(16, "st",
                                        sink_ms=2 * args.sink_ms),
                            workdir)
        print(f"fleet_lab: steal drill {steal}", flush=True)

        speedup2 = walls[1] / walls[2] if walls[2] > 0 else None
        speedup4 = walls[1] / walls[4] if walls[4] > 0 else None
        rec = {
            "bench": "fleet_lab",
            **_util.stamp(args.device),
            "config": {"requests": args.requests,
                       "sink_ms": args.sink_ms,
                       "device": args.device,
                       "population": "serve_lab sides 24/32/48",
                       "backend": "python -m heat_tpu_torch serve "
                                  "subprocess, lanes 4, chunk 16, "
                                  "buckets (32,48), engine-ckpt-interval 2",
                       "policy": "least-loaded"},
            "work_cell_steps": work,
            "scaling": scaling,
            "speedup_2_backends": round(speedup2, 2) if speedup2 else None,
            "speedup_4_backends": round(speedup4, 2) if speedup4 else None,
            "monotone_at_4": bool(walls[4] <= walls[2]),
            "fleet_bit_identical": bool(bit_identical),
            "kill_drill": kill,
            "kill_zero_lost": bool(kill["zero_lost"]),
            "kill_zero_duplicates": bool(kill["zero_duplicates"]),
            "steal_drill": steal,
            "steal_recovered_requests": steal["recovered_requests"],
            "steal_recovery_s": steal["recovery_s"],
        }
    finally:
        for b in fleet:
            b.stop()
        if tmp is not None:
            tmp.cleanup()

    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (rec["speedup_2_backends"] is not None
              and rec["speedup_2_backends"] >= 1.7
              and rec["monotone_at_4"]
              and rec["fleet_bit_identical"]
              and rec["kill_zero_lost"]
              and rec["kill_zero_duplicates"]
              and rec["steal_recovered_requests"] >= 1
              and steal["all_ok"]
              and kill["victim_recovered"]
              and kill["flight_dumps"] >= 1)
    print(f"fleet_lab: {'OK' if passed else 'FAILED'} — 2-backend "
          f"speedup {rec['speedup_2_backends']}x (gate >= 1.7), 4-backend "
          f"{rec['speedup_4_backends']}x monotone={rec['monotone_at_4']}; "
          f"kill drill lost=0:{rec['kill_zero_lost']} "
          f"dup=0:{rec['kill_zero_duplicates']}; steal moved "
          f"{rec['steal_recovered_requests']} mid-flight + "
          f"{steal['redriven_requests']} re-driven in "
          f"{rec['steal_recovery_s']}s")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
