"""Fleet resilience lab: flap, stream-cut, hedge and deadline drills (the
port of ``benchmarks/fleet_resilience_lab.py``).

Four drills over in-process ``Engine``+``Gateway`` backends behind the
fleet router — in-process because every drill measures the ROUTER's
resilience machinery (breakers, re-drive, hedging, deadline shedding),
not process spin-up, and in-process backends make the chaos timing
deterministic enough to gate on. The engines serve on the card unless
``--device cpu``:

- **Flap drill**: a 4-backend fleet drains the same sink-slow wave
  twice — healthy, then with ``backend-flap`` chaos square-waving one
  backend. Gates: availability stays >= 0.99 (zero rows lost to the
  flap), tail latency degrades no worse than the capacity loss
  (p99 ratio <= 1.5 ~ the 4/3 theoretical + margin), the outputs stay
  bit-identical, and the breaker's transition cooldown keeps the steal
  loop quiet while the incident is live (no flap-induced steal thrash).
- **Stream-cut drill**: ``stream-cut@N`` kills a relay socket
  mid-stream while the backend stays healthy; the bounded re-drive
  path must deliver every row exactly once (zero lost, zero duplicate).
- **Hedge drill**: one backend is pre-loaded OUTSIDE the router so the
  placement view is stale; an interactive row stalls there and must be
  hedged onto the idle backend, win, and return bytes identical to a
  direct engine solve.
- **Deadline drill**: rows with spent edge-minted budgets are shed
  with structured ``deadline`` records and zero backend dispatch
  (never billed a device step); live-budget rows ride the propagated
  ``X-Deadline-Ms`` header end-to-end and complete.

    python -m heat_tpu_torch.labs.fleet_resilience_lab [--device cpu]
        [--dtype float32] [--gates bytes]

``--gates bytes`` gates only what the drills hold exactly (availability,
bytes, zero lost or duplicate rows, the hedge's and the shed's outcome)
and prints the timing gates; with ``HEAT_TPU_LOCKCHECK=1`` or
``HEAT_TPU_RACECHECK=1|record`` in the environment the record carries the
lock-order watchdog's and the race sanitizer's findings
(``invariant_guard``), and any of them fails the lab.

Every drill takes ``device`` and ``dtype`` arguments and returns its
record, so a caller (``chip_smoke.py``) runs them at its own population;
the bytes are held to a direct engine solve of the same request on the
same device (``fleet_lab.direct_solve``).
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import time
from pathlib import Path

from ._util import ARTIFACTS, stamp, write_atomic
from .fleet_lab import direct_solve, require, wait_for, wait_probed

SINK_MS = 120
TIMEOUT = 600.0
# every drill's backend: lanes 2, chunk 8, buckets (32,)
BACKEND = dict(lanes=2, chunk=8, buckets=(32,))


def make_backend(workdir: Path, name: str, device: str = "cuda", **kw):
    from ..serve import Engine, ServeConfig
    from ..serve.gateway import Gateway

    d = workdir / name
    d.mkdir(parents=True, exist_ok=True)
    kw.setdefault("emit_records", False)
    for k, v in BACKEND.items():
        kw.setdefault(k, v)
    kw.setdefault("out_dir", str(d))
    kw.setdefault("engine_ckpt_interval", 4)
    kw.setdefault("engine_ckpt_dir", str(d / "ckpt"))
    return Gateway(Engine(ServeConfig(**kw), device=device), "127.0.0.1",
                   0).start()


def make_router(gws, **fcfg_kw):
    from ..fleet.registry import BackendRegistry, parse_backends
    from ..fleet.router import FleetConfig, Router

    spec = ",".join(f"b{i}={gw.address}" for i, gw in enumerate(gws))
    fcfg_kw.setdefault("health_interval_s", 0.2)
    rt = Router(BackendRegistry(parse_backends(spec)), "127.0.0.1", 0,
                FleetConfig(**fcfg_kw))
    return rt.start()


def build_lines(count: int, prefix: str, sink_ms: int = SINK_MS,
                dtype: str = "float64"):
    lines = []
    for i in range(count):
        lines.append({"id": f"{prefix}-r{i}", "n": 24,
                      "ntime": 48 + 16 * (i % 2), "dtype": dtype,
                      "ic": "hat", "bc": "edges", "nu": 0.05})
        if sink_ms:
            lines[-1]["inject"] = f"sink-slow:ms={sink_ms}"
    return lines


def post_stream(host, port, lines, query="", headers=(),
                timeout: float = TIMEOUT):
    """One streaming POST; returns (records, per-record latencies_s)."""
    body = "".join(json.dumps(ln) + "\n" for ln in lines).encode()
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", f"/v1/solve{query}", body=body,
                     headers=dict(headers))
        resp = conn.getresponse()
        recs, lats = [], []
        while True:
            raw = resp.readline()
            if not raw:
                break
            raw = raw.strip()
            if raw:
                recs.append(json.loads(raw))
                lats.append(time.perf_counter() - t0)
    finally:
        conn.close()
    return recs, lats


def p99(lats):
    if not lats:
        return None
    s = sorted(lats)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def check_bits(gws, lines, sample_idx, suffix="", device: str = "cuda"):
    """npz byte-identity of a sample vs direct engine solves on
    ``device``."""
    import numpy as np

    for i in sample_idx:
        rid = lines[i]["id"] + suffix
        paths = [Path(gw.engine.scfg.out_dir) / f"{rid}.npz" for gw in gws
                 if (Path(gw.engine.scfg.out_dir) / f"{rid}.npz").exists()]
        if len(paths) != 1:
            return False
        with np.load(paths[0]) as z:
            got = z["T"]
        want = np.asarray(direct_solve(lines[i], device,
                                       chunk=BACKEND["chunk"],
                                       buckets=BACKEND["buckets"]))
        if (got.dtype != want.dtype or got.shape != want.shape
                or got.tobytes() != want.tobytes()):
            return False
    return True


def close_all(rt, gws):
    if rt is not None:
        rt.close()
    for gw in gws:
        try:
            gw.request_drain()
            gw.wait_drained(120)
        finally:
            gw.close()
            gw.engine.shutdown(timeout=120)


def flap_drill(workdir: Path, requests: int, sink_ms: int,
               device: str = "cuda", dtype: str = "float64"):
    """Healthy wave vs flapping-backend wave over the same 4 backends."""
    gws = [make_backend(workdir, f"fl{i}", device) for i in range(4)]
    sample = sorted({0, requests // 2, requests - 1})
    try:
        # pay every backend's first launches before any timed wave so
        # the p99 ratio compares serving latency, not cold starts
        for i, gw in enumerate(gws):
            host, _, port = gw.address.rpartition(":")
            post_stream(host, int(port),
                        build_lines(2, f"warm{i}", sink_ms=0, dtype=dtype))
        # healthy baseline
        rt = make_router(gws)
        try:
            wait_probed(rt)
            lines = build_lines(requests, "base", sink_ms, dtype)
            recs, lats = post_stream(rt.host, rt.port, lines)
            base_ok = sum(r.get("status") == "ok" for r in recs)
            base_p99 = p99(lats)
        finally:
            rt.close()
        require(base_ok == requests, f"healthy wave lost rows: {base_ok}")

        # the same wave with b1 square-waved down: the breaker opens,
        # placement routes around it, the canary re-admits it, and the
        # transition cooldown keeps the steal loop out of the incident
        rt = make_router(gws, inject="backend-flap:period=500:backend=b1",
                         breaker_cooldown_s=0.5,
                         steal_threshold_s=0.001, steal_cooldown_s=3.0,
                         flightrec_dir=str(workdir / "flightrec"))
        try:
            # the first tick stamps the flap's t0 -> the down edge
            require(wait_for(lambda: rt.registry.get("b1").fault_down, 30),
                    "the flap never took b1 down")
            lines = build_lines(requests, "flap", sink_ms, dtype)
            recs, lats = post_stream(rt.host, rt.port, lines)
            flap_ok = sum(r.get("status") == "ok" for r in recs)
            flap_p99 = p99(lats)
            snap = rt.snapshot()
        finally:
            rt.close()
        transitions = sum(b["transitions"]
                          for b in snap["router"]["breakers"].values())
        return {
            "requests": requests,
            "healthy_p99_s": round(base_p99, 3),
            "flap_p99_s": round(flap_p99, 3),
            "p99_ratio": round(flap_p99 / base_p99, 3),
            "availability": round(flap_ok / requests, 4),
            "breaker_transitions": transitions,
            "steals": len(snap["router"]["steals"]),
            "retries": snap["router"]["retries"],
            "bit_identical": check_bits(gws, lines, sample, device=device),
            "steals_suppressed": (len(snap["router"]["steals"]) == 0
                                  and transitions >= 1),
        }
    finally:
        close_all(None, gws)


def cut_drill(workdir: Path, requests: int, sink_ms: int,
              device: str = "cuda", dtype: str = "float64"):
    """Mid-stream relay break against a live backend: bounded re-drive
    delivers every admitted row exactly once."""
    gws = [make_backend(workdir, f"ct{i}", device) for i in range(2)]
    rt = make_router(gws, inject="stream-cut@3:backend=b0",
                     cut_redrive_wait_s=30.0)
    try:
        wait_probed(rt)
        lines = build_lines(requests, "cut", sink_ms, dtype)
        recs, _ = post_stream(rt.host, rt.port, lines)
        snap = rt.snapshot()
        ids = [r.get("id") for r in recs]
        return {
            "requests": requests,
            "records": len(recs),
            "ok": sum(r.get("status") == "ok" for r in recs),
            "stream_cuts": snap["router"]["stream_cuts"],
            "zero_lost": (sorted(ids) == sorted(ln["id"] for ln in lines)
                          and all(r.get("status") == "ok" for r in recs)),
            "zero_duplicates": (snap["router"]["duplicates"] == 0
                                and len(ids) == len(set(ids))),
        }
    finally:
        close_all(rt, gws)


def hedge_drill(workdir: Path, sink_ms: int, device: str = "cuda",
                dtype: str = "float64"):
    """Stale-predictor tail: the interactive row stalls on a pre-loaded
    backend and must win on the hedge instead."""
    gws = [make_backend(workdir, f"hg{i}", device) for i in range(2)]
    # round-robin's rotation starts at the second backend, so pre-load
    # it OUTSIDE the router (the stale-view setup hedging exists for)
    rt = make_router(gws, policy="round-robin",
                     health_interval_s=0.15,
                     hedge_factor=0.05, hedge_floor_s=0.4)
    try:
        wait_probed(rt)
        host, _, port = gws[1].address.rpartition(":")
        heavy = build_lines(5, "heavy", sink_ms=5 * sink_ms, dtype=dtype)
        body = "".join(json.dumps(ln) + "\n" for ln in heavy).encode()
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.request("POST", "/v1/solve?wait=0", body=body)
        require(conn.getresponse().status == 202, "the pre-load was refused")
        conn.close()

        tail = [{"id": "hedge-r0", "n": 24, "ntime": 48,
                 "dtype": dtype, "ic": "hat", "bc": "edges",
                 "nu": 0.05, "tenant": "acme", "class": "interactive"}]
        t0 = time.perf_counter()
        recs, _ = post_stream(rt.host, rt.port, tail)
        wall = time.perf_counter() - t0
        snap = rt.snapshot()
        rec = recs[-1]
        # the duplicate's bytes are the direct solve's bytes wherever the
        # twin landed (id suffix ``~hedge`` on the hedge backend)
        bit = (check_bits(gws, tail, [0], suffix="~hedge", device=device)
               or check_bits(gws, tail, [0], device=device))
        return {
            "stall_depth_s": round(5 * 5 * sink_ms / 1000.0, 2),
            "hedged_wall_s": round(wall, 3),
            "status": rec.get("status"),
            "hedged_record": bool(rec.get("hedged")),
            "fired": snap["router"]["hedges"]["fired"],
            "won": snap["router"]["hedges"]["won"],
            "cancelled": snap["router"]["hedges"]["cancelled"],
            "bit_identical": bool(bit and rec.get("status") == "ok"),
        }
    finally:
        close_all(rt, gws)


def deadline_drill(workdir: Path, expired: int, live: int,
                   device: str = "cuda", dtype: str = "float64"):
    """Spent budgets shed at the edge with zero dispatch + zero billing;
    live budgets propagate and complete."""
    gws = [make_backend(workdir, f"dl{i}", device) for i in range(2)]
    rt = make_router(gws)
    try:
        wait_probed(rt)
        lines = []
        for i in range(expired):
            lines.append({"id": f"dead-r{i}", "n": 24, "ntime": 48,
                          "dtype": dtype, "tenant": "doomed",
                          "deadline_ms": 0.001})
        for i in range(live):
            lines.append({"id": f"live-r{i}", "n": 24, "ntime": 48,
                          "dtype": dtype, "deadline_ms": 120000})
        recs, _ = post_stream(rt.host, rt.port, lines)
        by = {r["id"]: r for r in recs}
        shed = [r for r in by.values() if r.get("status") == "deadline"]
        served = [r for r in by.values() if r.get("status") == "ok"]
        snap = rt.snapshot()
        usage = rt.fleet_usage()
        return {
            "expired": expired, "live": live,
            "shed_records": len(shed),
            "served_records": len(served),
            "router_deadline_shed": snap["router"]["deadline_shed"],
            "doomed_tenant_billed": "doomed" in usage["tenants"],
            "shed_exact": (len(shed) == expired
                           and len(served) == live
                           and snap["router"]["deadline_shed"] == expired
                           and "doomed" not in usage["tenants"]
                           and all("zero device steps" in r["error"]
                                   for r in shed)),
        }
    finally:
        close_all(rt, gws)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=36,
                    help="wave size for the flap drill")
    ap.add_argument("--sink-ms", type=int, default=SINK_MS)
    ap.add_argument("--out", default=str(ARTIFACTS
                                         / "fleet_resilience_lab.json"))
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines serve (default cuda)")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32", "bfloat16"],
                    help="the requests' dtype (default float64; float32 "
                         "or bfloat16 serve on the lane kernels)")
    ap.add_argument("--gates", choices=["all", "bytes"], default="all",
                    help="'bytes' gates only the exact outcomes and prints "
                         "the timing gates (default all)")
    args = ap.parse_args(argv)

    import tempfile

    tmp = None
    if args.workdir:
        workdir = Path(args.workdir)
        workdir.mkdir(parents=True, exist_ok=True)
    else:
        tmp = tempfile.TemporaryDirectory(
            prefix="heat-tpu-torch-fleet-resilience-")
        workdir = Path(tmp.name)

    try:
        print("fleet_resilience_lab: flap drill", flush=True)
        flap = flap_drill(workdir, args.requests, args.sink_ms, args.device,
                          args.dtype)
        print(f"fleet_resilience_lab: flap {flap}", flush=True)
        print("fleet_resilience_lab: stream-cut drill", flush=True)
        cut = cut_drill(workdir, 24, args.sink_ms // 2, args.device,
                        args.dtype)
        print(f"fleet_resilience_lab: cut {cut}", flush=True)
        print("fleet_resilience_lab: hedge drill", flush=True)
        hedge = hedge_drill(workdir, args.sink_ms, args.device, args.dtype)
        print(f"fleet_resilience_lab: hedge {hedge}", flush=True)
        print("fleet_resilience_lab: deadline drill", flush=True)
        deadline = deadline_drill(workdir, expired=8, live=8,
                                  device=args.device, dtype=args.dtype)
        print(f"fleet_resilience_lab: deadline {deadline}", flush=True)
    finally:
        if tmp is not None:
            tmp.cleanup()

    rec = {
        "bench": "fleet_resilience_lab",
        **stamp(args.device),
        "config": {"requests": args.requests, "sink_ms": args.sink_ms,
                   "device": args.device, "dtype": args.dtype,
                   "gates": args.gates,
                   "backend": "in-process Engine+Gateway, lanes 2, "
                              "chunk 8, buckets (32,)",
                   "policy": "least-loaded (flap/cut/deadline), "
                             "round-robin (hedge)"},
        "flap_drill": flap,
        "cut_drill": cut,
        "hedge_drill": hedge,
        "deadline_drill": deadline,
        # the gate fields
        "flap_availability": flap["availability"],
        "flap_p99_ratio": flap["p99_ratio"],
        "flap_bit_identical": bool(flap["bit_identical"]),
        "cut_zero_lost": bool(cut["zero_lost"]),
        "cut_zero_duplicates": bool(cut["zero_duplicates"]),
        "hedges_won": hedge["won"],
        "hedge_bit_identical": bool(hedge["bit_identical"]),
        "deadline_shed_exact": bool(deadline["shed_exact"]),
        "breaker_steals_suppressed": bool(flap["steals_suppressed"]),
    }
    from ..runtime.debug import guard_report

    guard = guard_report()
    if guard is not None:
        rec["invariant_guard"] = guard
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    exact = (rec["flap_availability"] >= (1.0 if args.gates == "bytes"
                                           else 0.99)
             and rec["flap_bit_identical"]
             and rec["cut_zero_lost"]
             and rec["cut_zero_duplicates"]
             and hedge["status"] == "ok"
             and rec["hedge_bit_identical"]
             and rec["deadline_shed_exact"])
    timing = (rec["flap_p99_ratio"] <= 1.5
              and rec["hedges_won"] >= 1
              and rec["breaker_steals_suppressed"])
    clean = guard is None or not (guard["lock_order_violations"]
                                  or guard["races_detected"])
    passed = exact and clean and (timing or args.gates == "bytes")
    if guard is not None:
        print(f"fleet_resilience_lab: invariant guard (armed) — "
              f"{guard['lock_order_violations']} lock-order violation(s) "
              f"over {guard['lock_order_edges']} edge(s), "
              f"{guard['races_detected']} race(s) on "
              f"{guard['race_instrumented']} instrumented object(s)")
    print(f"fleet_resilience_lab: {'OK' if passed else 'FAILED'} — flap "
          f"availability {rec['flap_availability']} p99x"
          f"{rec['flap_p99_ratio']} (gates >= 0.99, <= 1.5); cut "
          f"lost=0:{rec['cut_zero_lost']} dup=0:"
          f"{rec['cut_zero_duplicates']}; hedge won {rec['hedges_won']} "
          f"bits:{rec['hedge_bit_identical']}; deadline exact:"
          f"{rec['deadline_shed_exact']}; steal thrash suppressed:"
          f"{rec['breaker_steals_suppressed']}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
