"""Numerics-observatory overhead A/B: solution-quality telemetry must ride
for free (the port of the JAX package's numerics overhead lab).

Every chunk fuses the four per-lane stats (residual, min, max, heat) into
the boundary vector it already writes; ``--numerics`` gates only their
ingestion on the host, so toggling it changes no launch, no transfer and
no output byte. Gates, on the serve lab's population:

- **on within 2% of off** (best of ``--repeats`` walls, modes round-robined
  inside each repeat, after one warm-up wave);
- **bit-identity**: npz files byte-identical on against off at dispatch
  depths 0 and 2;
- **probe verification**: one canary through a live Gateway
  (``serve/probe.Prober.run_once``: POST /v1/solve, GET the field) within
  tolerance of the closed-form sine-eigenmode decay;
- **the detector fires**: a seeded ``perturb`` fault trips exactly one
  maximum-principle violation.

    python -m heat_tpu_torch.labs.numerics_overhead_lab [--repeats 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_requests, drain, init_device,
                    stamp, work, write_atomic)


def run_mode(reqs, lanes, chunk, depth, device, numerics, out_dir=None):
    from ..serve import Engine, ServeConfig

    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             dispatch_depth=depth, emit_records=False,
                             numerics=numerics,
                             out_dir=str(out_dir) if out_dir else None),
                 device=device)
    wall, records = drain(eng, reqs)
    ok = sum(r["status"] == "ok" for r in records)
    return wall, ok, eng, records


def bit_identity(reqs, lanes, chunk, depth, device, tmp) -> bool:
    """npz files byte-identical with the observatory on and off."""
    dirs = {}
    for numerics in (False, True):
        d = Path(tmp) / f"d{depth}_{'on' if numerics else 'off'}"
        _, ok, _, recs = run_mode(reqs, lanes, chunk, depth, device,
                                  numerics, out_dir=d)
        if ok != len(reqs):
            return False
        dirs[numerics] = (d, recs)
    d_off, recs_off = dirs[False]
    d_on, _ = dirs[True]
    return all((d_off / f"{r['id']}.npz").read_bytes()
               == (d_on / f"{r['id']}.npz").read_bytes() for r in recs_off)


def probe_verification(device) -> dict:
    """One canary: a Gateway on a localhost socket, ``Prober.run_once``
    over HTTP, the verdict against the closed-form decay."""
    from ..serve import Engine, ServeConfig
    from ..serve.gateway import Gateway
    from ..serve.probe import Prober

    eng = Engine(ServeConfig(lanes=2, chunk=16, buckets=(64,),
                             emit_records=False, keep_fields=True),
                 device=device)
    gw = Gateway(eng, "127.0.0.1", 0, start_engine=True).start()
    try:
        verdict = Prober(f"http://{gw.address}",
                         interval_s=3600.0).run_once()
    finally:
        gw.request_drain()
        gw.wait_drained(120)
        gw.close()
    return verdict


def detector_fires(device) -> bool:
    """A seeded finite perturbation trips exactly one maximum-principle
    violation (guard ``warn``: observed, not guarded)."""
    from ..config import HeatConfig
    from ..runtime import faults
    from ..serve import Engine, ServeConfig

    faults.reset()
    try:
        eng = Engine(ServeConfig(lanes=1, chunk=8, buckets=(32,),
                                 emit_records=False, keep_fields=True,
                                 inject="perturb@16:eps=100"), device=device)
        eng.submit(HeatConfig(n=24, ntime=64, dtype="float32"))
        recs = eng.results()
        snap = eng.numerics.snapshot()
        return (len(recs) == 1 and recs[0]["status"] == "ok"
                and snap["violation_total"] == 1)
    finally:
        faults.reset()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--bit-requests", type=int, default=12,
                    help="population of the per-depth npz bit-identity "
                         "check (four result sets)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs per mode; the best wall is compared")
    ap.add_argument("--out", default=str(ARTIFACTS
                                         / "numerics_overhead_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device)
    reqs = build_requests(args.requests)
    cells = work(reqs)

    run_mode(reqs, args.lanes, args.chunk, args.depth, device, False)
    modes = {}
    keep = {}
    for _ in range(args.repeats):
        for name, numerics in (("off", False), ("on", True)):
            wall, ok, eng, _ = run_mode(reqs, args.lanes, args.chunk,
                                        args.depth, device, numerics)
            m = modes.setdefault(name, {"walls": [], "ok": ok})
            m["walls"].append(round(wall, 3))
            m["ok"] = min(m["ok"], ok)
            keep[name] = eng
    for m in modes.values():
        m["wall_s"] = min(m["walls"])
        m["points_per_s"] = round(cells / m["wall_s"], 1)

    overhead = modes["on"]["wall_s"] / modes["off"]["wall_s"] - 1.0
    bit_reqs = build_requests(args.bit_requests)
    with tempfile.TemporaryDirectory(prefix="numerics_lab_") as tmp:
        bit0 = bit_identity(bit_reqs, args.lanes, args.chunk, 0, device, tmp)
        bit2 = bit_identity(bit_reqs, args.lanes, args.chunk, 2, device, tmp)
    probe = probe_verification(device)
    fires = detector_fires(device)
    on_snap = keep["on"].numerics.snapshot()

    rec = {
        "bench": "numerics_overhead_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "dispatch_depth": args.depth,
                   "repeats": args.repeats, "buckets": list(BUCKETS),
                   "dtype": "float64", "bit_requests": args.bit_requests},
        "work_cell_steps": cells,
        "off": modes["off"], "on": modes["on"],
        "on_overhead_frac": round(overhead, 4),
        "on_within_2pct_of_off": overhead <= 0.02,
        "bit_identical_depth0": bit0,
        "bit_identical_depth2": bit2,
        "probe_verification_ok": bool(probe["ok"]),
        "probe_error_norm": probe["error_norm"],
        "probe_latency_s": (None if probe["latency_s"] is None
                            else round(probe["latency_s"], 3)),
        "detector_fires_on_seeded_perturb": fires,
        # the "on" engine's observatory at the end of its drain
        "on_steady_total": on_snap["steady_total"],
        "on_violation_total": on_snap["violation_total"],
        "on_lanes_retired": not on_snap["lanes"],
        "off_observatory_absent": keep["off"].numerics is None,
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (rec["on_within_2pct_of_off"] and bit0 and bit2
              and rec["probe_verification_ok"] and fires
              and rec["on_violation_total"] == 0
              and rec["on_lanes_retired"]
              and rec["off_observatory_absent"]
              and all(m["ok"] == args.requests for m in modes.values()))
    print(f"numerics_overhead_lab: {'OK' if passed else 'FAILED'} — "
          f"off {modes['off']['wall_s']:.3f}s vs observatory on "
          f"{modes['on']['wall_s']:.3f}s ({100 * overhead:+.2f}%; gate "
          f"<= +2%); bit-identical npz depth0={bit0} depth2={bit2}; "
          f"probe ok={rec['probe_verification_ok']} "
          f"(err {probe['error_norm']}); perturb detector fires={fires} "
          f"on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
