"""Observatory-overhead A/B: the cost observatory must observe, not perturb
(the port of the JAX package's prof overhead lab).

The serve lab's wave through one engine configuration, twice, differing
only in ``ServeConfig.prof`` (``runtime/prof.py``):

- ``off``: no cost model, no usage aggregation, no memory sampling, no
  burn windows (records keep their usage stamps);
- ``on``: the whole observatory, memory sampled every 8 boundaries, and
  requests carrying tenants, SLO classes and deadlines so every
  instrument runs.

Gates: ``on`` within 2% of ``off`` (best of ``--repeats`` walls, modes
round-robined inside each repeat, after one warm-up wave); npz files
byte-identical on against off at dispatch depths 0 and 2; the usage
ledger's totals equal the sum of the records' usage stamps. The record
carries the ``on`` engine's cost-model rows, which ``python -m
heat_tpu_torch perfcheck`` reads.

    python -m heat_tpu_torch.labs.prof_overhead_lab [--repeats 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_requests, drain, init_device,
                    stamp, work, write_atomic)

TENANTS = ("acme", "zeta", "free-tier")
CLASSES = ("interactive", "standard", "batch")


def submit_slo(eng, i, cfg):
    """The population dressed with SLO fields: round-robin tenants and
    classes, a generous deadline on every request."""
    return eng.submit(cfg, tenant=TENANTS[i % len(TENANTS)],
                      slo_class=CLASSES[i % len(CLASSES)],
                      deadline_ms=120_000.0)


def run_mode(reqs, lanes, chunk, depth, device, prof, out_dir=None):
    from ..serve import Engine, ServeConfig

    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             dispatch_depth=depth, emit_records=False,
                             prof=prof, mem_poll_every=8,
                             out_dir=str(out_dir) if out_dir else None),
                 device=device)
    wall, records = drain(eng, reqs, submit=submit_slo)
    ok = sum(r["status"] == "ok" for r in records)
    return wall, ok, eng, records


def reconcile(eng, records) -> bool:
    """The ledger's totals against the sum of the records' usage stamps:
    integers exactly, lane-seconds to 1e-6."""
    totals = eng.prof.ledger.snapshot()["totals"]
    stamps = [r["usage"] for r in records]
    ints_ok = all(totals[f] == sum(int(u[f]) for u in stamps)
                  for f in ("steps", "chunks", "bytes_written"))
    lane_ok = abs(totals["lane_s"]
                  - sum(float(u["lane_s"]) for u in stamps)) < 1e-6
    return ints_ok and lane_ok and totals["requests"] == len(stamps)


def bit_identity(reqs, lanes, chunk, depth, device, tmp) -> bool:
    """npz files byte-identical with the observatory on and off."""
    dirs = {}
    for prof in (False, True):
        d = Path(tmp) / f"d{depth}_{'on' if prof else 'off'}"
        _, ok, _, recs = run_mode(reqs, lanes, chunk, depth, device, prof,
                                  out_dir=d)
        if ok != len(reqs):
            return False
        dirs[prof] = (d, recs)
    d_off, recs_off = dirs[False]
    d_on, _ = dirs[True]
    return all((d_off / f"{r['id']}.npz").read_bytes()
               == (d_on / f"{r['id']}.npz").read_bytes() for r in recs_off)


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
    ap.add_argument("--out", default=str(ARTIFACTS / "prof_overhead_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device)
    reqs = build_requests(args.requests)
    cells = work(reqs)

    run_mode(reqs, args.lanes, args.chunk, args.depth, device, prof=False)
    modes = {}
    keep = {}
    for _ in range(args.repeats):
        for name, prof in (("off", False), ("on", True)):
            wall, ok, eng, records = run_mode(reqs, args.lanes, args.chunk,
                                              args.depth, device, prof)
            m = modes.setdefault(name, {"walls": [], "ok": ok})
            m["walls"].append(round(wall, 3))
            m["ok"] = min(m["ok"], ok)
            keep[name] = (eng, records)
    for m in modes.values():
        m["wall_s"] = min(m["walls"])
        m["points_per_s"] = round(cells / m["wall_s"], 1)

    on_eng, on_records = keep["on"]
    off_eng, _ = keep["off"]
    overhead = modes["on"]["wall_s"] / modes["off"]["wall_s"] - 1.0
    reconciles = reconcile(on_eng, on_records)
    bit_reqs = build_requests(args.bit_requests)
    with tempfile.TemporaryDirectory(prefix="prof_lab_") as tmp:
        bit0 = bit_identity(bit_reqs, args.lanes, args.chunk, 0, device, tmp)
        bit2 = bit_identity(bit_reqs, args.lanes, args.chunk, 2, device, tmp)

    on_summary = on_eng.summary()
    cost_model = on_summary["cost_model"]
    mem = on_summary["mem"]
    rec = {
        "bench": "prof_overhead_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "dispatch_depth": args.depth,
                   "repeats": args.repeats, "buckets": list(BUCKETS),
                   "dtype": "float64", "mem_poll_every": 8,
                   "bit_requests": args.bit_requests},
        "work_cell_steps": cells,
        "off": modes["off"], "on": modes["on"],
        "on_overhead_frac": round(overhead, 4),
        "on_within_2pct_of_off": overhead <= 0.02,
        "bit_identical_depth0": bit0,
        "bit_identical_depth2": bit2,
        "usage_reconciles": reconciles,
        # the "on" engine's learned state, for perfcheck's cross-checks
        "cost_model": cost_model,
        "mem": mem,
        "slo_burn": on_summary["slo_burn"],
        "usage_totals": on_eng.prof.ledger.snapshot()["totals"],
        "cost_model_off_empty": not off_eng.summary()["cost_model"],
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (rec["on_within_2pct_of_off"] and bit0 and bit2
              and reconciles and rec["cost_model_off_empty"]
              and all(m["ok"] == args.requests for m in modes.values())
              and len(cost_model) > 0 and mem["samples"] > 0)
    print(f"prof_overhead_lab: {'OK' if passed else 'FAILED'} — "
          f"off {modes['off']['wall_s']:.3f}s vs full observatory "
          f"{modes['on']['wall_s']:.3f}s ({100 * overhead:+.2f}%; gate "
          f"<= +2%); bit-identical npz depth0={bit0} depth2={bit2}; "
          f"usage reconciles={reconciles}; {len(cost_model)} cost-model "
          f"key(s), {mem['samples']} mem sample(s) on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
