"""Serving-engine throughput A/B: dispatch-ahead against synchronous against
sequential solo solves (the port of the JAX package's serve lab).

Two claims, one harness:

- **Serving**: draining the 64 small mixed-size requests through the
  batched engine beats running them one ``backends.solve`` after another
  (the solo ``run`` shape) by a wide aggregate margin (gate: 3x).
- **Dispatch-ahead**: the pipelined engine (``dispatch_depth=2``) against
  the synchronous one (``dispatch_depth=0``) on the same wave, with the
  boundary-wait wall and the estimated device-idle time.

Aggregate throughput is the requests' cell-steps (sum of n^ndim * ntime)
over each side's wall. The device's context is made before the first wall
(``setup_s``), so neither side pays it. A sample of each engine's results
must be bit-identical to the solo solves.

The port compiles nothing per bucket (the lane kernels are built once per
checkout), so ``step_compiles`` is 0 and
``one_compile_per_bucket_lane_tier`` holds by design. The population is
f64, which on the card runs the plain lane body, not a kernel; a solo
solve there pays its launch set-up, not a compile.

    python -m heat_tpu_torch.labs.serve_lab [--requests 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_oversized, build_requests,
                    counts, drain, init_device, stamp, work, write_atomic)


def run_engine(reqs, lanes: int, chunk: int, depth: int, device,
               oversized=()):
    from ..serve import Engine, ServeConfig

    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             dispatch_depth=depth, emit_records=False),
                 device=device)
    wall, records = drain(eng, list(reqs) + list(oversized))
    return wall, eng, records


def run_sequential(reqs, device):
    """One solo solve per request, in order: what N separate ``run``
    invocations in one process would do."""
    import time

    from ..backends import solve

    t0 = time.perf_counter()
    fields = [solve(cfg, device=device).T for cfg in reqs]
    return time.perf_counter() - t0, fields


def _engine_block(cells, wall, eng, records, sample, seq_fields):
    import numpy as np

    bit_identical = all(
        np.array_equal(records[i]["T"], seq_fields[i]) for i in sample)
    s = eng.summary()
    return {
        "wall_s": round(wall, 3),
        "points_per_s": round(cells / wall, 1),
        **counts(records),
        "step_compiles": s["step_compiles"],
        "tail_compiles": s["tail_compiles"],
        "compile_s": s["compile_s"],
        "dispatch_depth": s["dispatch_depth"],
        "chunks_dispatched": s["chunks_dispatched"],
        "tail_chunks": s["tail_chunks"],
        "boundary_waits": s["boundary_waits"],
        "boundary_wait_s": s["boundary_wait_s"],
        "device_idle_s_est": s["device_idle_s"],
        "device_idle_frac_est": round(s["device_idle_s"] / wall, 4),
        "bit_identical_sample": bit_identical,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2,
                    help="dispatch depth for the pipelined side of the A/B")
    ap.add_argument("--out", default=str(ARTIFACTS / "serve_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines and solves run (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device
    from ..serve.scheduler import mega_device_count

    device = resolve_device(args.device)
    setup_s = init_device(device)
    reqs = build_requests(args.requests)
    # two permanently oversized requests: rejected with the --mega-lanes
    # hint on one device, served as mega-lanes on several
    big = build_oversized()
    cells = work(reqs)
    sample = sorted({0, len(reqs) // 2, len(reqs) - 1})

    seq_wall, seq_fields = run_sequential(reqs, device)
    # the synchronous engine first, so the pipelined one cannot inherit a
    # warmer process
    off_wall, off_eng, off_recs = run_engine(reqs, args.lanes, args.chunk,
                                             0, device, oversized=big)
    eng_wall, eng, records = run_engine(reqs, args.lanes, args.chunk,
                                        args.depth, device, oversized=big)

    engine_on = _engine_block(cells, eng_wall, eng, records, sample,
                              seq_fields)
    engine_off = _engine_block(cells, off_wall, off_eng, off_recs, sample,
                               seq_fields)
    ndev = mega_device_count(device)
    mega_capable = eng.mega_lanes > 0
    big_on = records[args.requests:]
    big_off = off_recs[args.requests:]
    combos = {(r["bucket"],) for r in records if r["bucket"] is not None}
    speedup = seq_wall / eng_wall if eng_wall > 0 else None
    ab = off_wall / eng_wall if eng_wall > 0 else None
    rec = {
        "bench": "serve_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "dispatch_depth": args.depth,
                   "buckets": list(BUCKETS), "sides": [24, 32, 48],
                   "ntimes": [96, 112, 128], "dtype": "float64",
                   "oversized_sides": [c.n for c in big],
                   "devices": ndev},
        "oversized": {
            "count": len(big),
            "expected": "mega" if mega_capable else "rejected",
            "statuses": sorted(r["status"] for r in big_on + big_off),
            "hint_present": all("hint" in r for r in big_on + big_off
                                if r["status"] == "rejected"),
        },
        "work_cell_steps": cells,
        "sequential": {"wall_s": round(seq_wall, 3),
                       "points_per_s": round(cells / seq_wall, 1)},
        "engine": engine_on,
        "engine_sync": engine_off,
        "aggregate_speedup": round(speedup, 2) if speedup else None,
        "dispatch_ab_speedup": round(ab, 2) if ab else None,
        "one_compile_per_bucket_lane_tier":
            engine_on["step_compiles"] <= len(combos)
            and engine_on["tail_compiles"] <= len(combos),
        "bit_identical_sample": (engine_on["bit_identical_sample"]
                                 and engine_off["bit_identical_sample"]),
        "notes": "the port compiles nothing per bucket (the lane kernels "
                 "are built once per checkout): step_compiles is 0 and "
                 "one_compile_per_bucket_lane_tier holds by design; the "
                 "sequential side pays each solve's launch set-up, not a "
                 "compile",
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    exp_ok = args.requests + (len(big) if mega_capable else 0)
    exp_rej = 0 if mega_capable else len(big)
    big_ok = (all(r["status"] == "ok" for r in big_on + big_off)
              if mega_capable else
              all(r["status"] == "rejected" and "hint" in r
                  for r in big_on + big_off))
    passed = (engine_on["ok"] == exp_ok
              and engine_off["ok"] == exp_ok
              and engine_on["rejected"] == engine_off["rejected"] == exp_rej
              and engine_on["failed"] == engine_off["failed"] == 0
              and big_ok
              and rec["bit_identical_sample"]
              and speedup is not None and speedup >= 3.0
              and ab is not None
              and rec["one_compile_per_bucket_lane_tier"])
    print(f"serve_lab: {'OK' if passed else 'FAILED'} — dispatch-ahead "
          f"{engine_on['points_per_s']:.3g} pts/s vs sync "
          f"{engine_off['points_per_s']:.3g} ({rec['dispatch_ab_speedup']}x "
          f"A/B) vs sequential {rec['sequential']['points_per_s']:.3g} "
          f"({rec['aggregate_speedup']}x aggregate; boundary wait "
          f"{engine_on['boundary_wait_s']:.3f}s vs "
          f"{engine_off['boundary_wait_s']:.3f}s sync; bit-identical "
          f"sample={rec['bit_identical_sample']}) on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
