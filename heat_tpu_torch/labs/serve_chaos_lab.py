"""Serving-engine chaos A/B: per-lane fault domains under poisoned load (the
port of the JAX package's serve chaos lab).

One wave of the serve lab's population runs twice through the
dispatch-ahead engine:

- **clean**: every request well posed;
- **chaos**: the same wave with every tenth request poisoned by the
  per-request ``lane-nan@40`` injection: each poisoned lane must fail with
  a ``nonfinite`` record at its next chunk boundary while the lanes beside
  it keep stepping.

Gates: the healthy requests' aggregate throughput in the chaos run within
10% of the clean run (healthy cell-steps over the chaos wall, against the
clean rate scaled to the healthy share), a sample of healthy results
bit-identical between the runs, and every poisoned request quarantined.

    python -m heat_tpu_torch.labs.serve_chaos_lab [--requests 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_requests, counts, drain,
                    init_device, stamp, work, write_atomic)

# every POISON_EVERY-th request is poisoned at step 40: inside every
# request's 96..128 steps, past a few chunk boundaries
POISON_EVERY = 10
POISON_STEP = 40


def build_waves(count: int):
    clean = build_requests(count)
    poisoned = [i for i in range(count)
                if i % POISON_EVERY == POISON_EVERY - 1]
    chaos = [cfg.with_(inject=f"lane-nan@{POISON_STEP}")
             if i in poisoned else cfg for i, cfg in enumerate(clean)]
    return clean, chaos, poisoned


def run_wave(reqs, lanes: int, chunk: int, depth: int, device):
    from ..runtime import faults
    from ..serve import Engine, ServeConfig

    faults.reset()  # per-spec firing state must not leak between waves
    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             dispatch_depth=depth, emit_records=False),
                 device=device)
    wall, records = drain(eng, reqs)
    return wall, eng, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--out", default=str(ARTIFACTS / "serve_chaos_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device)
    clean_reqs, chaos_reqs, poisoned = build_waves(args.requests)
    healthy = [i for i in range(args.requests) if i not in set(poisoned)]
    healthy_work = work(clean_reqs[i] for i in healthy)
    total_work = work(clean_reqs)

    clean_wall, _, clean_recs = run_wave(clean_reqs, args.lanes, args.chunk,
                                         args.depth, device)
    chaos_wall, chaos_eng, chaos_recs = run_wave(
        chaos_reqs, args.lanes, args.chunk, args.depth, device)

    clean_tput = total_work / clean_wall
    chaos_tput = healthy_work / chaos_wall
    ratio = chaos_tput / (clean_tput * healthy_work / total_work)

    sample = sorted({healthy[0], healthy[len(healthy) // 2], healthy[-1]})
    bit_identical = all(
        np.array_equal(chaos_recs[i]["T"], clean_recs[i]["T"])
        for i in sample)
    quarantined_ok = all(chaos_recs[i]["status"] == "nonfinite"
                         for i in poisoned)
    healthy_ok = all(chaos_recs[i]["status"] == "ok" for i in healthy)

    s = chaos_eng.summary()
    rec = {
        "bench": "serve_chaos_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "dispatch_depth": args.depth,
                   "poisoned": len(poisoned),
                   "poison_spec": f"lane-nan@{POISON_STEP}"},
        "clean": {"wall_s": round(clean_wall, 3),
                  "points_per_s": round(clean_tput, 1),
                  **counts(clean_recs)},
        "chaos": {
            "wall_s": round(chaos_wall, 3),
            "healthy_points_per_s": round(chaos_tput, 1),
            **counts(chaos_recs),
            "nonfinite": sum(r["status"] == "nonfinite" for r in chaos_recs),
            "lanes_quarantined": s["lanes_quarantined"],
            "rollbacks": s["rollbacks"],
            "watchdog_fired": s["watchdog_fired"],
        },
        "healthy_throughput_ratio": round(ratio, 4),
        "healthy_within_10pct": ratio >= 0.9,
        "bit_identical_healthy_sample": bit_identical,
        "all_poisoned_quarantined": quarantined_ok,
        "all_healthy_ok": healthy_ok,
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (rec["healthy_within_10pct"] and bit_identical
              and quarantined_ok and healthy_ok
              and s["lanes_quarantined"] == len(poisoned))
    print(f"serve_chaos_lab: {'OK' if passed else 'FAILED'} — healthy "
          f"throughput under {len(poisoned)}/{args.requests} poisoned "
          f"load at {100 * ratio:.1f}% of clean "
          f"({rec['chaos']['healthy_points_per_s']:.4g} vs "
          f"{rec['clean']['points_per_s']:.4g} pts/s scaled); "
          f"{s['lanes_quarantined']} quarantined; bit-identical healthy "
          f"sample={bit_identical} on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
