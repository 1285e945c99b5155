"""Serving front-end A/B: online Poisson arrivals, EDF against FIFO, and the
offline drain against the committed serve lab record (the port of the JAX
package's serve frontend lab).

- **Deadlines shape admission**: one seeded open-loop Poisson arrival
  schedule (a burst at about 3x the measured service rate, so a backlog
  forms) is fed to a running online engine twice, ``policy="fifo"`` and
  ``policy="edf"``. A quarter of the requests are interactive with a tight
  deadline, a quarter standard with a looser one, half batch and undated.
  Gate: EDF's deadline-hit rate at least FIFO's.
- **The policy layer costs the drain nothing**: the same population
  drained offline (best of 3) within 5% of the committed
  ``artifacts/serve_lab.json`` engine rate, where that record was made on
  the same platform with the same population size.

Arrival instants are fixed up front from the seed, independent of
completions. The online engine starts at lane tier 1 and grows as the
burst builds.

    python -m heat_tpu_torch.labs.serve_frontend_lab [--requests 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_requests, drain, init_device,
                    stamp, work, write_atomic)

BASELINE = ARTIFACTS / "serve_lab.json"


def classify(i: int, drain_s: float):
    """Deterministic SLO classes: i % 4 == 0 interactive (1.2 offline
    drain walls), i % 4 == 2 standard (2.0 walls), else batch (undated)."""
    if i % 4 == 0:
        return "interactive", 1.2 * drain_s * 1e3
    if i % 4 == 2:
        return "standard", 2.0 * drain_s * 1e3
    return "batch", None


def run_offline(reqs, lanes, chunk, device):
    from ..serve import Engine, ServeConfig

    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             emit_records=False), device=device)
    wall, records = drain(eng, reqs)
    return wall, sum(r["status"] == "ok" for r in records)


def run_online(schedule, policy, lanes, chunk, drain_s, device):
    """Feed the arrival schedule into a running engine under one policy."""
    from ..serve import Engine, ServeConfig

    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             emit_records=False, policy=policy),
                 device=device).start()
    ids, dated = [], []
    t0 = time.perf_counter()
    for arrival, i, cfg in schedule:
        delay = arrival - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        cls, deadline_ms = classify(i, drain_s)
        rid = eng.submit(cfg, request_id=f"{policy}-{i:03d}",
                         deadline_ms=deadline_ms, slo_class=cls,
                         tenant="lab")
        ids.append(rid)
        if deadline_ms is not None:
            dated.append(rid)
    recs = {}
    for rid in ids:
        recs[rid] = eng.wait(rid, timeout=600)
        if recs[rid] is None:
            raise RuntimeError(f"timed out waiting for {rid}")
    wall = time.perf_counter() - t0
    eng.shutdown(timeout=600)
    statuses = {}
    for r in recs.values():
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    hits = sum(recs[rid]["status"] == "ok" for rid in dated)
    quantiles = {
        cls: {q: h.quantile(p) for q, p in
              (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))}
        for cls, h in sorted(eng.lat_hist.items())}
    return {
        "policy": policy,
        "wall_s": round(wall, 3),
        "statuses": statuses,
        "deadline_carrying": len(dated),
        "deadline_hits": hits,
        "deadline_hit_rate": round(hits / len(dated), 4) if dated else None,
        "deadline_misses": eng.deadline_misses,
        "lane_grows": eng.lane_grows,
        "latency_quantiles_s": quantiles,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=20260804)
    ap.add_argument("--out", default=str(ARTIFACTS / "serve_frontend_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device)
    reqs = build_requests(args.requests)
    cells = work(reqs)

    offline = [run_offline(reqs, args.lanes, args.chunk, device)
               for _ in range(3)]
    off_wall = min(w for w, _ in offline)
    off_ok = offline[0][1]
    off_pps = cells / off_wall

    baseline_pps = baseline_ratio = None
    if BASELINE.exists() and args.requests == 64:
        base = json.loads(BASELINE.read_text())
        if base.get("platform") == device.type:
            baseline_pps = base["engine"]["points_per_s"]
            baseline_ratio = round(off_pps / baseline_pps, 4)

    # the seeded open-loop burst at about 3x the measured service rate:
    # the same arrival instants for both policies
    rng = random.Random(args.seed)
    rate = 3.0 * args.requests / max(off_wall, 1e-3)
    t = 0.0
    schedule = []
    for i, cfg in enumerate(reqs):
        schedule.append((t, i, cfg))
        t += rng.expovariate(rate)
    fifo = run_online(schedule, "fifo", args.lanes, args.chunk, off_wall,
                      device)
    edf = run_online(schedule, "edf", args.lanes, args.chunk, off_wall,
                     device)

    rec = {
        "bench": "serve_frontend_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "buckets": list(BUCKETS),
                   "seed": args.seed,
                   "arrival_rate_req_per_s": round(rate, 1),
                   "deadline_policy": "interactive 1.2x / standard 2.0x "
                                      "of the offline drain wall; batch "
                                      "undated"},
        "work_cell_steps": cells,
        "offline_drain": {
            "wall_s": round(off_wall, 3),
            "points_per_s": round(off_pps, 1),
            "ok": off_ok,
            "baseline_points_per_s": baseline_pps,
            "vs_serve_lab_engine": baseline_ratio,
        },
        "online_fifo": fifo,
        "online_edf": edf,
        "edf_vs_fifo_hit_rate_delta": (
            round(edf["deadline_hit_rate"] - fifo["deadline_hit_rate"], 4)
            if edf["deadline_hit_rate"] is not None else None),
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (off_ok == args.requests
              and edf["deadline_hit_rate"] is not None
              and edf["deadline_hit_rate"] >= fifo["deadline_hit_rate"]
              and (baseline_ratio is None or baseline_ratio >= 0.95))
    print(f"serve_frontend_lab: {'OK' if passed else 'FAILED'} — offline "
          f"drain {off_pps:.3g} pts/s"
          + (f" ({100 * baseline_ratio:.1f}% of serve_lab engine)"
             if baseline_ratio is not None else "")
          + f"; deadline hit rate EDF {edf['deadline_hit_rate']} vs FIFO "
            f"{fifo['deadline_hit_rate']} "
            f"(+{rec['edf_vs_fifo_hit_rate_delta']}); lane grows "
            f"fifo={fifo['lane_grows']} edf={edf['lane_grows']} on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
