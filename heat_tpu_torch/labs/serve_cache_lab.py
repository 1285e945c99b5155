"""Solve-cache A/B: content-addressed result reuse under repeat load (the port
of the JAX package's serve cache lab).

One wave of ``--requests`` requests over ``--distinct`` distinct configs
runs twice through the dispatch-ahead engine, sharing one cache directory:

- **cold**: an empty cache, every distinct config computed (repeats
  inside the wave may hit entries published mid-drain);
- **warm**: a fresh engine over the same wave and the filled cache: every
  request a full hit, no chunk dispatched, no step billed.

Gates: the warm wave at least 5x faster than the cold one; every warm npz
byte-identical to its cold twin; a request a third deeper than a cached
entry steps exactly the difference (``usage.steps == ntime - cached``,
the prefix credited as ``steps_saved``) and ends bit-identical to a cold
solve; ``cache=False`` gives the cold cached run's bytes.

    python -m heat_tpu_torch.labs.serve_cache_lab [--requests 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, drain, init_device, stamp,
                    write_atomic)


def build_wave(count: int, distinct: int):
    from ..config import HeatConfig

    sizes = (24, 32, 48)
    cfgs = [HeatConfig(n=sizes[k % len(sizes)], ntime=96 + 16 * (k % 2),
                       dtype="float64", ic=("hat", "sine")[k % 2],
                       bc="edges", nu=0.05 + 0.01 * k)
            for k in range(distinct)]
    return [cfgs[i % distinct] for i in range(count)]


def run_wave(reqs, out_dir: Path, cache_dir: Path, lanes: int, chunk: int,
             depth: int, device, cache: bool = True):
    from ..serve import Engine, ServeConfig

    out_dir.mkdir(parents=True, exist_ok=True)
    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             dispatch_depth=depth, emit_records=False,
                             out_dir=str(out_dir), cache=cache,
                             cache_dir=str(cache_dir)), device=device)
    wall, records = drain(eng, reqs)
    return wall, eng, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--distinct", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--out", default=str(ARTIFACTS / "serve_cache_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..backends import resolve_device
    from ..serve import Engine, ServeConfig

    device = resolve_device(args.device)
    setup_s = init_device(device)
    reqs = build_wave(args.requests, args.distinct)
    root = Path(tempfile.mkdtemp(prefix="serve_cache_lab_"))
    cache_dir = root / "solve-cache"
    conf = (args.lanes, args.chunk, args.depth, device)
    try:
        cold_wall, cold_eng, cold_recs = run_wave(
            reqs, root / "cold", cache_dir, *conf)
        warm_wall, warm_eng, warm_recs = run_wave(
            reqs, root / "warm", cache_dir, *conf)

        warm_all_cached = all(r.get("cached") for r in warm_recs)
        warm_zero_steps = all(r["usage"]["steps"] == 0 for r in warm_recs)
        bit_identical = all(
            (root / "warm" / f"{w['id']}.npz").read_bytes()
            == (root / "cold" / f"{c['id']}.npz").read_bytes()
            for c, w in zip(cold_recs, warm_recs))
        speedup = cold_wall / warm_wall if warm_wall else float("inf")

        # prefix reuse: one config a third deeper than its cached entry
        base = reqs[0]
        deep = base.with_(ntime=base.ntime + base.ntime // 3)
        delta = deep.ntime - base.ntime
        _, _, (prefix_rec,) = run_wave([deep], root / "prefix", cache_dir,
                                       *conf)
        solo_eng = Engine(ServeConfig(lanes=args.lanes, chunk=args.chunk,
                                      buckets=BUCKETS,
                                      dispatch_depth=args.depth,
                                      emit_records=False), device=device)
        _, (solo_rec,) = drain(solo_eng, [deep])
        prefix_delta_exact = (prefix_rec["usage"]["steps"] == delta
                              and prefix_rec["usage"]["steps_saved"]
                              == base.ntime)
        with np.load(root / "prefix" / f"{prefix_rec['id']}.npz") as z:
            prefix_bit_identical = np.array_equal(z["T"], solo_rec["T"])

        # cache off gives the cold cached run's bytes
        _, _, off_recs = run_wave(reqs[:args.distinct], root / "off",
                                  cache_dir, *conf, cache=False)
        off_identical = all(
            (root / "off" / f"{o['id']}.npz").read_bytes()
            == (root / "cold" / f"{c['id']}.npz").read_bytes()
            for o, c in zip(off_recs, cold_recs[:args.distinct]))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    cold_stats = cold_eng.summary()["cache"]
    warm_stats = warm_eng.summary()["cache"]
    rec = {
        "bench": "serve_cache_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "distinct": args.distinct,
                   "lanes": args.lanes, "chunk": args.chunk,
                   "dispatch_depth": args.depth},
        "cold": {"wall_s": round(cold_wall, 3),
                 "ok": sum(r["status"] == "ok" for r in cold_recs),
                 "cache": cold_stats},
        "warm": {"wall_s": round(warm_wall, 3),
                 "ok": sum(r["status"] == "ok" for r in warm_recs),
                 "all_cached": warm_all_cached,
                 "zero_billed_steps": warm_zero_steps,
                 "cache": warm_stats},
        "prefix": {"cached_step": base.ntime, "ntime": deep.ntime,
                   "stepped": prefix_rec["usage"]["steps"],
                   "steps_saved": prefix_rec["usage"]["steps_saved"]},
        "warm_speedup": round(speedup, 2),
        "warm_speedup_ge_5": speedup >= 5.0,
        "full_hit_bit_identical": bit_identical,
        "prefix_delta_exact": prefix_delta_exact,
        "prefix_bit_identical": bool(prefix_bit_identical),
        "cache_off_bit_identical": off_identical,
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (speedup >= 5.0 and bit_identical and warm_all_cached
              and warm_zero_steps and prefix_delta_exact
              and prefix_bit_identical and off_identical)
    print(f"serve_cache_lab: {'OK' if passed else 'FAILED'} — warm wave "
          f"{speedup:.1f}x cold ({warm_wall:.3f}s vs {cold_wall:.3f}s), "
          f"{warm_stats['hits_full']} full hit(s), prefix stepped "
          f"{prefix_rec['usage']['steps']}/{deep.ntime} "
          f"(saved {prefix_rec['usage']['steps_saved']}), "
          f"bit-identical={bit_identical} on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
