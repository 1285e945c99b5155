"""Semantic-scheduling A/B: ``until=steady`` early exit against fixed steps
(the port of the JAX package's serve steady lab).

A diffusive population (sine eigenmode ICs, whose residual decays
geometrically) asked to run "until steady" retires lanes at the first chunk
boundary whose residual EWMA passes tolerance, and the freed lanes backfill
at once. Billing the requested work against the drain's wall, the steady
run must deliver at least 1.5x the effective throughput of the same
population run to completion. Three locks ride the number:

- ``steady_bit_identical``: a sample of early-exit fields equals a solo
  solve of the same request cut at its ``steps_done``, bit for bit;
- ``colane_bit_identical``: fixed-step co-requests drained beside the
  steady population give the same bytes as in the all-fixed-step run;
- ``zero_added_transfers``: a spy counts calls of ``serve/engine.
  host_fetch``, the one device-to-host seam; the steady run makes no more
  than the fixed-step run.

    python -m heat_tpu_torch.labs.serve_steady_lab [--requests 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

from ._util import ARTIFACTS, counts, init_device, stamp, work, write_atomic

# tolerance per grid side: the residual EWMA crosses well inside
# ntime=512 (n=24 near step 185, n=32 near step 105)
STEADY_TOL = {24: 2e-3, 32: 2e-3}
NTIME = 512


def build_population(count: int):
    """``count`` sine-eigenmode requests of two sides, each asking for
    NTIME steps it will not need (a chunk multiple: no tail chunk)."""
    from ..config import HeatConfig

    sides = (24, 32)
    return [HeatConfig(n=sides[i % 2], ntime=NTIME, dtype="float64",
                       bc="edges", ic="sine") for i in range(count)]


def build_colanes(count: int):
    """Fixed-step co-requests in both runs: hat ICs, shorter step counts."""
    from ..config import HeatConfig

    sides = (24, 32)
    return [HeatConfig(n=sides[i % 2], ntime=96 + 16 * (i % 2),
                       dtype="float64", bc="edges",
                       ic=("hat", "hat_small")[i % 2])
            for i in range(count)]


def run_engine(population, colanes, lanes, chunk, depth, device,
               steady: bool):
    """Drain population + colanes through one engine, counting every
    ``host_fetch``; the population asks ``until=steady`` when ``steady``."""
    from ..serve import Engine, ServeConfig
    from ..serve import engine as engine_mod

    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=(32,),
                             dispatch_depth=depth, emit_records=False),
                 device=device)
    fetches = [0]
    real_fetch = engine_mod.host_fetch

    def spy_fetch(x):
        fetches[0] += 1
        return real_fetch(x)

    t0 = time.perf_counter()
    try:
        engine_mod.host_fetch = spy_fetch
        ids = [eng.submit(cfg, until="steady", tol=STEADY_TOL[cfg.n])
               if steady else eng.submit(cfg) for cfg in population]
        co_ids = [eng.submit(cfg) for cfg in colanes]
        records = eng.results()
    finally:
        engine_mod.host_fetch = real_fetch
    wall = time.perf_counter() - t0
    by_id = {r["id"]: r for r in records}
    return (wall, eng, [by_id[i] for i in ids],
            [by_id[i] for i in co_ids], fetches[0])


def _block(cells, wall, eng, fetches, records):
    s = eng.summary()
    return {
        "wall_s": round(wall, 3),
        "effective_points_per_s": round(cells / wall, 1),
        **counts(records),
        "steady_exits": s["steady_exits"],
        "steps_saved": s["steps_saved"],
        "chunks_dispatched": s["chunks_dispatched"],
        "host_fetches": fetches,
        "step_compiles": s["step_compiles"],
        "tail_compiles": s["tail_compiles"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--colanes", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--out", default=str(ARTIFACTS / "serve_steady_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines and solves run (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..backends import resolve_device, solve

    device = resolve_device(args.device)
    setup_s = init_device(device)
    population = build_population(args.requests)
    colanes = build_colanes(args.colanes)
    # effective throughput bills the requested work on both sides
    cells = work(population) + work(colanes)

    fx_wall, fx_eng, fx_pop, fx_co, fx_fetches = run_engine(
        population, colanes, args.lanes, args.chunk, args.depth, device,
        steady=False)
    st_wall, st_eng, st_pop, st_co, st_fetches = run_engine(
        population, colanes, args.lanes, args.chunk, args.depth, device,
        steady=True)

    fixed = _block(cells, fx_wall, fx_eng, fx_fetches, fx_pop + fx_co)
    steady = _block(cells, st_wall, st_eng, st_fetches, st_pop + st_co)

    # lock 1: a steady exit is a scheduling decision, never a numerical one
    sample = sorted({0, 1, args.requests // 2, args.requests - 1})
    steady_bit = True
    for i in sample:
        r = st_pop[i]
        if r["status"] != "ok" or r.get("exit") != "steady":
            steady_bit = False
            break
        trunc = dataclasses.replace(population[i], ntime=int(r["steps_done"]))
        if not np.array_equal(r["T"], solve(trunc, device=device).T):
            steady_bit = False
            break

    # lock 2: co-lanes that never opted in are untouched across runs
    colane_bit = all(
        a["status"] == b["status"] == "ok"
        and a.get("exit") == b.get("exit") == "steps"
        and np.array_equal(a["T"], b["T"])
        for a, b in zip(fx_co, st_co))

    # lock 3: the steady decision reads the boundary vector the engine
    # fetches anyway
    zero_added = st_fetches <= fx_fetches

    all_retired = (steady["steady_exits"] == args.requests
                   and all(r.get("exit") == "steady"
                           and r["steps_done"] < NTIME for r in st_pop))
    multiplier = (fx_wall / st_wall) if st_wall > 0 else None

    rec = {
        "bench": "serve_steady_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "colanes": args.colanes,
                   "lanes": args.lanes, "chunk": args.chunk,
                   "dispatch_depth": args.depth, "buckets": [32],
                   "sides": [24, 32], "ntime": NTIME,
                   "steady_tol": {str(k): v for k, v
                                  in sorted(STEADY_TOL.items())},
                   "dtype": "float64"},
        "work_cell_steps": cells,
        "fixed": fixed,
        "steady": steady,
        "throughput_multiplier": (round(multiplier, 2)
                                  if multiplier else None),
        "all_population_retired_steady": all_retired,
        "steady_bit_identical": steady_bit,
        "colane_bit_identical": colane_bit,
        "zero_added_transfers": zero_added,
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (fixed["ok"] == steady["ok"] == args.requests + args.colanes
              and fixed["failed"] == steady["failed"] == 0
              and fixed["steady_exits"] == 0
              and all_retired
              and steady_bit and colane_bit and zero_added
              and multiplier is not None and multiplier >= 1.5)
    print(f"serve_steady_lab: {'OK' if passed else 'FAILED'} — "
          f"{rec['throughput_multiplier']}x effective throughput "
          f"({steady['effective_points_per_s']:.3g} vs "
          f"{fixed['effective_points_per_s']:.3g} pts/s), "
          f"{steady['steady_exits']} steady exit(s) saved "
          f"{steady['steps_saved']} step(s), host fetches "
          f"{st_fetches} vs {fx_fetches} fixed, bit-identical "
          f"steady={steady_bit} colane={colane_bit} on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
