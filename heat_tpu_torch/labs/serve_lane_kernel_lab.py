"""Serve lane-kernel A/B: the hand-written lane kernels against the plain lane
body against solo kernel solves (the port of the JAX package's serve
lane-kernel lab).

The serving engine's chunk has two interchangeable bodies: the plain
PyTorch lane step (``--serve-lane-kernel torch``) and the hand-written lane
kernels (``cuda``: ``lanes2d``/``lanes3d``, the per-lane masking, the
countdown and the finite bit and stats fused into each launch). Three
ways over the serve lab's population at float32 (the kernels take no f64):

1. ``cuda``: the lane kernels;
2. ``torch``: the plain lane body, same engine;
3. ``solo_cuda``: one ``backends.solve`` per request with
   ``backend="cuda"`` (``ftcs2d``), the kernel each request would get alone.

Each side records its rate, its chunk and boundary counters, its
cost-model rows (keyed ``cuda``/``torch``), its fallbacks (none may occur:
every f32 bucket has a kernel) and the kernel launches it made. Hard gates
everywhere: the two engines' results byte-identical on every request, a
sample equal to the solo solve of the default (plain) backend, and no
fallback. ``cuda_beats_torch`` is hard on the card (``perfcheck``) and
informational on the CPU, where the ``cuda`` wrappers run the plain body.
The solo ``cuda`` kernel rounds once a pass, not every step, so it is
compared by rate only. Before any wall the device's context is made and
the ``lanes2d`` and ``ftcs2d`` libraries built and loaded (``setup_s``:
built once per checkout, so no side pays it).

    python -m heat_tpu_torch.labs.serve_lane_kernel_lab [--requests 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_requests, counts, drain,
                    init_device, stamp, work, write_atomic)


def _launches() -> dict:
    from ..ops import cuda_lanes, cuda_stencil

    return {**cuda_lanes.launches, **cuda_stencil.launches}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def run_engine(reqs, lanes: int, chunk: int, depth: int, kernel: str,
               device):
    from ..serve import Engine, ServeConfig

    before = _launches()
    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             dispatch_depth=depth, lane_kernel=kernel,
                             emit_records=False), device=device)
    wall, records = drain(eng, reqs)
    return wall, eng, records, _delta(before)


def run_solo_cuda(reqs, device):
    """Each request alone on the solo kernel (``ftcs2d``)."""
    from ..backends import solve

    before = _launches()
    t0 = time.perf_counter()
    fields = [solve(cfg.with_(backend="cuda"), device=device).T
              for cfg in reqs]
    return time.perf_counter() - t0, fields, _delta(before)


def _engine_block(cells, wall, eng, records, launches):
    s = eng.summary()
    return {
        "wall_s": round(wall, 3),
        "points_per_s": round(cells / wall, 1),
        **counts(records),
        "step_compiles": s["step_compiles"],
        "tail_compiles": s["tail_compiles"],
        "compile_s": s["compile_s"],
        "chunks_dispatched": s["chunks_dispatched"],
        "boundary_wait_s": s["boundary_wait_s"],
        "lane_kernel": s["lane_kernel"],
        "lane_kernel_fallbacks": s["lane_kernel_fallbacks"],
        "lane_passes": s["lane_passes"],
        "launches": launches,
        "cost_model": s["cost_model"],
    }


def main(argv=None) -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--out", default=str(ARTIFACTS
                                         / "serve_lane_kernel_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines and solves run (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device, solve

    device = resolve_device(args.device)
    setup_s = init_device(device, kernels=("lanes2d", "ftcs2d"))
    reqs = build_requests(args.requests, dtype="float32")
    cells = work(reqs)

    # the plain body first, so the kernels cannot inherit a warmer
    # process; the solo drives last
    t_wall, t_eng, t_recs, t_launch = run_engine(
        reqs, args.lanes, args.chunk, args.depth, "torch", device)
    c_wall, c_eng, c_recs, c_launch = run_engine(
        reqs, args.lanes, args.chunk, args.depth, "cuda", device)
    solo_wall, _, solo_launch = run_solo_cuda(reqs, device)

    bit_identical = all(
        a["T"].dtype == b["T"].dtype and a["T"].tobytes() == b["T"].tobytes()
        for a, b in zip(t_recs, c_recs))
    # the solo oracle: the default (plain torch) backend, whose arithmetic
    # the lane bodies share
    sample = sorted({0, len(reqs) // 2, len(reqs) - 1})
    solo_identical = all(
        np.array_equal(c_recs[i]["T"], solve(reqs[i], device=device).T)
        for i in sample)

    cuda_vs_torch = t_wall / c_wall if c_wall > 0 else None
    cuda_vs_solo = solo_wall / c_wall if c_wall > 0 else None
    rec = {
        "bench": "serve_lane_kernel_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "dispatch_depth": args.depth,
                   "buckets": list(BUCKETS), "sides": [24, 32, 48],
                   "ntimes": [96, 112, 128], "dtype": "float32"},
        "work_cell_steps": cells,
        "cuda": _engine_block(cells, c_wall, c_eng, c_recs, c_launch),
        "torch": _engine_block(cells, t_wall, t_eng, t_recs, t_launch),
        "solo_cuda": {"wall_s": round(solo_wall, 3),
                      "points_per_s": round(cells / solo_wall, 1),
                      "launches": solo_launch},
        "cuda_vs_torch": round(cuda_vs_torch, 3) if cuda_vs_torch else None,
        "cuda_vs_solo": round(cuda_vs_solo, 3) if cuda_vs_solo else None,
        "bit_identical": bool(bit_identical),
        "solo_sample_identical": bool(solo_identical),
        "zero_fallbacks": (c_eng.lane_kernel_fallbacks == 0
                           and t_eng.lane_kernel_fallbacks == 0),
        # hard on the card (perfcheck), informational on the CPU
        "cuda_beats_torch": (cuda_vs_torch or 0) > 1.0,
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    kernels_ran = device.type != "cuda" or (
        c_launch["lanes2d"] > 0 and solo_launch["ftcs2d"] > 0
        and t_launch["lanes2d"] == 0)
    passed = (rec["bit_identical"] and rec["solo_sample_identical"]
              and rec["zero_fallbacks"] and kernels_ran
              and rec["cuda"]["ok"] == args.requests
              and rec["torch"]["ok"] == args.requests)
    if device.type == "cuda":
        passed = passed and rec["cuda_beats_torch"]
    tag = "hard gate" if device.type == "cuda" else "informational on cpu"
    print(f"serve_lane_kernel_lab: {'OK' if passed else 'FAILED'} — "
          f"cuda {rec['cuda']['points_per_s']:.3g} pts/s vs torch "
          f"{rec['torch']['points_per_s']:.3g} ({rec['cuda_vs_torch']}x, "
          f"{tag}) vs solo cuda {rec['solo_cuda']['points_per_s']:.3g} "
          f"({rec['cuda_vs_solo']}x); bit-identical={rec['bit_identical']}, "
          f"solo sample={rec['solo_sample_identical']}, fallbacks=0:"
          f"{rec['zero_fallbacks']}; launches lanes2d "
          f"{c_launch['lanes2d']}, ftcs2d {solo_launch['ftcs2d']} on "
          f"{device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
