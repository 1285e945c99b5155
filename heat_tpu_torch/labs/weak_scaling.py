"""Weak scaling: constant work per shard, a growing mesh. The port of the
JAX package's weak-scaling lab (``benchmarks/weak_scaling.py``).

Efficiency = T(1 shard) / T(N shards) at constant cells per shard, over
1, 2, 4 ... shards: the mesh is ``parallel/mesh.auto_mesh_shape(N, 2)``,
the global side ``n`` is ``local_n * sqrt(N)`` rounded to a multiple of the
mesh's lcm (so shards divide evenly; a non-square count lands within ~2%
of ``local_n^2`` cells a shard), each row the best of 3 ``sharded`` solves
with no final fetch. The shards live in this process, as the reference's
single controller's do (``backends/sharded.make_comm``: shard i on
``cuda:(i % cards)``), one per card up to the cards there are.

``--virtual N`` runs N shards whatever the host has: on the CPU with
``--device cpu``; on a card with fewer cards than shards they time-share
it, so efficiency cannot hold by construction (``conditions`` says so),
and the rows are correctness and shape grade only.

    python -m heat_tpu_torch.labs.weak_scaling [--local-n 16384]
        [--virtual N] [--steps S] [--device cpu] [--out PATH]

The record goes to ``weak_scaling.json`` (``weak_scaling_virtual.json``
with ``--virtual``) unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from ._util import ARTIFACTS, bench_solve, init_device, stamp, write_atomic

REPEATS = 3


def sweep(ndev_total: int) -> list:
    """1, 2, 4 ... up to ``ndev_total``."""
    out, d = [], 1
    while d <= ndev_total:
        out.append(d)
        d *= 2
    return out


def geometry(ndev: int, local_n: int):
    """(mesh shape, global n) of the row of ``ndev`` shards."""
    from ..parallel.mesh import auto_mesh_shape

    mesh_shape = auto_mesh_shape(ndev, 2)
    mult = math.lcm(*mesh_shape)
    n = max(mult, round(local_n * math.sqrt(ndev) / mult) * mult)
    assert all(n % s == 0 for s in mesh_shape)
    return mesh_shape, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="N shards whatever the host has (time-sharing the "
                         "card, or on the CPU with --device cpu)")
    ap.add_argument("--local-n", type=int, default=0,
                    help="cells a side a shard (default: 1024, 64 virtual)")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps a solve (default: 200, 10 virtual)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the shards live (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..backends import resolve_device
    from ..config import HeatConfig

    device = resolve_device(args.device)
    setup_s = init_device(device, ("ftcs2d",))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    ndev_total = args.virtual or max(cards, 1)
    local_n = args.local_n or (64 if args.virtual else 1024)
    steps = args.steps or (10 if args.virtual else 200)
    out = args.out or str(ARTIFACTS / ("weak_scaling_virtual.json"
                                       if args.virtual
                                       else "weak_scaling.json"))

    rows = []
    for ndev in sweep(ndev_total):
        mesh_shape, n = geometry(ndev, local_n)
        cfg = HeatConfig(n=n, ntime=steps, dtype=args.dtype,
                         backend="sharded", mesh_shape=mesh_shape)
        per_step, launches = [], {}
        for _ in range(REPEATS):
            res, made = bench_solve(cfg, device, virtual_devices=ndev)
            per_step.append(res.timing.per_step_s)
            launches = {k: launches.get(k, 0) + v for k, v in made.items()}
            where = sorted({str(d) for d in res.T_dev.comm.devices})
            kf = res.exchange["kf"]
            del res
        best = min(per_step)
        pts_per_dev = n * n / ndev
        rows.append({
            "devices": ndev, "mesh": list(mesh_shape), "n": n, "kf": kf,
            "shards_on": where, "per_step_s": best,
            "per_step_s_repeats": per_step,
            "points_per_s_total": n * n / best,
            "s_per_point_per_device": best / pts_per_dev,
            "launches": launches})
        print(f"{ndev:3d} shards mesh {tuple(mesh_shape)} on {where}: "
              f"n={n:6d} per-step {best * 1e6:9.1f} us  "
              f"{n * n / best:.6g} pts/s, launches {launches}", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    base = rows[0]["s_per_point_per_device"]
    for row in rows:
        row["weak_efficiency"] = base / row["s_per_point_per_device"]
        print(f"{row['devices']:3d} shards: weak efficiency "
              f"{100 * row['weak_efficiency']:.1f}%", flush=True)

    shared = args.virtual and (device.type == "cpu" or args.virtual > cards)
    conditions = {
        "mode": ("virtual-" + device.type if args.virtual
                 else "hardware" if cards else "cpu"),
        "cards": cards, "repeats": REPEATS,
        "timing": "best-of-repeats, warmed up, no final fetch",
        "note": (
            "virtual rows put several shards on one device (the host's "
            "cores, or one card time-shared): weak efficiency cannot hold "
            "by construction; the rows are correctness and shape grade "
            "only, not a prediction of scaling across cards"
        ) if shared else ("one shard per card; efficiency is real" if cards
                          else "one shard on the CPU")}
    rec = {"bench": "weak_scaling", "ts": time.time(), **stamp(device),
           "setup_s": setup_s, "local_n": local_n, "steps": steps,
           "dtype": args.dtype, "conditions": conditions, "rows": rows}
    write_atomic(out, rec)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
