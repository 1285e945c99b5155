"""512^3 on one shard (a 1x1x1 mesh): the 3D fuse depth the ``sharded``
backend picks, side by side with the depths it could be asked for. The
port of the JAX package's check (``benchmarks/sharded3d_check.py``).

The auto depth in 3D is capped at the 3D kernel's pass depth, 8
(``backends/sharded.fuse_depth_sharded``), not the 2D cap of 32. This
times the ``sharded`` solve at 512^3 f32 x 960 steps, sigma 1/6, with the
auto depth, with 8 and with the old 2D-borrowed request of 32 (kf 32: a
576^3 padded shard, each block cut into passes of at most 8 steps), the
two-point protocol with 2 repeats, so the cap is pinned to a measurement.
Each row: its kf, the ``ftcs3d`` launches of the solve, its warm-up and
the protocol, and its points/s.

    python -m heat_tpu_torch.labs.sharded3d_check [--n 512] [--steps 960]
        [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time

from ._util import ARTIFACTS, bench_solve, init_device, stamp, write_atomic

FUSES = (None, 8, 32)   # auto (8 after the cap), the cap, the 2D depth


def measure(fuse_steps, n: int, steps: int, device):
    from ..config import HeatConfig

    cfg = HeatConfig(n=n, ndim=3, ntime=steps, dtype="float32",
                     backend="sharded", mesh_shape=(1, 1, 1), sigma=1 / 6,
                     fuse_steps=fuse_steps or 0)
    res, launches = bench_solve(cfg, device, two_point_repeats=2)
    t = res.timing
    return {"fuse_steps_requested": fuse_steps or "auto",
            "kf": res.exchange["kf"],
            "padded_shard": [n + 2 * res.exchange["kf"]] * 3,
            "points_per_s": t.points_per_s,
            "points_per_s_two_point": t.points_per_s_two_point
            or t.points_per_s,
            "two_point_fell_back": t.two_point_fell_back,
            "solve_s": t.solve_s, "kernel": t.kernel, "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=960)
    ap.add_argument("--out", default=str(ARTIFACTS / "sharded3d_check.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the shard lives (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device, ("ftcs3d",))
    rec = {"bench": "sharded3d_check", "ts": time.time(), **stamp(device),
           "setup_s": setup_s, "n": args.n, "steps": args.steps,
           "mesh": [1, 1, 1], "rows": []}
    for fuse in FUSES:
        row = measure(fuse, args.n, args.steps, device)
        rec["rows"].append(row)
        print(f"sharded {args.n}^3 1x1x1 fuse={row['fuse_steps_requested']}: "
              f"kf {row['kf']}, {row['points_per_s_two_point']:.6g} pts/s "
              f"two-point ({row['solve_s']:.3f} s solve), launches "
              f"{row['launches']}", flush=True)
        write_atomic(args.out, rec)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
