"""A/B: ``--exchange overlap`` against ``indep`` on one shard. The port of
the JAX package's overlap lab (``benchmarks/overlap_ab.py``).

Times the ``sharded`` solve (the padded carry with the kernel on the shard,
the two-point protocol, no final fetch) at 16384^2 f32 x 512 steps on the
1x1 mesh, for each exchange form and fuse depth. One shard has no neighbour
to wait for, so this measures what the restructuring costs or wins: the
interior and the 3^nd - 1 rim regions as separate kernel calls (each cut
into passes at its shape) against one call on the whole padded shard.

Depths 16 and 32, both always. The reference runs 32 only behind
``--deep`` and a compile-bisect record that proved the depth-32 Mosaic
compile bounded; the port builds each kernel source once with ``nvcc``
(every depth 1..32 is an instance of ``ftcs2d.cu``), so that gate has
nothing to gate.

    python -m heat_tpu_torch.labs.overlap_ab [--smoke] [--device cpu]
        [--out PATH]

``--smoke`` is 512^2 x 32 steps at fuse 4, written to
``overlap_ab_smoke.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time

from ._util import ARTIFACTS, bench_solve, init_device, stamp, write_atomic

DEPTHS = (16, 32)


def measure(cfg, device):
    """One ``sharded`` solve of ``cfg`` with the two-point protocol: (its
    rates, kf, and the kernel launches of the solve, its warm-up and the
    protocol; the owned cells of its final shards)."""
    res, launches = bench_solve(cfg, device, two_point_repeats=2)
    t = res.timing
    row = {"points_per_s_two_point": (t.points_per_s_two_point
                                      or t.points_per_s),
           "two_point_fell_back": t.two_point_fell_back,
           "points_per_s": t.points_per_s, "solve_s": t.solve_s,
           "compile_s": t.compile_s, "kf": res.exchange["kf"],
           "local_kernel": res.exchange["local_kernel"],
           "kernel": t.kernel, "launches": launches}
    return row, res.T_dev.owned()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="512^2 x 32 steps at fuse 4")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the shard lives (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..backends import resolve_device
    from ..config import HeatConfig

    device = resolve_device(args.device)
    setup_s = init_device(device, ("ftcs2d",))
    n, steps = (512, 32) if args.smoke else (16384, 512)
    out = args.out or str(ARTIFACTS / ("overlap_ab_smoke.json" if args.smoke
                                       else "overlap_ab.json"))
    rec = {"bench": "overlap_ab", "ts": time.time(), **stamp(device),
           "setup_s": setup_s, "n": n, "steps": steps, "dtype": "float32",
           "mesh": [1, 1], "rows": {}, "overlap_vs_indep": {},
           "fields_equal": {}}
    for k in (4,) if args.smoke else DEPTHS:
        fields = {}
        for exchange in ("indep", "overlap"):
            cfg = HeatConfig(n=n, ntime=steps, dtype="float32",
                             backend="sharded", mesh_shape=(1, 1),
                             fuse_steps=k, exchange=exchange,
                             local_kernel="cuda")
            row, fields[exchange] = measure(cfg, device)
            rec["rows"][f"{exchange}_fuse{k}"] = row
            print(f"{exchange:8s} fuse={k:2d}: "
                  f"{row['points_per_s_two_point']:.6g} pts/s two-point, kf "
                  f"{row['kf']}, launches {row['launches']}", flush=True)
            write_atomic(out, rec)
        a = rec["rows"][f"indep_fuse{k}"]["points_per_s_two_point"]
        b = rec["rows"][f"overlap_fuse{k}"]["points_per_s_two_point"]
        rec["overlap_vs_indep"][str(k)] = b / a
        # the two forms compute the same field: its bytes, every shard
        same = all(torch.equal(x, y) for x, y in zip(fields["indep"],
                                                     fields["overlap"]))
        rec["fields_equal"][str(k)] = same
        del fields
        print(f"fuse={k}: overlap/indep = {b / a:.4f} (per step "
              f"{n * n / b * 1e6:.1f} against {n * n / a * 1e6:.1f} us); "
              f"final fields byte-equal: {same}", flush=True)
        write_atomic(out, rec)
    print(f"wrote {out}")
    return 0 if all(rec["fields_equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
