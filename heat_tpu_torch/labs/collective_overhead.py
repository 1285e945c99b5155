"""The per-exchange cost on one card, three ways. The port of the JAX
package's collective-overhead lab (``benchmarks/collective_overhead.py``).

1. ``post_chain``: chains of m posts through ``parallel/comm.LocalComm`` on
   one shard of a periodic 1x1 mesh (the shard is its own neighbour, as
   the reference's self-``ppermute`` on a one-device axis), each post's
   received slab then bumped by an in-place add, over a halo slab of 8 x
   16384 f32; the least-squares slope of time against m is the cost of a
   stage.
2. ``dispatch_chain``: the same chain of in-place adds without the posts;
   ``per_post_dispatch_s`` is the slope of (1) less the slope of (2).
3. ``exchange_delta``: the ``sharded`` solve at 16384^2 f32 x 512 steps on
   the 1x1 mesh at fuse depth k in (1, 8, 16, 32), two-point protocol,
   and the reference's fit ``t_step = t_comp + C/k``. No depth waits on a
   compile gate: the port builds each kernel source once.

In the port a deeper k also lets ``ftcs2d`` run deeper passes over the
padded shard: at k = 1 each step is a one-step pass over the whole shard.
So the fitted C carries the pass depth as well as the exchange. Beside it,
``exchange_alone`` times one exchange at each width k alone on the same
padded shard (the two-point protocol: CUDA events on the card, the host
clock on the CPU): that is the exchange without the passes.

    python -m heat_tpu_torch.labs.collective_overhead [--smoke] [--ks 1,8]
        [--device cpu] [--out PATH]

``--smoke`` is a 8 x 1024 slab and 512^2 x 32 steps, written to
``collective_overhead_smoke.json`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..runtime.timing import sync, two_point_rate
from ._util import ARTIFACTS, bench_solve, init_device, stamp, write_atomic

MS = (0, 1, 2, 4, 8, 16)
KS = (1, 8, 16, 32)


def best_time(call, x, repeats: int = 5) -> float:
    """Best-of-``repeats`` wall seconds of ``call(x)``, each fenced by a
    sync; a fixed overhead cancels in the slopes fitted over these."""
    sync(call(x))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        sync(call(x))
        best = min(best, time.perf_counter() - t0)
    return best


def chain(comm, m: int, collective: bool):
    """m stages over the slab: a post of it to its own shard (the received
    slab, which on one card is the slab itself) then an add of ``1 + i``
    in place; without ``collective`` the adds alone."""

    def body(s):
        for i in range(m):
            if collective:
                (s, _), = comm.post(0, [(s, s)])()
            s.add_(1 + i)
        return s

    return body


def slope(times: dict) -> float:
    import numpy as np

    xs = np.asarray(list(times), float)
    ys = np.asarray([times[m] for m in times], float)
    return float(np.polyfit(xs, ys, 1)[0])


def probe_chains(device, smoke: bool) -> dict:
    """Probes 1 and 2."""
    import torch

    from ..parallel.comm import LocalComm
    from ..parallel.mesh import RankMesh

    comm = LocalComm(RankMesh((1, 1), periodic=True), device)
    slab = torch.zeros((8, 1024 if smoke else 16384), dtype=torch.float32,
                       device=device)
    out = {}
    for collective in (True, False):
        name = "post_chain" if collective else "dispatch_chain"
        times = {m: best_time(chain(comm, m, collective), slab) for m in MS}
        out[name] = {"times_s": {str(m): t for m, t in times.items()},
                     "per_stage_s": slope(times)}
        print(f"{name}: per-stage {out[name]['per_stage_s'] * 1e6:.2f} us "
              f"(t0={times[0] * 1e3:.3f} ms, t16={times[16] * 1e3:.3f} ms)",
              flush=True)
    out["per_post_dispatch_s"] = (out["post_chain"]["per_stage_s"]
                                  - out["dispatch_chain"]["per_stage_s"])
    print(f"per-post dispatch overhead: "
          f"{out['per_post_dispatch_s'] * 1e6:.2f} us", flush=True)
    return out


def exchange_alone(n: int, k: int, device) -> float:
    """Seconds of one halo exchange of width ``k`` alone on the padded
    shard of n^2 owned cells on a 1x1 mesh, by the two-point protocol
    (CUDA events on the card, the host clock on the CPU)."""
    import torch

    from ..parallel import halo
    from ..parallel.comm import LocalComm
    from ..parallel.mesh import RankMesh

    comm = LocalComm(RankMesh((1, 1)), device)

    def once(padded):
        halo.halo_exchange([padded], comm, 1.0, width=k)
        return padded

    padded = torch.zeros((n + 2 * k,) * 2, dtype=torch.float32,
                         device=device)
    rate, _ = two_point_rate(once, padded, 1, repeats=3)
    return 1 / rate


def probe_exchange_delta(device, smoke: bool, ks, flush, rec: dict,
                         repeats: int = 2) -> dict:
    """Probe 3 with its fit (refreshed after every depth) and each depth's
    exchange alone."""
    import numpy as np

    from ..config import HeatConfig

    n, steps = (512, 32) if smoke else (16384, 512)
    out = rec.setdefault("exchange_delta", {"n": n, "steps": steps})
    rates = {}
    for k in ks:
        cfg = HeatConfig(n=n, ntime=steps, dtype="float32",
                         backend="sharded", mesh_shape=(1, 1), fuse_steps=k)
        res, launches = bench_solve(cfg, device,
                                    two_point_repeats=repeats)
        t = res.timing
        rates[k] = t.points_per_s_two_point or t.points_per_s
        del res
        alone = exchange_alone(n, k, device)
        out[f"fuse_{k}"] = {"points_per_s_two_point": rates[k],
                            "two_point_fell_back": t.two_point_fell_back,
                            "per_step_s": n * n / rates[k],
                            "solve_s": t.solve_s, "compile_s": t.compile_s,
                            "launches": launches,
                            "exchange_alone_s": alone}
        print(f"exchange_delta fuse={k}: {rates[k]:.6g} pts/s "
              f"({n * n / rates[k] * 1e6:.1f} us a step), one exchange "
              f"alone {alone * 1e6:.1f} us, launches {launches}", flush=True)
        if len(rates) >= 2:
            inv_k = np.asarray([1 / k for k in rates], float)
            t_step = np.asarray([n * n / rates[k] for k in rates], float)
            C, t_comp = np.polyfit(inv_k, t_step, 1)
            resid = t_step - (t_comp + C * inv_k)
            out["per_exchange_s"] = float(C)
            out["t_step_compute_s"] = float(t_comp)
            out["fit_ks"] = sorted(rates)
            out["fit_residuals_s"] = [float(r) for r in resid]
        flush()
    if "per_exchange_s" in out:
        alone = {k: out[f"fuse_{k}"]["exchange_alone_s"] for k in rates}
        print(f"fitted per-exchange C (the reference's fit, 1x1 mesh: the "
              f"exchange and the pass depth together): "
              f"{out['per_exchange_s'] * 1e6:.2f} us over k={sorted(rates)}; "
              f"an exchange alone: "
              + ", ".join(f"k={k} {v * 1e6:.1f} us" for k, v in alone.items()),
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes (a 8 x 1024 slab, 512^2 x 32 steps)")
    ap.add_argument("--ks", help="comma-separated fuse depths for the "
                                 "exchange-delta probe (default 1,8,16,32)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the shard lives (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device, ("ftcs2d",))
    out = args.out or str(ARTIFACTS / (
        "collective_overhead_smoke.json" if args.smoke
        else "collective_overhead.json"))
    rec = {"bench": "collective_overhead", "ts": time.time(), **stamp(device),
           "setup_s": setup_s, "smoke": bool(args.smoke)}

    def flush():
        write_atomic(out, rec)

    rec.update(probe_chains(device, args.smoke))
    flush()
    ks = tuple(int(s) for s in args.ks.split(",")) if args.ks else KS
    probe_exchange_delta(device, args.smoke, ks, flush, rec)
    flush()
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
