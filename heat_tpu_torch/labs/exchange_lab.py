"""Where does the per-exchange cost go? The port of the JAX package's
exchange lab (``benchmarks/exchange_lab.py``).

On a 1x1 mesh of one shard (``LocalComm``), a padded f32 shard of n^2
owned cells and a width-w ghost ring (16384^2, w = 8 by default), it times
the halo exchange alone (``parallel/halo.py``) with the two-point protocol
(``runtime/timing.two_point_rate``) in these forms:

- ``slab`` / ``slab_staged``: the shipped exchange, whose ghost writes are
  in-place slab assignments into the padded shard, with the slabs moved
  directly or through host memory (``--comm staged``);
- ``concat``: each axis rebuilt by ``torch.cat([ghost, interior, ghost])``
  (the reference's ``concat``: one explicit full pass per axis);
- ``donate``: not run. The reference's row asks XLA for an in-place update
  by donating the buffer; PyTorch has no such request: the shipped
  exchange writes in place whatever is asked.

In place of the reference's HLO copy census, each form's bytes allocated by
the caching allocator per exchange (``torch.cuda.memory_stats``) are
reported, as copies of the full padded shard. Then the padded-carry rows:
the ``sharded`` backend's solve of 64 steps on that mesh with exchange
``seq`` / ``indep`` / ``overlap`` and fuse depth kf in {1, 8} (overlap at
kf = 1 skipped, as in the reference: a width-1 rim is the shard's edge),
its two-point rate per step and its kernel launches (``ftcs2d``: K1/K2's
port).

    python -m heat_tpu_torch.labs.exchange_lab [--n 16384] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

from ._util import ARTIFACTS, init_device, stamp, write_atomic

STEPS = 64


def concat_exchange(comm, bc_value, w: int):
    """The reference's ``concat`` form on one padded shard: per axis, the
    slabs posted through ``comm`` (``bc_value`` where there is no
    neighbour) and the axis rebuilt by concatenation."""
    import torch

    from ..parallel.halo import _or_bc, _slab

    def exchange(padded):
        out = padded
        nd = out.dim()
        for d in range(nd):
            send_lo = out[_slab(nd, d, slice(w, 2 * w))]
            send_hi = out[_slab(nd, d, slice(-2 * w, -w))]
            (from_prev, from_next), = comm.post(d, [(send_lo, send_hi)])()
            out = torch.cat([_or_bc(from_prev, send_hi, bc_value),
                             out[_slab(nd, d, slice(w, -w))],
                             _or_bc(from_next, send_lo, bc_value)], dim=d)
        return out

    return exchange


def slab_exchange(comm, bc_value, w: int):
    """The shipped exchange: in-place ghost writes (``halo_exchange``)."""
    from ..parallel.halo import halo_exchange

    def exchange(padded):
        halo_exchange([padded], comm, bc_value, width=w)
        return padded

    return exchange


def allocated_per_call(fn, x, device, calls: int = 4):
    """Bytes the caching allocator hands out per call of ``fn`` (None off
    the card)."""
    import torch

    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_stats(device)["allocated_bytes.all.allocated"]
    for _ in range(calls):
        x = fn(x)
    torch.cuda.synchronize(device)
    after = torch.cuda.memory_stats(device)["allocated_bytes.all.allocated"]
    return (after - before) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384,
                    help="owned cells a side (default 16384)")
    ap.add_argument("--w", type=int, default=8, help="ghost width")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=str(ARTIFACTS / "exchange_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the shard lives (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..backends import resolve_device, solve
    from ..config import HeatConfig
    from ..ops import cuda_stencil
    from ..parallel.comm import LocalComm
    from ..parallel.mesh import build_mesh
    from ..runtime.timing import two_point_rate

    device = resolve_device(args.device)
    setup_s = init_device(device, ("ftcs2d",))
    n, w = args.n, args.w
    bc_value = 2.0
    padded = torch.zeros((n + 2 * w,) * 2, dtype=torch.float32, device=device)
    shard_bytes = padded.numel() * padded.element_size()
    rec = {"bench": "exchange_lab", "ts": time.time(), **stamp(device),
           "n": n, "w": w,
           "dtype": "float32", "mesh": [1, 1], "setup_s": setup_s,
           "padded_shard_bytes": shard_bytes, "variants": {}}

    mesh = build_mesh(2, 1, (1, 1))
    forms = {"slab": slab_exchange(LocalComm(mesh, device), bc_value, w),
             "slab_staged": slab_exchange(LocalComm(mesh, device, staged=True),
                                          bc_value, w),
             "concat": concat_exchange(LocalComm(mesh, device), bc_value, w)}
    for name, fn in forms.items():
        rate, raw = two_point_rate(fn, padded, padded.numel(),
                                   repeats=args.repeats)
        alloc = allocated_per_call(fn, padded, device)
        row = {"per_exchange_s": padded.numel() / rate,
               "per_exchange_s_raw": padded.numel() / raw,
               "allocated_bytes_per_exchange": alloc,
               "full_shard_copies": (None if alloc is None
                                     else alloc / shard_bytes)}
        rec["variants"][name] = row
        print(f"{name:12s} per-exchange {row['per_exchange_s'] * 1e6:10.1f} us"
              f"  allocated {alloc if alloc is None else f'{alloc:.0f} B'}"
              f" ({row['full_shard_copies']} shard copies)", flush=True)
        write_atomic(args.out, rec)
    rec["variants"]["donate"] = {
        "skipped": "buffer donation asks XLA for an in-place update; "
                   "PyTorch has no such request, and the shipped exchange "
                   "writes its ghost slabs in place (the 'slab' row)"}
    del padded

    for exchange in ("seq", "indep", "overlap"):
        for kf in (1, 8):
            if exchange == "overlap" and kf == 1:
                continue  # a width-1 rim is the shard's edge
            cfg = HeatConfig(n=n, ntime=STEPS, dtype="float32",
                             backend="sharded", mesh_shape=(1, 1),
                             fuse_steps=kf, exchange=exchange,
                             local_kernel="cuda" if exchange == "overlap"
                             else "auto")
            cuda_stencil.reset_launches()
            res = solve(cfg, device=device, fetch=False,
                        two_point_repeats=args.repeats)
            t = res.timing
            row = {"per_step_s": n * n / t.points_per_s_two_point,
                   "two_point_fell_back": t.two_point_fell_back,
                   "solve_per_step_s": t.per_step_s, "kf": res.exchange["kf"],
                   "local_kernel": res.exchange["local_kernel"],
                   "kernel": t.kernel,
                   # the solve's, its warm-up's and the protocol's
                   "launches": dict(cuda_stencil.launches)}
            rec["variants"][f"real_advance_{exchange}_fuse{kf}"] = row
            print(f"real advance {exchange} fuse={kf}: per-step "
                  f"{row['per_step_s'] * 1e6:9.1f} us  ({t.kernel}, "
                  f"launches {row['launches']})", flush=True)
            write_atomic(args.out, rec)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
