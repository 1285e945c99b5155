"""On-card numeric certification: the kernels as the backends launch them
against the serial numpy oracle. The port of the JAX package's chip check
(``benchmarks/chip_check.py``).

The CPU tests hold each kernel's plain version to the reference byte for
byte, and ``chip_smoke.py`` holds each kernel to its plain version on the
card; this lab runs every backend x BC x dtype x rank combination through
the backends' own entry points, at small sizes that cross tile edges (n =
200 is no multiple of the streamed tile), and holds the result to the
serial oracle in f32 within the reference's tolerances (5e-6 for f32, 5e-2
for bf16). The cases are the reference's, with ``xla`` renamed ``torch``
and ``pallas`` renamed ``cuda``; the ``sharded`` rows run on a 1x1 mesh,
as the reference's do on its one chip. An exception is a failed row, and
the exit code is 1 when any row fails.

One departure: the reference returns 0 without a TPU. Here ``--device
cuda`` (the default) raises without a card, and ``--device cpu`` certifies
the plain versions on the CPU.

    python -m heat_tpu_torch.labs.chip_check [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time

from ._util import ARTIFACTS, init_device, stamp, write_atomic

F32_TOL, BF16_TOL = 5e-6, 5e-2


def cases():
    """(name, config, tolerance) of every certified combination."""
    from ..config import HeatConfig

    # 2D: every BC on both device backends, both dtypes; the fuse axis on
    # the kernel only (0 = the planner's depth, 1 = one step a pass)
    for backend in ("torch", "cuda"):
        for bc in ("edges", "ghost", "periodic"):
            for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
                for fuse in (0, 1) if backend == "cuda" else (0,):
                    yield (f"2d-{backend}-{bc}-{dtype}-fuse{fuse}",
                           HeatConfig(n=200, ntime=24, dtype=dtype,
                                      backend=backend, bc=bc, ic="hat",
                                      fuse_steps=fuse),
                           tol)
    # 3D: the streamed 3D kernel, both dtypes
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        yield (f"3d-cuda-edges-{dtype}",
               HeatConfig(n=48, ndim=3, ntime=10, dtype=dtype, sigma=0.15,
                          backend="cuda", bc="edges", ic="hat"),
               tol)
    # sharded on one shard (1x1 mesh): the padded carry, the bounded
    # kernel and the halo machinery, all three BCs
    for bc in ("edges", "ghost", "periodic"):
        yield (f"2d-sharded-{bc}-float32",
               HeatConfig(n=256, ntime=20, dtype="float32",
                          backend="sharded", bc=bc, ic="hat",
                          mesh_shape=(1, 1)),
               F32_TOL)


def certify(device, echo=print) -> dict:
    """Run every case on ``device``; returns the record's body: rows,
    passed, failed, the kernel launches of the run, and its seconds."""
    import numpy as np

    from ..backends import solve
    from ..ops import cuda_stencil

    t0 = time.perf_counter()
    cuda_stencil.reset_launches()
    rows, oracles = [], {}
    for name, cfg, tol in cases():
        # the oracle in f32 (bf16 storage is bounded by the tolerance);
        # many cases share one oracle config, solved once
        oracle_cfg = cfg.with_(backend="serial", fuse_steps=0,
                               dtype="float32", mesh_shape=None)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                if oracle_cfg not in oracles:
                    oracles[oracle_cfg] = solve(oracle_cfg).T
                got = solve(cfg, device=device, warm_exec=False).T
            ref = oracles[oracle_cfg]
            err = float(np.max(np.abs(np.asarray(got, np.float32)
                                      - np.asarray(ref, np.float32))))
            ok = bool(err < tol)
        except Exception as e:  # noqa: BLE001 - a failed row, keep certifying
            err, ok = None, False
            echo(f"{name:40s} ERROR {type(e).__name__}: {str(e)[:120]}")
        else:
            echo(f"{name:40s} max|err| {err:.2e}  "
                 f"{'OK' if ok else f'FAIL (tol {tol:g})'}")
        rows.append({"name": name, "max_abs_err": err, "tol": tol, "ok": ok})
    failed = sum(not r["ok"] for r in rows)
    return {"passed": len(rows) - failed, "failed": failed, "rows": rows,
            "launches": dict(cuda_stencil.launches),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ARTIFACTS / "chip_check.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the backends run (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device, ("ftcs2d", "ftcs3d"))
    body = certify(device, echo=lambda s: print(s, flush=True))
    rec = {"bench": "chip_check", "ts": time.time(), **stamp(device),
           "setup_s": setup_s, **body}
    write_atomic(args.out, rec)
    print(f"chip_check: {body['passed']}/{len(body['rows'])} passed in "
          f"{body['seconds']:.1f} s; launches {body['launches']}; wrote "
          f"{args.out}")
    return 1 if body["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
