"""A/B: checkpoint cost on and off the stepping path (the asynchronous
checkpoint pipeline). The port of the JAX package's checkpoint-overlap lab
(``benchmarks/ckpt_overlap.py``).

The sync path stalls the stream at every checkpoint: a sync, the fetch of
the field, the write. The async path (``runtime/async_io.py``) takes one
on-device clone and hands it to a bounded-queue writer thread, which does
the device-to-host copy and the write while the stream steps on. Rows, all
with the same heartbeat cadence so every row runs the same chunks and only
the I/O policy differs:

- ``baseline``: no checkpoints;
- ``ckpt_sync`` / ``ckpt_async``: ``--async-io off`` / ``on`` with the
  fake slow sink: ``checkpoint.save`` replaced by a ``time.sleep`` of 0.6x
  one interval's compute (``--delay`` pins it), patched on the module so
  the sync and async paths both see it. The fetch of the field still runs
  (on the card: the writer thread's device-to-host copy of the clone).

Verdicts: async within 10% of the baseline, sync slower than async. Then
``bit_identical``: short runs with the real save, async against sync, each
checkpoint step's file read back through ``checkpoint.load`` (every step's
file: the reference passes ``ntime=step`` to ``latest``, which caps
nothing, so it compares the newest file each time).

    python -m heat_tpu_torch.labs.ckpt_overlap [--backend cuda --n 4096]
        [--device cpu] [--work-dir DIR] [--out PATH]

``--work-dir`` keeps the checkpoint directories there (the bit-identity
runs' in ``bit_sync/`` and ``bit_async/``); without it they go to a
temporary directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

from ._util import ARTIFACTS, bench_solve, init_device, stamp, write_atomic


def solve_best(cfg, repeats: int, device, root: Path, tag: str):
    """Best-of-``repeats`` solve with no final fetch, each repeat writing
    into a fresh checkpoint directory under ``root``; returns (best
    SolveResult, the best repeat's directory)."""
    best = best_dir = None
    for i in range(repeats):
        d = root / f"{tag}-{i}"
        c = cfg.with_(checkpoint_dir=str(d)) if cfg.checkpoint_every else cfg
        res, _ = bench_solve(c, device)
        if best is None or res.timing.solve_s < best.timing.solve_s:
            best, best_dir = res, d
    return best, best_dir


def checkpoints_identical(cfg, d_sync: Path, d_async: Path, every: int,
                          steps: int) -> bool:
    """Every checkpoint step's file in ``d_async`` loads equal (field and
    step) to ``d_sync``'s."""
    import numpy as np

    from ..runtime import checkpoint

    for step in range(every, steps + 1, every):
        got = []
        for d in (d_sync, d_async):
            c = cfg.with_(checkpoint_dir=str(d))
            path = checkpoint.latest(c, max_step=step)
            if path is None:
                return False
            got.append(checkpoint.load(path, c))
        (Ts, ss), (Ta, sa) = got
        if ss != step or sa != step or not np.array_equal(Ts, Ta):
            return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--every", type=int, default=32,
                    help="checkpoint interval (steps)")
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "cuda", "sharded"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--delay", type=float, default=0.0,
                    help="fake sink delay per save, seconds (0 = 0.6x one "
                         "interval's compute)")
    ap.add_argument("--work-dir", default=None,
                    help="keep the checkpoint directories here")
    ap.add_argument("--out", default=str(ARTIFACTS / "ckpt_overlap.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the field lives (default cuda)")
    args = ap.parse_args(argv)

    n_ckpts = args.steps // args.every
    if n_ckpts < 2:
        ap.error("need steps/every >= 2 checkpoints for a meaningful A/B")

    from ..backends import resolve_device
    from ..config import HeatConfig
    from ..ops import cuda_stencil
    from ..runtime import checkpoint
    from ..utils import torch_dtype

    device = resolve_device(args.device)
    setup_s = init_device(device, ("ftcs2d",))
    root = Path(args.work_dir or tempfile.mkdtemp(prefix="ckpt_overlap_"))
    root.mkdir(parents=True, exist_ok=True)
    # the same heartbeat cadence everywhere: every row runs the same chunks
    base = HeatConfig(n=args.n, ntime=args.steps, dtype=args.dtype,
                      backend=args.backend, heartbeat_every=args.every)
    ck = base.with_(checkpoint_every=args.every)
    rec = {"bench": "ckpt_overlap", "ts": time.time(), **stamp(device),
           "setup_s": setup_s, "n": args.n, "steps": args.steps,
           "every": args.every, "backend": args.backend, "dtype": args.dtype,
           "repeats": args.repeats,
           "field_bytes": base.points * torch_dtype(args.dtype).itemsize,
           "rows": {}}
    cuda_stencil.reset_launches()
    try:
        # row 1: no checkpoints (the wall the async row must hold)
        res0, _ = solve_best(base, args.repeats, device, root, "baseline")
        b = res0.timing.solve_s
        rec["rows"]["baseline"] = {"solve_s": b}
        print(f"baseline (no ckpt): solve {b:.4f} s", flush=True)

        # the fake slow sink
        delay = args.delay or max(0.005, 0.6 * b / n_ckpts)
        rec["sink_delay_s"] = delay
        print(f"fake sink delay: {delay * 1e3:.1f} ms/save ({n_ckpts} "
              f"saves/run)", flush=True)
        real_save = checkpoint.save

        def fake_sink(cfg, T, step):
            time.sleep(delay)   # the fetch-and-write seconds, as wall time

        checkpoint.save = fake_sink
        try:
            res_sync, _ = solve_best(ck.with_(async_io="off"), args.repeats,
                                     device, root, "sync")
            rec["rows"]["ckpt_sync"] = {"solve_s": res_sync.timing.solve_s}
            print(f"ckpt  --async-io off: solve "
                  f"{res_sync.timing.solve_s:.4f} s", flush=True)
            res_async, _ = solve_best(ck.with_(async_io="on"), args.repeats,
                                      device, root, "async")
            t = res_async.timing
            rec["rows"]["ckpt_async"] = {"solve_s": t.solve_s,
                                         "overlap_s": t.overlap_s,
                                         "io_wait_s": t.io_wait_s}
            print(f"ckpt  --async-io on : solve {t.solve_s:.4f} s (overlap "
                  f"{t.overlap_s:.4f} s hidden, {t.io_wait_s:.4f} s "
                  f"blocked)", flush=True)
        finally:
            checkpoint.save = real_save

        rec["async_vs_baseline"] = res_async.timing.solve_s / b
        rec["sync_vs_baseline"] = res_sync.timing.solve_s / b
        ok_async = rec["async_vs_baseline"] <= 1.10
        ok_sync = rec["sync_vs_baseline"] > rec["async_vs_baseline"]
        print(f"async/baseline = {rec['async_vs_baseline']:.3f} "
              f"({'PASS: within 10%' if ok_async else 'FAIL: > 10% over'}); "
              f"sync/baseline = {rec['sync_vs_baseline']:.3f}", flush=True)

        # bit identity: the real save, async against sync
        _, d_sync = solve_best(ck.with_(async_io="off"), 1, device, root,
                               "bit_sync")
        _, d_async = solve_best(ck.with_(async_io="on"), 1, device, root,
                                "bit_async")
        d_sync = d_sync.rename(root / "bit_sync")
        d_async = d_async.rename(root / "bit_async")
        identical = checkpoints_identical(ck, d_sync, d_async, args.every,
                                          args.steps)
        rec["bit_identical"] = identical
        print(f"async checkpoints bit-identical to sync: {identical}",
              flush=True)
    finally:
        if args.work_dir is None:
            shutil.rmtree(root, ignore_errors=True)
    rec["launches"] = dict(cuda_stencil.launches)
    write_atomic(args.out, rec)
    print(f"launches {rec['launches']}; wrote {args.out}")
    return 0 if (ok_async and ok_sync and identical) else 1


if __name__ == "__main__":
    sys.exit(main())
