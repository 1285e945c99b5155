"""The five BASELINE.json configurations, measured end to end on the card.
The port of the JAX package's ``benchmarks/run_all.py``.

    python -m heat_tpu_torch.labs.run_all [--only SUBSTR] [--row-timeout S]
    python -m heat_tpu_torch.labs.run_all --smoke --device cpu

Each row is one ``solve`` in the benchmark mode (``fetch=False``, the
two-point protocol beside the single-call rate: ``backends/common.drive``),
the best of ``repeat``. Rows keep the reference's keys; ``roofline_frac``
and ``roofline_frac_two_point`` divide by the card's one-pass-per-step
bound (its data-sheet memory rate over 2 * itemsize bytes a point), so a
temporally blocked kernel reads above 1 by design: they are not shares of
what the card could do (``machine.DeviceModel.pass_bound_s`` is). On the
CPU they are null. Each row adds ``kernel``, the launches of one solve
(``backends/cuda.launches_per_solve``, ``cuda`` rows), the launches the
row made in all, and ``labs/_util.stamp``.

On the card each row runs in its own subprocess under ``--row-timeout``
and merges its row into the record as it lands, so a hung row costs only
itself (``supervise_rows``); ``--row-timeout 0`` runs the rows in this
process, as ``--smoke`` always does. The record is
``heat_tpu_torch/labs/artifacts/run_all.json`` (``run_all_smoke.json``
with ``--smoke``, so a smoke run never clobbers the card's numbers).

Departures: the ``cuda`` backend stands for the reference's ``pallas``
(the row names say ``cuda``); the sharded row runs on an in-process mesh
of one shard per visible card (1x1 on one card); without a card and
without ``--device cpu`` the lab exits 2, naming ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ._util import ARTIFACTS, REPO, stamp, write_atomic

_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}


def configs(smoke: bool, ndev: int) -> list:
    """(name, HeatConfig) of the five configurations, at the reference's
    full or ``--smoke`` sizes (``benchmarks/run_all.py:166-193``)."""
    from ..config import HeatConfig

    s = smoke
    return [
        # 1. the serial numpy oracle (python/serial)
        ("1_serial_256sq_numpy",
         HeatConfig(n=256, ntime=8 if s else 200, dtype="float64",
                    backend="serial")),
        # 2. one card, 4096^2 (python/cuda: 4096^2 x 10000)
        ("2_cuda_4096sq_f32",
         HeatConfig(n=256 if s else 4096, ntime=20 if s else 16384,
                    dtype="float32", backend="cuda")),
        # 3. 16384^2 over a mesh (mpi+cuda); one shard per visible card
        ("3_sharded_16384sq_f32_mesh",
         HeatConfig(n=256 if s else 16384, ntime=20 if s else 500,
                    dtype="float32", backend="sharded",
                    mesh_shape=(4, 2) if (s and ndev >= 8) else None)),
        # 4. 3D 512^3, the 7-point stencil
        ("4_cuda_512cube_f32",
         HeatConfig(n=64 if s else 512, ndim=3, ntime=10 if s else 3200,
                    dtype="float32", backend="cuda", sigma=1 / 6)),
        # 5. bf16 storage, f32 arithmetic, 32768^2 (fortran/input_all.dat)
        ("5_bf16_32768sq",
         HeatConfig(n=512 if s else 32768, ntime=10 if s else 800,
                    dtype="bfloat16", backend="cuda")),
    ]


def bench_one(name, cfg, device, repeat: int = 1) -> dict:
    """One row: the best of ``repeat`` benchmark-mode solves of ``cfg``."""
    import torch

    from ..backends import cuda as cuda_backend
    from ..benchmark import one_pass_bound
    from ._util import bench_solve

    kw = dict(warm_exec=True, two_point_repeats=2)
    best, launches = bench_solve(cfg, device, **kw)
    for _ in range(repeat - 1):
        r, more = bench_solve(cfg, device, **kw)
        launches = {k: launches[k] + v for k, v in more.items()}
        if r.timing.solve_s < best.timing.solve_s:
            best = r
    t = best.timing
    roofline, label = one_pass_bound(device, _ITEMSIZE[cfg.dtype])
    tp = t.points_per_s_two_point
    where = stamp(device)
    mesh = best.mesh_shape or cfg.mesh_shape
    row = {
        "baseline_chip": label,
        "name": name,
        "measured_ts": time.time(),  # per row: --only merges into older rows
        "n": cfg.n, "ndim": cfg.ndim, "steps": t.steps,
        "dtype": cfg.dtype, "backend": cfg.backend,
        "mesh": list(mesh) if mesh else None,
        "solve_s": t.solve_s,
        "per_step_s": t.per_step_s,
        "points_per_s": t.points_per_s,
        "points_per_s_two_point": tp,
        "roofline_frac": None if roofline is None else t.points_per_s / roofline,
        "roofline_frac_two_point": (tp / roofline if tp and roofline
                                    else None),
        "devices": (torch.cuda.device_count()
                    if torch.device(device).type == "cuda" else 1),
        "kernel": t.kernel,
        "launches_per_solve": (cuda_backend.launches_per_solve(cfg)
                               if cfg.backend == "cuda" else None),
        "launches": launches,
        **where,
    }
    frac = ("" if roofline is None else
            f"  ({100 * row['roofline_frac']:.1f}% of the one-pass bound)")
    tp_note = f"  two-point {tp:.3e}" if tp else ""
    print(f"{name:40s} {row['points_per_s']:.3e} pts/s{frac}  per-step "
          f"{row['per_step_s'] * 1e6:.1f} us{tp_note}", flush=True)
    return row


def _read_rows(out: Path):
    if not out.exists():
        return []
    try:
        return json.loads(out.read_text()).get("rows", [])
    except json.JSONDecodeError:  # a torn file: start over
        return []


def _merge_rows(out: Path, rows):
    """Merge rows into the record by name, keeping the existing order (a
    partial re-measure must not clobber the other rows)."""
    old = _read_rows(out)
    fresh = {r["name"]: r for r in rows}
    merged = [fresh.pop(r["name"], r) for r in old] + list(fresh.values())
    write_atomic(out, {"ts": time.time(), "rows": merged})
    return merged


def supervise_rows(names, out: Path, row_timeout: int, device="cuda"):
    """Run each row in its own subprocess under a per-row deadline. A child
    merges its own row into ``out``; a child that fails or times out gets
    an error row, unless its row landed before it died."""
    import subprocess

    if not out.exists():
        write_atomic(out, {"ts": time.time(), "rows": []})
    for name in names:
        cmd = [sys.executable, "-m", "heat_tpu_torch.labs.run_all",
               "--only", name, "--row-timeout", "0", "--out", str(out),
               "--device", str(device)]
        t_start = time.time()
        try:
            rc = subprocess.run(cmd, timeout=row_timeout,
                                cwd=str(REPO)).returncode
            err = None if rc == 0 else f"row subprocess rc={rc}"
        except subprocess.TimeoutExpired:
            err = f"timed out after {row_timeout}s"
        if err:
            # a child can merge its row and then die in teardown: keep a
            # measurement that landed
            landed = any(r["name"] == name
                         and r.get("measured_ts", 0) >= t_start
                         and "error" not in r for r in _read_rows(out))
            if landed:
                print(f"{name:40s} child died post-measurement ({err}); "
                      f"row kept")
                continue
            print(f"{name:40s} FAILED: {err}")
            _merge_rows(out, [{"name": name, "error": err,
                               "measured_ts": time.time()}])
    print(f"wrote {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes (a harness check)")
    ap.add_argument("--only", help="substring filter on the row names")
    ap.add_argument("--row-timeout", type=int, default=1500,
                    help="seconds per row, each in its own subprocess "
                         "(0 = the rows in this process)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the device backends run (default cuda)")
    ap.add_argument("--out", help="the record (default "
                    "labs/artifacts/run_all.json, run_all_smoke.json with "
                    "--smoke)")
    args = ap.parse_args(argv)

    import torch

    from ..backends import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card where one was asked for
        print(f"run_all: {e}", file=sys.stderr)
        return 2
    out = Path(args.out) if args.out else ARTIFACTS / (
        "run_all_smoke.json" if args.smoke else "run_all.json")
    ndev = torch.cuda.device_count() if device.type == "cuda" else 1
    rows_of = configs(args.smoke, ndev)
    names = [n for n, _ in rows_of if not args.only or args.only in n]
    if args.row_timeout > 0 and not args.smoke:
        supervise_rows(names, out, args.row_timeout, device.type)
        return 0 if all("error" not in r for r in _read_rows(out)
                        if r["name"] in names) else 1

    rows = []
    for name, cfg in rows_of:
        if name not in names:
            continue
        try:
            rows.append(bench_one(name, cfg, device))
        except Exception as e:  # noqa: BLE001 - a failed row, keep measuring
            print(f"{name:40s} FAILED: {type(e).__name__}: {e}")
            rows.append({"name": name, "error": f"{type(e).__name__}: {e}",
                         "measured_ts": time.time()})
    if args.only and out.exists():
        _merge_rows(out, rows)  # a partial re-measure merges by name
    else:
        write_atomic(out, {"ts": time.time(), "rows": rows})
    print(f"wrote {out}")
    return 0 if all("error" not in r for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
