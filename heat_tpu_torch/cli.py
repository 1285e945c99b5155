"""Command-line entry point: the ``program heat`` analog.

Keeps the reference's external contract: read ``input.dat`` from the
working directory, run the solve, write ``int.dat``/``soln.dat``, print the
familiar stdout lines ("simulation completed!!!!", timing) —
fortran/serial/heat.f90:11-13,50-55,73-83. The reference's build-time
variant choice becomes ``--backend`` / ``--variant``; ``SINGLE_PRECISION``
becomes ``--dtype``. Solves run on the card (``--device cuda``, the
default) unless ``--device cpu`` is given.

Usage: ``python -m heat_tpu_torch run [--backend cuda] [--json]`` and
``python -m heat_tpu_torch info``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from .config import VARIANTS, HeatConfig, parse_input, variant_config
from .grid import coords, initial_condition
from .runtime.logging import master_print


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="heat-tpu-torch",
        description="heat-equation framework on PyTorch + CUDA "
        "(capability rebuild of CUDA-HIP-MPI-Heat-equation-test)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="solve the heat equation (input.dat contract)")
    run.add_argument("--input", default="input.dat",
                     help="input.dat path: 'n sigma nu dom_len ntime [soln]'")
    run.add_argument("--variant", choices=sorted(VARIANTS),
                     help="reference-variant preset (sets ic/bc/backend/dtype)")
    run.add_argument("--backend", choices=["serial", "torch", "cuda", "sharded"])
    run.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="where device backends run (default cuda; the "
                          "serial oracle always runs on the host)")
    run.add_argument("--dtype", choices=["float64", "float32", "bfloat16"])
    run.add_argument("--ic", choices=["hat", "hat_half", "hat_small", "uniform", "zero"])
    run.add_argument("--bc", choices=["edges", "ghost", "periodic"])
    run.add_argument("--bc-value", type=float)
    run.add_argument("--ndim", type=int, choices=[2, 3])
    run.add_argument("--fuse-steps", type=int,
                     help="cuda temporal blocking depth (0=auto, 1=off)")
    run.add_argument("--heartbeat-every", type=int,
                     help="print 'time_it: i' every k steps (reference prints every step)")
    run.add_argument("--report-sum", action="store_true",
                     help="global temperature sum (the reference's "
                          "commented-out MPI_Reduce, made real)")
    run.add_argument("--checkpoint-every", type=int)
    run.add_argument("--checkpoint-dir")
    run.add_argument("--async-io", dest="async_io",
                     choices=["on", "off", "auto"],
                     help="checkpoint/numerics I/O pipeline: on = "
                          "snapshot-and-continue, off = sync fallback, "
                          "auto (default) = on")
    run.add_argument("--profile", dest="profile_dir", metavar="DIR",
                     help="write a torch.profiler trace of the solve to DIR")
    run.add_argument("--check-numerics", action="store_true",
                     help="detect NaN/Inf per chunk (debug)")
    run.add_argument("--on-nan", dest="on_nan", choices=["abort", "rollback"],
                     help="non-finite response under --check-numerics")
    run.add_argument("--inject", metavar="SPEC",
                     help="deterministic fault injection: comma-separated "
                          "'kind[@step][:key=val]...' — crash@N[:proc=P], "
                          "nan@N, ckpt-corrupt@N, ckpt-truncate@N, "
                          "sink-error@N[:times=K], sink-slow:ms=M")
    run.add_argument("--write-int", action=argparse.BooleanOptionalAction,
                     default=None,
                     help="dump the initial field to int.dat before solving")
    run.add_argument("--out", default="soln.dat", help="solution file path")
    run.add_argument("--soln", action="store_true",
                     help="force solution dump even if input.dat flag is 0")
    run.add_argument("--json", action="store_true",
                     help="also print a machine-readable result line")

    sub.add_parser("info", help="show devices / kernel toolchain / native-lib status")
    return p


def _apply_overrides(cfg: HeatConfig, args) -> HeatConfig:
    """Fold CLI flags into the config."""
    over = {}
    for field in ("backend", "dtype", "ic", "bc", "ndim", "fuse_steps",
                  "heartbeat_every", "checkpoint_every", "checkpoint_dir",
                  "async_io", "profile_dir", "write_int", "on_nan", "inject"):
        v = getattr(args, field, None)
        if v is not None:
            over[field] = v
    if getattr(args, "bc_value", None) is not None:
        over["bc_value"] = args.bc_value
    for flag in ("report_sum", "check_numerics", "soln"):
        if getattr(args, flag, False):
            over[flag] = True
    return cfg.with_(**over)


def _warn_if_unstable(cfg: HeatConfig) -> None:
    """Warn when sigma exceeds the explicit FTCS stability bound 1/(2*ndim)
    (fortran/serial/heat.f90:15-17) — a warning, not an error, as in the
    reference."""
    lim = 1.0 / (2 * cfg.ndim)
    if cfg.sigma > lim + 1e-12:
        master_print(
            f"WARNING: sigma={cfg.sigma:g} exceeds the explicit FTCS "
            f"stability bound 1/(2*ndim)={lim:g} for ndim={cfg.ndim} — "
            f"the update can diverge to NaN/Inf; lower sigma (or run with "
            f"--check-numerics to catch the blow-up at its first step)")


def cmd_run(args) -> int:
    path = Path(args.input)
    if not path.exists():
        print(f"error: {path} not found (expected 'n sigma nu dom_len ntime [soln]')",
              file=sys.stderr)
        return 2
    cfg = parse_input(path)
    if args.variant:
        cfg = variant_config(args.variant, cfg)
    cfg = _apply_overrides(cfg, args)
    _warn_if_unstable(cfg)

    from .backends import resolve_device, solve
    from .ops import cuda_stencil

    try:  # no card where one was asked for
        device = None if cfg.backend == "serial" else resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    axes = coords(cfg)
    if cfg.write_int:
        from .io import write_int_dat

        write_int_dat("int.dat", axes, initial_condition(cfg))

    try:
        res = solve(cfg, device=device)
    except NotImplementedError as e:  # a path later slices bring
        print(f"error: {e}", file=sys.stderr)
        return 2
    for line in res.timing.report_lines():
        master_print(line)
    if res.gsum is not None:
        master_print(f"Sum of Temperature: {res.gsum:.10g}")

    if cfg.soln:
        from .io import write_soln

        write_soln(args.out, axes, res.T)
        master_print(f"wrote {args.out}")

    if args.json:
        rec = {
            "n": cfg.n, "ndim": cfg.ndim, "ntime": cfg.ntime,
            "backend": cfg.backend, "dtype": cfg.dtype, "device": res.device,
            "kernel": res.timing.kernel,
            "launches": dict(cuda_stencil.launches),
            "compile_s": res.timing.compile_s,
            "solve_s": res.timing.solve_s,
            "per_step_s": res.timing.per_step_s,
            "points_per_s": res.timing.points_per_s,
            "gsum": res.gsum,
            "gsum_dtype": res.gsum_dtype,
        }
        if res.timing.overlap_s is not None:
            rec["overlap_s"] = res.timing.overlap_s
            rec["io_wait_s"] = res.timing.io_wait_s
        master_print(json.dumps(rec))
    return 0


def cmd_info(_args) -> int:
    import torch

    from .io.native import native_available
    from .ops import _build

    print(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}, "
          f"cuda available: {torch.cuda.is_available()}")
    if torch.cuda.is_available():
        from .machine import device_model

        for i in range(torch.cuda.device_count()):
            dm = device_model(i)
            peak = ("" if dm.peaks is None else
                    f", published HBM {dm.peaks.hbm_bytes_per_s / 1e12:.2f} TB/s "
                    f"({dm.peaks.source})")
            print(f"device {i}: {dm.name}, {dm.sm_count} SMs, "
                  f"{dm.mem_bytes / 2**30:.1f} GiB, L2 {dm.l2_bytes} B, "
                  f"opt-in shared memory/block {dm.smem_per_block_optin} B{peak}")
    nvcc = Path(_build.nvcc())
    print(f"nvcc: {nvcc if nvcc.exists() else 'not found'} "
          f"(kernels build on first CUDA launch into {_build.BUILD_DIR})")
    print(f"native fastio: "
          f"{'available' if native_available() else 'unavailable (numpy fallback)'}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"run": cmd_run, "info": cmd_info}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
