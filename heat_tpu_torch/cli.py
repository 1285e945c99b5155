"""Command-line entry point: the ``program heat`` analog.

Keeps the reference's external contract: read ``input.dat`` from the
working directory, run the solve, write ``int.dat``/``soln.dat``, print the
familiar stdout lines ("simulation completed!!!!", timing) —
fortran/serial/heat.f90:11-13,50-55,73-83. The reference's build-time
variant choice becomes ``--backend`` / ``--variant``; ``SINGLE_PRECISION``
becomes ``--dtype``. Solves run on the card (``--device cuda``, the
default) unless ``--device cpu`` is given.

Usage: ``python -m heat_tpu_torch run [--backend cuda] [--json]``,
``python -m heat_tpu_torch serve --requests FILE.jsonl [--json]`` (the
serving engine: one ``<id>.npz`` per request with ``--out-dir``),
``python -m heat_tpu_torch launch -n N -- run --backend sharded ...`` (N
worker processes in one ``torch.distributed`` world, the reference's
``mpirun -np N``) and ``python -m heat_tpu_torch info``.
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


def _parse_mesh(s: str):
    try:
        dims = tuple(int(t) for t in s.lower().replace("x", " ").split())
    except ValueError:
        dims = ()
    if not dims or any(d < 1 for d in dims):
        raise argparse.ArgumentTypeError(
            f"mesh must be positive dims like '4x2', got {s!r}")
    return dims


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
    run.add_argument("--comm", choices=["direct", "staged"],
                     help="sharded halo exchange: device slabs sent "
                          "directly (CUDA-aware analog) or through host "
                          "memory (NO_AWARE analog)")
    run.add_argument("--exchange", choices=["seq", "indep", "overlap"],
                     help="halo exchange formulation: indep (seq, the "
                          "reference's other form with the same bytes, "
                          "runs it too), or overlap (the interior steps "
                          "while the halo flies, then the rim regions; "
                          "needs the stencil kernel)")
    run.add_argument("--mesh", type=_parse_mesh,
                     help="mesh of shards, e.g. 2x2 (sharded backend)")
    run.add_argument("--virtual-devices", type=int, metavar="N",
                     help="run N shards in this process on --device "
                          "(shard i on cuda:(i %% device_count)); the "
                          "single-process form of 'mpirun -np N'")
    run.add_argument("--local-kernel", choices=["auto", "torch", "cuda"],
                     help="sharded per-shard stepping: the stencil kernel "
                          "(cuda), the plain PyTorch step (torch), or auto "
                          "(the kernel on the card where one applies)")
    run.add_argument("--parity-order", action="store_true",
                     help="literal update-then-swap step ordering "
                          "(reference parity, mpi+cuda/heat.F90:206-219)")
    run.add_argument("--fuse-steps", type=int,
                     help="temporal blocking depth: steps per kernel call, "
                          "or per halo exchange when sharded (0=auto, 1=off)")
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

    serve = sub.add_parser(
        "serve",
        help="serving engine: drain a JSONL file of solve requests as "
             "continuously-batched stacked lanes on the card")
    serve.add_argument("--requests", metavar="FILE.jsonl", required=True,
                       help="JSON Lines: one request object per line, keys "
                            "= HeatConfig physics fields (n, ntime, sigma, "
                            "nu, dom_len, ndim, dtype, ic, bc, bc_value) + "
                            "optional id, deadline_ms, tenant, class; '#' "
                            "lines are comments")
    serve.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="where the lanes live (default cuda)")
    serve.add_argument("--lanes", type=int, default=4,
                       help="max concurrent requests per bucket group "
                            "(default 4)")
    serve.add_argument("--chunk", type=int, default=16,
                       help="steps per chunk — the swap granularity of "
                            "continuous batching (default 16)")
    serve.add_argument("--buckets", default="256,512,1024",
                       help="comma-separated grid-side buckets; a request "
                            "is padded up to the smallest side that fits "
                            "(default 256,512,1024)")
    serve.add_argument("--dispatch-depth", default="on", metavar="on|off|N",
                       help="chunks kept in flight per bucket group: 'on' "
                            "(default) = 2; N >= 1 explicitly; 'off' = "
                            "fully synchronous fallback (fence every "
                            "boundary)")
    serve.add_argument("--out-dir", metavar="DIR",
                       help="write each result as DIR/<id>.npz (atomic "
                            "publish); default: results stay in memory")
    serve.add_argument("--serve-lane-kernel", dest="serve_lane_kernel",
                       choices=["auto", "cuda", "torch"], default="auto",
                       help="chunk body per bucket: 'auto' (default) = the "
                            "hand-written lane kernels on the card wherever "
                            "the bucket has one (f32/bf16), the plain "
                            "PyTorch lane step elsewhere; 'cuda'/'torch' "
                            "force it (same bytes). An f64 bucket under "
                            "'cuda' degrades to torch as a structured "
                            "lane_kernel_fallback record, never an error")
    serve.add_argument("--serve-deadline", dest="serve_deadline",
                       type=float, metavar="MS",
                       help="engine-default per-request wall budget in ms "
                            "from submission (a request's own deadline_ms "
                            "overrides): over-deadline lanes are preempted "
                            "at their next chunk boundary, queued requests "
                            "past it are shed (default: no deadline)")
    serve.add_argument("--max-queue", dest="max_queue", type=int,
                       metavar="N",
                       help="admission bound: submits beyond N queued "
                            "requests are shed with a structured "
                            "'overloaded' rejection (default: unbounded)")
    serve.add_argument("--fetch-watchdog", dest="fetch_watchdog",
                       type=float, metavar="SECONDS", default=600.0,
                       help="boundary-fetch watchdog: a chunk-boundary wait "
                            "exceeding this fails that bucket group's "
                            "requests cleanly (default 600; 0 = off)")
    serve.add_argument("--policy", choices=["fifo", "edf", "fair"],
                       default="fifo",
                       help="admission ordering: fifo (default, submit "
                            "order), edf (SLO class, then earliest "
                            "deadline), fair (weighted fair share across "
                            "tenants)")
    serve.add_argument("--tenant-weights", dest="tenant_weights",
                       metavar="NAME=W,...",
                       help="fair-share weights per tenant (policy=fair); "
                            "unlisted tenants weigh 1.0")
    serve.add_argument("--tenant-quota", dest="tenant_quota", type=int,
                       metavar="N",
                       help="per-tenant admission sub-quota: one tenant may "
                            "hold at most N queued requests")
    serve.add_argument("--json", action="store_true",
                       help="also print the summary as one JSON line")

    launch = sub.add_parser(
        "launch",
        help="run N worker processes joined into one torch.distributed "
             "world on this machine (the reference's 'mpirun -np N', "
             "fortran/mpi+cuda/makefile:1-2)")
    launch.add_argument("-n", "--processes", type=int, default=2)
    launch.add_argument("--max-restarts", type=int, default=1, metavar="K",
                        help="after a worker dies, stop the world, validate "
                             "and quarantine the checkpoints, and relaunch "
                             "it to resume, up to K times with exponential "
                             "backoff (default 1; 0 disables). A failure "
                             "within 30 s with no checkpoint gets one more "
                             "try outside this budget")
    launch.add_argument("--deadline", type=float, metavar="S", default=3600.0,
                        help="wall-clock limit of each attempt in seconds; "
                             "at the deadline every worker is stopped and "
                             "launch exits 124, never restarted")
    launch.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="worker arguments, e.g.: -- run --backend "
                             "sharded --comm staged")

    sub.add_parser("info", help="show devices / kernel toolchain / "
                                "native-lib / process-group status")
    return p


def _apply_overrides(cfg: HeatConfig, args) -> HeatConfig:
    """Fold CLI flags into the config."""
    over = {}
    for field in ("backend", "dtype", "ic", "bc", "ndim", "fuse_steps",
                  "heartbeat_every", "checkpoint_every", "checkpoint_dir",
                  "async_io", "profile_dir", "write_int", "on_nan", "inject",
                  "comm", "exchange", "local_kernel"):
        v = getattr(args, field, None)
        if v is not None:
            over[field] = v
    if getattr(args, "bc_value", None) is not None:
        over["bc_value"] = args.bc_value
    if getattr(args, "mesh", None):
        over["mesh_shape"] = tuple(args.mesh)
    for flag in ("report_sum", "check_numerics", "soln", "parity_order"):
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
        if cfg.backend == "sharded":
            # join the world before any device work: the first act of the
            # reference's distributed variants (mpi_init + rank -> GPU
            # binding, fortran/mpi+cuda/heat.F90:60-70); a process started
            # alone joins nothing
            from .parallel.dist import init_distributed

            device = init_distributed(device, cfg.comm) or device
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    axes = coords(cfg)
    if cfg.write_int:
        from .io import write_int_dat

        write_int_dat("int.dat", axes, initial_condition(cfg))

    try:
        res = solve(cfg, device=device, virtual_devices=args.virtual_devices)
    except (NotImplementedError, ValueError) as e:  # a path later slices
        # bring, or a configuration the backend refuses
        print(f"error: {e}", file=sys.stderr)
        return 2
    for line in res.timing.report_lines():
        master_print(line)
    if res.gsum is not None:
        master_print(f"Sum of Temperature: {res.gsum:.10g}")

    if cfg.soln:
        _write_solution(args.out, axes, res)

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
        if res.mesh_shape is not None:
            rec.update(mesh=list(res.mesh_shape), comm=cfg.comm,
                       exchange=cfg.exchange, **res.exchange)
        master_print(json.dumps(rec))
    return 0


def _write_solution(out: str, axes, res) -> None:
    """soln.dat, and for a decomposed run the per-shard ``soln#####.dat``
    files (shard number = linear mesh index, the reference's per-rank
    contract, mpi+cuda/heat.F90:277-288): from the gathered field in a
    single process, each rank its own shard in a world of several."""
    from .io import write_soln, write_soln_blocks, write_soln_sharded

    outdir = Path(out).parent
    if res.mesh_shape and any(s > 1 for s in res.mesh_shape):
        field = res.T_dev
        if len(field.comm.ranks) < field.comm.mesh.size:
            from .backends.common import host_fetch

            files = write_soln_sharded(
                outdir, axes, [(rank, host_fetch(o)) for rank, o in
                               zip(field.comm.ranks, field.owned())],
                res.mesh_shape)
            print(f"[rank {field.comm.rank}] wrote {len(files)} shard "
                  f"file(s) ({files[0].name} .. {files[-1].name})",
                  file=sys.stderr)
        else:
            files = write_soln_blocks(outdir, axes, res.T, res.mesh_shape)
            master_print(f"wrote {len(files)} per-shard files "
                         f"({files[0].name} .. {files[-1].name})")
    if res.T is not None:
        write_soln(out, axes, res.T)
        master_print(f"wrote {out}")


def _serve_report(summary: dict, ok: int, args) -> None:
    """The end-of-serve report: the reference's lines for what the port
    serves, and the summary as JSON with --json."""
    failed = summary["requests"] - ok - summary.get("rejected", 0)
    master_print(f"served {summary['requests']} request(s): {ok} ok, "
                 f"{summary.get('rejected', 0)} rejected, {failed} failed "
                 f"(device {summary['device']}, {summary['compile_s']:.3f}s "
                 f"loading kernels)")
    passes = summary.get("lane_passes") or {}
    master_print(f"dispatch: depth {summary['dispatch_depth']}, "
                 f"policy {summary['policy']}, "
                 f"lane kernel {summary['lane_kernel']}"
                 + (f" ({summary['lane_kernel_fallbacks']} bucket tier(s) "
                    f"fell back to the torch lane step)"
                    if summary["lane_kernel_fallbacks"] else "")
                 + f", {summary['chunks_dispatched']} chunk(s) "
                 f"({summary['tail_chunks']} tail)"
                 + "".join(f", {v} {k} launch(es)" for k, v in
                           sorted(passes.items()))
                 + f", {summary['boundary_waits']} boundary wait(s) totaling "
                 f"{summary['boundary_wait_s']:.3f}s, est. device idle "
                 f"{summary['device_idle_s']:.3f}s")
    if any(summary[k] for k in ("lanes_quarantined", "deadline_misses",
                                "shed", "watchdog_fired")):
        master_print(f"fault domains: "
                     f"{summary['lanes_quarantined']} quarantined, "
                     f"{summary['deadline_misses']} deadline miss(es), "
                     f"{summary['shed']} shed, "
                     f"{summary['watchdog_fired']} watchdog timeout(s)")
    if args.json:
        master_print(json.dumps(summary, sort_keys=True))


def cmd_serve(args) -> int:
    """Drain a JSONL request file through the batched serving engine.

    Per-request structured records stream as JSON lines while lanes finish;
    the exit code is 0 only when every request served cleanly (a rejected
    or failed request is that request's record AND a nonzero exit)."""
    from .backends import resolve_device
    from .config import (parse_dispatch_depth, parse_tenant_weights)
    from .serve import ServeConfig, serve_requests

    path = Path(args.requests)
    if not path.exists():
        print(f"error: {path} not found", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card where one was asked for
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        buckets = tuple(int(b) for b in str(args.buckets).split(",") if b)
        scfg = ServeConfig(lanes=args.lanes, chunk=args.chunk,
                           buckets=buckets, out_dir=args.out_dir,
                           dispatch_depth=parse_dispatch_depth(
                               args.dispatch_depth),
                           lane_kernel=args.serve_lane_kernel,
                           deadline_ms=args.serve_deadline,
                           max_queue=args.max_queue,
                           fetch_timeout_s=(args.fetch_watchdog
                                            if args.fetch_watchdog else None),
                           policy=args.policy,
                           tenant_weights=parse_tenant_weights(
                               args.tenant_weights or ""),
                           tenant_quota=args.tenant_quota)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    records, summary = serve_requests(path, scfg, device=device)
    ok = sum(1 for r in records if r["status"] == "ok")
    _serve_report(summary, ok, args)
    return 0 if ok == summary["requests"] else 1


def _launch_ckpt_dir(cmd) -> Optional[str]:
    """The workers' checkpoint directory as the supervisor sees it, or
    None when they write no checkpoints."""
    if "--checkpoint-every" not in cmd and "--checkpoint-dir" not in cmd:
        return None
    if "--checkpoint-dir" in cmd:
        i = cmd.index("--checkpoint-dir")
        if i + 1 < len(cmd):
            return cmd[i + 1]
    return HeatConfig.checkpoint_dir


def cmd_launch(args) -> int:
    """Spawn N local workers joined into one ``torch.distributed`` world:
    torchrun (``torch.distributed.run --standalone``) run in this process,
    with a deadline per attempt, under a restart supervisor.

    Each worker runs the same command (SPMD) with the torchrun variables
    (the rendezvous of MPI_Init, fortran/mpi+cuda/heat.F90:60-62); rank 0
    alone prints results. When a worker dies torchrun stops the others (a
    peer blocked in a collective never returns). The supervisor then
    validates the checkpoint directory (``checkpoint.scan_resume_step``,
    which quarantines corrupt files) and relaunches the world to resume,
    up to ``--max-restarts`` times with exponential backoff, printing a
    ``launch: restart {json}`` record per attempt; the workers get
    ``HEAT_TPU_RESTART=<attempt>``, so restart-gated injected faults do not
    fire again. Each attempt is one torchrun with ``--max-restarts=0``:
    torchrun's own restarts would skip the quarantine and the records. A
    deadline (rc 124) is a budget, never restarted; otherwise the last
    attempt's failed worker's exit code is launch's.
    """
    import os
    import signal
    import time

    from torch.distributed.elastic.multiprocessing.errors import \
        ChildFailedError
    from torch.distributed.run import parse_args, run

    from .runtime import checkpoint
    from .runtime.faults import RESTART_ENV_VAR

    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("launch: missing worker arguments (e.g. "
              "`heat_tpu_torch launch -n 2 -- run --backend sharded`)",
              file=sys.stderr)
        return 2
    if args.processes < 1:
        print("launch: -n must be >= 1", file=sys.stderr)
        return 2
    ckpt_dir = _launch_ckpt_dir(cmd)

    class Deadline(Exception):
        pass

    def expire(*_):
        raise Deadline

    def attempt(restart: int):
        """One torchrun world: (rc, elapsed_s, reason)."""
        os.environ[RESTART_ENV_VAR] = str(restart)
        t0 = time.monotonic()
        # the exception unwinds torchrun's agent, whose shutdown stops the
        # workers
        old = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, args.deadline)
        try:
            run(parse_args(["--standalone",
                            f"--nproc-per-node={args.processes}",
                            "--max-restarts=0", "--monitor-interval=0.1",
                            "-m", "heat_tpu_torch", *cmd]))
            return 0, time.monotonic() - t0, None
        except Deadline:
            print(f"launch: deadline {args.deadline:g}s exceeded, the "
                  f"workers were stopped", file=sys.stderr)
            return 124, time.monotonic() - t0, "deadline"
        except ChildFailedError as e:
            rank, failure = e.get_first_failure()
            reason = f"worker {rank} exited rc={failure.exitcode}"
            print(f"launch: {reason}", file=sys.stderr)
            return (failure.exitcode if failure.exitcode > 0 else 1,
                    time.monotonic() - t0, reason)
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    # the workers' environment, set once: they import this package even
    # where it is only on the launcher's path; restored on return
    saved = dict(os.environ)
    root = str(Path(__file__).resolve().parent.parent)
    os.environ["PYTHONPATH"] = root + os.pathsep + saved.get("PYTHONPATH", "")
    backoff_base = float(os.environ.get("HEAT_TPU_RESTART_BACKOFF_S", "0.5"))
    restarts = 0
    startup_retry_used = False
    try:
        while True:
            rc, elapsed, reason = attempt(restarts)
            if rc == 0 or reason == "deadline":
                return rc
            resume_step = (checkpoint.scan_resume_step(
                ckpt_dir, nprocs=args.processes) if ckpt_dir else None)
            if resume_step is None and elapsed < 30 and not startup_retry_used:
                # a start-up failure (a port race, the environment): one
                # clean retry on a fresh port, outside the budget
                startup_retry_used = True
                print("launch: startup failure, retrying once on a fresh "
                      "port", file=sys.stderr)
                continue
            if restarts >= args.max_restarts:
                if args.max_restarts > 0:
                    print(f"launch: giving up after {restarts} restart(s) "
                          f"(--max-restarts {args.max_restarts})",
                          file=sys.stderr)
                return rc
            restarts += 1
            backoff = min(backoff_base * 2 ** (restarts - 1), 30.0)
            rec = {"event": "launch_restart", "attempt": restarts,
                   "max_restarts": args.max_restarts, "reason": reason,
                   "rc": rc, "elapsed_s": round(elapsed, 3),
                   "resume_step": resume_step, "backoff_s": backoff}
            print("launch: restart " + json.dumps(rec), file=sys.stderr,
                  flush=True)
            time.sleep(backoff)
    finally:
        os.environ.clear()
        os.environ.update(saved)


def cmd_info(_args) -> int:
    import torch

    from .io.native import native_available
    from .ops import _build
    from .parallel.dist import describe

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
          f"(kernels {', '.join(_build.KERNELS)} build on first CUDA launch "
          f"into {_build.build_dir()})")
    print(f"native fastio: "
          f"{'available' if native_available() else 'unavailable (numpy fallback)'}")
    print(describe())
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"run": cmd_run, "serve": cmd_serve, "launch": cmd_launch,
            "info": cmd_info}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
