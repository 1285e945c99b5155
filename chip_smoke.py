#!/usr/bin/env python3
"""On-card smoke test of heat_tpu_torch: builds the CUDA kernels, holds them
against their plain PyTorch versions byte for byte, drives the ``run`` path
at the shipped sizes in 2D and 3D, the ``serve`` path and the kernel lab,
and checks the answer against the serial oracle.

Usage, from the repository root on a host with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without a card, or outside
a checkout of the repository, it exits non-zero and prints no result):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, the
   kernel builds (``nvcc`` for sm_90a, one process per source, started
   together) and their ptxas register reports;
2. each kernel against its plain version on the card, bytes compared, all
   through the public wrappers (so in the reference's pass schedule) unless
   a single pass is named:
   ``ftcs2d`` — 67x130, 1000x4099 and 4096^2 under edges/ghost/periodic,
   f32/bf16, k in {1, 7, 16}, r in {0.25, 0.2}; one 16-step 32768^2 pass in
   f32 and bf16; single passes of k in {17, 32} at 67x130 and 4096^2;
   ``ftcs3d`` — 24x20x130, 67x45x129 and 256^3 under edges/ghost/periodic,
   f32/bf16, k in {1, 4, 8}, r in {1/6, 0.15}; single 512^3 passes (f32
   k=8, bf16 k=4) and a 1024^3 f32 k=5 pass;
   then per-pass times of kernel and plain version at the main path's
   shapes and depths, and of the 4096^2 k=32 and 512^3 f32 k=4 passes;
   the lane kernels ``lanes2d`` (2D buckets 12, 256, 1024) and ``lanes3d``
   (3D buckets 8, 64, 256) through ``cuda_lanes.lane_multistep`` against
   ``plain=True``: f32/bf16, edges/ghost, k in {1, 5, 16, 37}, 4 lanes with
   their own r (one with n < B, one whose countdown ends inside the chunk,
   one with none left, one with a NaN in its centre): fields and finite bits
   byte-equal, resid/tmin/tmax equal on finite lanes, heat within a relative
   1e-5; then one serving chunk of 8 lanes timed at the main path's buckets;
3. the main path, ``heat_tpu_torch.cli.main(["run", "--backend", "cuda",
   "--json", ...])`` (what ``python -m heat_tpu_torch run`` calls) with the
   launch counts zeroed just before and read just after:
   2D — 4096^2 f32 for 8192 steps (the python/cuda benchmark shape),
   32768^2 in f32 and bf16 (the hip.dat size, ntime cut to 256), each run's
   global sum equal to that of the plain version run in the same passes;
   3D (``--ndim 3``) — 512^3 f32 for 3200 steps at sigma 1/6 (the
   reference's config 4, benchmarks/run_all.py:190-192, at full size),
   512^3 bf16 for 3200 steps, 1024^3 f32 (4 GiB per field) for 160 steps;
   each also run for fewer steps (64 at 512^3, 32 at 1024^3) and that
   run's global sum held equal to the plain version's over the same passes;
   the 512^3 f32 field after 3200 steps held bit for bit against the plain
   version's over the same 3200 steps, and against the ``torch`` backend's
   on the card (the serial oracle's f32 arithmetic: same order, two
   roundings) at the reference's f32 tolerance scaled by steps (5e-6 per
   30 steps);
4. configs/serial.dat (1024^2, 30 steps) on ``cuda`` in f32, and a 64^3 f32
   solve at sigma 0.15 under edges and ghost BC for 50 steps, each written
   to soln.dat and read back, against the serial numpy oracle at the
   reference's f32 cross-backend tolerance (atol 5e-6,
   tests/test_backends.py);
5. the serve main path, ``heat_tpu_torch.cli.main(["serve", "--requests",
   F, "--out-dir", D, "--json", "--lanes", "8", "--chunk", "16",
   "--buckets", "256,512,1024"])`` with the lane launch counts zeroed just
   before and read just after; F holds 56 requests from
   ``numpy.random.default_rng(0)``: 40 2D f32 (sides 128-1024, ntime
   1000-8000 and not a multiple of 16), 8 bf16 twins of f32 requests, 8 3D
   f32 (sides 64-256, ntime 100-800); sigma per request, edges and ghost BC
   in turn, four initial conditions. Every record ok; the lane launches
   equal the passes of the dispatched chunks; no lane-kernel fallback;
   served a second time under ``torch.profiler``, every record ok and the
   npz files byte-equal to the first run's (the card's busy time by kernel
   is a measurement: "not measured" where the profiler fails or sees no
   device time); served a third time with ``--serve-lane-kernel torch``
   (the plain versions, on the card), byte-equal npz files; six small f32
   requests against the serial oracle (5e-6 per 30 steps); every field in
   the maximum principle's [1, 2] envelope. Prints the served cell-steps
   per second, the chunks, the tail chunks, the boundary wait and the
   launches by bucket, and each bf16 twin's mean gap from its f32 request
   beside the gaps that a wrong sigma or initial condition makes in f32
   (a measurement: bf16 lanes round every step and stagnate, see
   phase_serve);
6. the kernel lab's candidates L1-L5 (``lab2d``, ``lab3d``): every
   (kernel, variant, dtype) against its plain version on the card, bytes,
   at the JAX lab's check shapes, depths 1 and the deepest its TPU geometry
   takes, on both compiled Hopper tiles, with bounds narrower than the
   field, and with a NaN planted in an interior cell (the same NaN cells,
   the same bytes elsewhere); at the shipped tile, the K1-form instances
   against ``ftcs2d`` and L1 against ``ftcs3d`` on the same inputs (one
   kernel body each, ``stencil2d.cuh`` / ``stencil3d.cuh``); then the
   lab's main path,
   ``heat_tpu_torch.labs.kernel_lab.main`` (what ``python -m
   heat_tpu_torch.labs.kernel_lab`` calls) with the lab launch counts
   zeroed just before and read just after: every ``check*`` experiment,
   then one bench per kernel and variant at full size (L1/L2 512^3 f32
   k=8, L3 16384^2 bf16 k=16, L4/L5 32768^2 bf16 k=16), each row's plain
   version timed once at its shape and held to the kernel's bytes. Prints
   each row's ms per pass, its bound, the plain version's ms and the
   shipped kernel's ms at the same shape, dtype and depth.

The last two lines: the ``nvidia-smi`` line is printed before a JSON
object with one entry per kernel and main-path shape, and the very last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke"          # scratch for input.dat / soln.dat (gitignored)
SOURCES = {name: f"heat_tpu_torch/ops/csrc/{name}.cu"
           for name in ("ftcs2d", "ftcs3d", "lanes2d", "lanes3d", "lab2d",
                        "lab3d")}
K1 = "heat_tpu/ops/pallas_stencil.py:256"   # _pallas_2d
K2 = "heat_tpu/ops/pallas_stencil.py:633"   # _pallas_2d_coltiled
K3 = "heat_tpu/ops/pallas_stencil.py:489"   # _pallas_3d_aligned
K4 = "heat_tpu/ops/pallas_stencil.py:1115"  # _lane_pallas_2d
K5 = "heat_tpu/ops/pallas_stencil.py:1279"  # _lane_pallas_3d
# the kernel lab's Pallas kernels L1-L5, by the port's function name
LAB = "benchmarks/kernel_lab.py"
L_REPLACES = {"lab_3d_tiled": f"{LAB}:171",            # pallas_3d_tiled
              "lab_3d_rolled": f"{LAB}:279",           # pallas_3d_rolled
              "lab_thin2d_variant": f"{LAB}:474",      # pallas_thin2d_variant
              "lab_2d_coltiled": f"{LAB}:628",         # pallas_2d_coltiled
              "lab_2d_coltiled_rolled": f"{LAB}:744"}  # ..._coltiled_rolled
# phase 6: the lab's experiments, driven through its entry point: every
# check, then one bench per kernel and variant at full size (tune_on_chip's
# lab3d / thin / lab2d shapes), at the shipped kernels' tile and depth
LAB_BENCHES = (
    ["bench3d", "16,16,32,8"],
    ["bench3d_rolled_var", "f32", "16,16,32,8"],
    ["bench3d_rolled_var", "fma", "16,16,32,8"],
    ["benchthin", "16384", "bfloat16", "shrink,64,96,16", "rolled,64,96,16",
     "rolledfma,64,96,16", "bf16native,64,96,16"],
    ["bench2d", "64,96,16"],
    *(["bench2d_rolled_var", v, "64,96,16"]
      for v in ("f32", "fma", "bf16native", "bf16fma")),
)
# the reference's CostEstimate counts of operations per lane cell-step
# (pallas_stencil.py:1156 and :1310), for a second bound beside the kernels'
# own count (machine.py: 7 / 9 f32 operations per live cell-step)
LANE_COST_ESTIMATE_OPS = {2: 11, 3: 13}
LANE_R = {2: (0.25, 0.2, 0.1), 3: (1 / 6, 0.15, 0.1)}
# phase 5: the serve main path's engine knobs
SERVE_ARGS = ("--lanes", "8", "--chunk", "16", "--buckets", "256,512,1024")
F32_ATOL = 5e-6                 # tests/test_backends.py:33
SIGMA_3D = 1 / 6                # benchmarks/run_all.py:192
ENVELOPE_TOL = 1e-5             # phase 5: rounding past the [1, 2] envelope
ICS = ("hat", "hat_small", "hat_half", "uniform")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bits(t):
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def field(shape, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (1.0 + torch.rand(shape, generator=g, device="cuda")).to(dtype)


def event_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, CUDA events,
    after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def dt_name(dtype) -> str:
    return str(dtype).replace("torch.", "").replace("float32", "f32").replace(
        "bfloat16", "bf16")


def full_bounds(shape) -> tuple:
    return tuple(v for s in shape for v in (0, s - 1))


# --------------------------------------------------------------------------


def phase_build():
    import torch

    from heat_tpu_torch.ops import _build

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    print(f"[phase 1] {', '.join(_build.KERNELS)} built for sm_90a in "
          f"{time.perf_counter() - t0:.3f} s (one nvcc each, in parallel)")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())


def phase_compare():
    """Kernel vs plain version, bytes. Returns max |err| per (kernel,
    shape)."""
    import torch

    from heat_tpu_torch.ops import cuda_stencil as cs

    def wrapper(bc, T, r, k, plain):
        if bc == "edges":
            return cs.ftcs_multistep_edges_cuda(T, r, k, plain=plain)
        if bc == "ghost":
            return cs.ftcs_multistep_ghost_cuda(T, r, 1.0, k, plain=plain)
        if bc == "periodic":
            return cs.ftcs_multistep_periodic_cuda(T, r, k, plain=plain)
        # "pass": one kernel pass of exactly k steps, default bounds
        return cs._pass(T, r, k, full_bounds(T.shape), plain=plain)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(shape, bc, dt, k, r)
             for shape in ((67, 130), (1000, 4099), (4096, 4096))
             for bc in ("edges", "ghost", "periodic")
             for dt in (f32, bf16) for k in (1, 7, 16) for r in (0.25, 0.2)]
    cases += [((32768, 32768), "edges", dt, 16, 0.2) for dt in (f32, bf16)]
    cases += [(shape, "pass", dt, k, 0.2) for shape in ((67, 130), (4096, 4096))
              for dt in (f32, bf16) for k in (17, 32)]
    cases += [(shape, bc, dt, k, r)
              for shape in ((24, 20, 130), (67, 45, 129), (256, 256, 256))
              for bc in ("edges", "ghost", "periodic")
              for dt in (f32, bf16) for k in (1, 4, 8) for r in (1 / 6, 0.15)]
    cases += [((512,) * 3, "pass", f32, 8, SIGMA_3D),
              ((512,) * 3, "pass", bf16, 4, SIGMA_3D),
              ((1024,) * 3, "pass", f32, 5, SIGMA_3D)]
    errs = {}
    t0 = time.perf_counter()
    for i, (shape, bc, dt, k, r) in enumerate(cases):
        T = field(shape, dt, seed=i)
        got = wrapper(bc, T, r, k, plain=False)
        want = wrapper(bc, T, r, k, plain=True)
        torch.cuda.synchronize()
        ndiff = int((bits(got) != bits(want)).sum())
        err = float((got.float() - want.float()).abs().max())
        key = (cs._KERNELS[len(shape)], shape)
        errs[key] = max(errs.get(key, 0.0), err)
        if shape[0] >= 4096 or len(shape) == 3 and shape[0] >= 256 or ndiff:
            print(f"  {key[0]} {shape} {bc} {dt_name(dt)} k={k} r={r:.6g}: "
                  f"{ndiff} cells differ, max|err| {err:g}")
        check(ndiff == 0, f"kernel != plain at {shape} {bc} {dt} k={k} r={r}")
        del T, got, want
        torch.cuda.empty_cache()
    print(f"[phase 2] {len(cases)} kernel-vs-plain cases, 0 differing bytes "
          f"({time.perf_counter() - t0:.1f} s)")
    return errs


def phase_times():
    """ms per pass at the main path's shapes and depths: kernel (mean of
    many launches) and plain version; the bound from machine.py."""
    import torch

    from heat_tpu_torch.machine import device_model
    from heat_tpu_torch.ops import cuda_stencil as cs

    dm = device_model(0)
    f32, bf16 = torch.float32, torch.bfloat16
    times = {}
    for shape, dt, k, reps, plain_reps in (
            ((4096, 4096), f32, 16, 200, 3), ((4096, 4096), bf16, 16, 200, 3),
            ((32768, 32768), f32, 16, 10, 1), ((32768, 32768), bf16, 16, 10, 1),
            ((4096, 4096), f32, 32, 100, 1), ((4096, 4096), bf16, 32, 100, 1),
            ((512,) * 3, f32, 8, 20, 1), ((512,) * 3, bf16, 4, 20, 1),
            ((512,) * 3, f32, 4, 20, 1), ((1024,) * 3, f32, 5, 10, 1)):
        A = field(shape, dt, seed=1)
        B = torch.empty_like(A)
        bounds = full_bounds(shape)
        r = 0.25 if len(shape) == 2 else SIGMA_3D
        ms = event_ms(lambda: cs._launch(A, r, k, bounds, B), reps)
        plain_ms = event_ms(lambda: cs._PLAIN[len(shape)](A, r, k), plain_reps)
        bound_s, bound_by = dm.pass_bound_s(A.numel(), A.element_size(), k,
                                            ndim=len(shape))
        name = cs._KERNELS[len(shape)]
        times[(name, shape, dt, k)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3, bound_by=bound_by)
        print(f"  {name} {'x'.join(map(str, shape))} {dt_name(dt)} k={k}: "
              f"{ms:.4f} ms/pass (plain {plain_ms:.2f} ms, bound "
              f"{bound_s * 1e3:.4f} ms by {bound_by}, {bound_s * 1e3 / ms:.1%} "
              f"of it)")
        del A, B
        torch.cuda.empty_cache()
    print("[phase 2] times taken")
    return times


def cli_run(input_dat: str, *args):
    """One ``run --backend cuda`` through the CLI entry point in WORK, with
    ``input_dat`` as its input.dat; the launch counts zeroed just before and
    read just after. Returns (stdout, launches)."""
    from heat_tpu_torch import cli
    from heat_tpu_torch.ops import cuda_stencil as cs

    (WORK / "input.dat").write_text(input_dat)
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(WORK)
    try:
        cs.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", "--backend", "cuda", *args])
        launches = dict(cs.launches)
    finally:
        os.chdir(cwd)
    out = buf.getvalue()
    print("".join(f"    | {line}\n" for line in out.splitlines()), end="")
    check(rc == 0, f"run exited {rc}")
    return out, launches


def expected_launches(shape, dtype: str, ntime: int) -> tuple:
    """(timed, warm-up) launches of one run with no heartbeat: ntime // 16
    multistep calls of 16 steps, each cut into the reference's passes, and
    ntime % 16 one-step launches; the warm-up makes each distinct call
    once."""
    from heat_tpu_torch.ops import pass_schedule

    per_call = len(pass_schedule.passes(shape, dtype, 16))
    n_fused, rem = divmod(ntime, 16)
    return n_fused * per_call + rem, per_call + (1 if rem else 0)


def plain_gsum(n, ndim, sigma, nu, dom_len, ntime, dtype) -> float:
    """Global sum (f64, on the host, as the run reports it) of the plain
    version run in 16-step calls from the run's initial field."""
    import numpy as np
    import torch

    from heat_tpu_torch import HeatConfig
    from heat_tpu_torch.backends.common import host_fetch
    from heat_tpu_torch.grid import initial_condition_device
    from heat_tpu_torch.ops.cuda_stencil import ftcs_multistep_edges_cuda

    cfg = HeatConfig(n=n, ndim=ndim, sigma=sigma, nu=nu, dom_len=dom_len,
                     ntime=ntime, dtype=dtype)
    T = initial_condition_device(cfg, "cuda")
    for _ in range(ntime // 16):
        T = ftcs_multistep_edges_cuda(T, cfg.r, 16, plain=True)
    ref = float(np.sum(np.asarray(host_fetch(T), np.float64)))
    del T
    torch.cuda.empty_cache()
    return ref


def main_path_run(key, n, ndim, sigma, nu, dom_len, ntime, dtype, smi):
    """One timed main-path run; checks kernel, launches and finiteness."""
    import torch

    name = "ftcs2d" if ndim == 2 else "ftcs3d"
    print(f"[phase 3] run --backend cuda --ndim {ndim}, {n}^{ndim} {dtype}, "
          f"{ntime} steps")
    out, launches = cli_run(f"{n} {sigma!r} {nu} {dom_len} {ntime}\n", "--json",
                            "--ndim", str(ndim), "--dtype", dtype,
                            "--report-sum")
    rec = json.loads(out.strip().splitlines()[-1])
    check(rec["launches"] == launches, "launch count mismatch")
    timed, warm = expected_launches((n,) * ndim, dtype, ntime)
    check(rec["kernel"] == f"cuda {name}", f"kernel {rec['kernel']}")
    check(launches[name] == timed + warm,
          f"{launches[name]} {name} launches, expected {timed + warm}")
    check(rec["gsum"] is not None and rec["gsum"] == rec["gsum"]
          and abs(rec["gsum"]) < float("inf"), "non-finite field")
    print(f"  {key}: {rec['points_per_s']:.6g} points/s, "
          f"{rec['per_step_s'] * 1e3:.6f} ms/step, {launches[name]} {name} "
          f"launches ({timed} timed + {warm} warm-up) on {smi}")
    torch.cuda.empty_cache()
    return rec


def phase_main_path(smi):
    import numpy as np
    import torch

    from heat_tpu_torch import HeatConfig, solve
    from heat_tpu_torch.grid import initial_condition_device
    from heat_tpu_torch.ops.cuda_stencil import ftcs_multistep_edges_cuda

    runs = {}
    # bench.py's shape (the python/cuda benchmark) and configs/hip.dat's;
    # each run's field against the plain version run in the same passes
    # from the same initial field: the global sums must be equal
    specs2 = {"4096 f32": (4096, 0.25, 0.05, 2.0, 8192, "float32"),
              "32768 f32": (32768, 0.25, 0.05, 1.0, 256, "float32"),
              "32768 bf16": (32768, 0.25, 0.05, 1.0, 256, "bfloat16")}
    for key, spec in specs2.items():
        runs[key] = main_path_run(key, spec[0], 2, *spec[1:], smi)
    for key, (n, sigma, nu, dom_len, ntime, dtype) in specs2.items():
        ref = plain_gsum(n, 2, sigma, nu, dom_len, ntime, dtype)
        got = runs[key]["gsum"]
        print(f"  {key}: gsum {got!r}, plain version {ref!r}")
        check(got == ref, f"{key}: main path's field is not the plain version's")
    # bf16 vs f32 at the same size: the reference's bf16 bound (atol 3e-2
    # per cell, tests/test_backends.py:43) bounds the mean
    diff = abs(runs["32768 bf16"]["gsum"] - runs["32768 f32"]["gsum"]) / 32768**2
    print(f"  32768 bf16 vs f32: mean |dT| bound {diff:.3g}")
    check(diff < 3e-2, "bf16 run drifted from f32")

    # 3D: the reference's config 4 at full size, in f32 and bf16, and
    # 1024^3 f32 with ntime cut to 160; (n, ..., ntime, dtype, steps of the
    # shorter run compared with the plain version)
    specs3 = {"512^3 f32": (512, SIGMA_3D, 0.05, 2.0, 3200, "float32", 64),
              "512^3 bf16": (512, SIGMA_3D, 0.05, 2.0, 3200, "bfloat16", 64),
              "1024^3 f32": (1024, SIGMA_3D, 0.05, 2.0, 160, "float32", 32)}
    for key, (n, sigma, nu, dom_len, ntime, dtype, ncmp) in specs3.items():
        runs[key] = main_path_run(key, n, 3, sigma, nu, dom_len, ntime, dtype,
                                  smi)
        short = main_path_run(f"{key} x{ncmp}", n, 3, sigma, nu, dom_len, ncmp,
                              dtype, smi)
        ref = plain_gsum(n, 3, sigma, nu, dom_len, ncmp, dtype)
        print(f"  {key} x{ncmp}: gsum {short['gsum']!r}, plain version {ref!r}")
        check(short["gsum"] == ref,
              f"{key}: main path's field is not the plain version's")
    diff = abs(runs["512^3 bf16"]["gsum"] - runs["512^3 f32"]["gsum"]) / 512**3
    print(f"  512^3 bf16 vs f32: mean |dT| bound {diff:.3g}")
    check(diff < 3e-2, "bf16 run drifted from f32")

    # the config-4 run in full: its field after 3200 steps equals, bit for
    # bit, the plain version's run in the same passes; and against the
    # torch backend (the serial oracle's f32 arithmetic: the same order,
    # two roundings per step, where the kernel rounds the update and
    # s - 6c once) it stays inside the reference's f32 tolerance of 5e-6
    # per 30 steps, scaled to 3200 steps: the two forms differ by under an
    # ulp per step and an FTCS step at r <= 1/6 does not grow a max-norm
    # difference
    cfg = HeatConfig(n=512, ndim=3, sigma=SIGMA_3D, nu=0.05, dom_len=2.0,
                     ntime=3200, dtype="float32")
    got = solve(cfg.with_(backend="cuda"), device="cuda")
    check(got.timing.kernel == "cuda ftcs3d", f"kernel {got.timing.kernel}")
    gsum = float(np.sum(np.asarray(got.T, np.float64)))
    check(gsum == runs["512^3 f32"]["gsum"], "solve() and run disagree")
    T = initial_condition_device(cfg, "cuda")
    for _ in range(cfg.ntime // 16):
        T = ftcs_multistep_edges_cuda(T, cfg.r, 16, plain=True)
    ndiff = int((bits(got.T_dev) != bits(T)).sum())
    print(f"  512^3 f32 x3200 vs the plain version in the same passes: "
          f"{ndiff} cells differ")
    check(ndiff == 0, "512^3 x3200 field is not the plain version's")
    del T
    oracle = solve(cfg.with_(backend="torch"), device="cuda").T
    check(np.isfinite(got.T).all() and got.T.shape == oracle.shape,
          "bad 512^3 field")
    err = float(np.abs(got.T - oracle).max())
    atol = F32_ATOL * cfg.ntime / 30
    runs["512^3 f32"]["oracle_err"] = err
    print(f"  512^3 f32 x3200 vs the torch step (serial oracle arithmetic): "
          f"max|err| {err:g} (atol {atol:g} = 5e-6 per 30 steps)")
    check(err <= atol, "512^3 cuda solve off the oracle")
    del got, oracle
    torch.cuda.empty_cache()
    return runs


def phase_oracle():
    import numpy as np

    from heat_tpu_torch import HeatConfig, parse_input, solve
    from heat_tpu_torch.io import read_dat

    src = ROOT / "configs" / "serial.dat"
    cfg = parse_input(src)
    print(f"[phase 4] configs/serial.dat ({cfg.n}^2, {cfg.ntime} steps) on cuda f32")
    _, launches = cli_run(src.read_text(), "--dtype", "float32", "--soln",
                          "--out", "soln.dat")
    check(launches["ftcs2d"] == 1 + 14 + 2,
          f"{launches['ftcs2d']} launches, expected 17")
    _, got = read_dat(WORK / "soln.dat")
    oracle = solve(cfg.with_(backend="serial", dtype="float32")).T
    check(got.shape == oracle.shape and np.isfinite(got).all(), "bad soln.dat")
    err = float(np.abs(got - oracle).max())
    print(f"  soln.dat vs serial oracle: max|err| {err:g} (atol {F32_ATOL:g})")
    check(err <= F32_ATOL, "cuda solve off the serial oracle")
    errs = {"serial.dat": err}
    for bc in ("edges", "ghost"):
        cfg = HeatConfig(n=64, ndim=3, sigma=0.15, nu=0.05, dom_len=2.0,
                         ntime=50, dtype="float32", bc=bc)
        print(f"[phase 4] 64^3 f32, sigma 0.15, {bc} BC, 50 steps on cuda")
        _, launches = cli_run("64 0.15 0.05 2.0 50\n", "--ndim", "3", "--bc",
                              bc, "--dtype", "float32", "--soln", "--out",
                              "soln.dat")
        check(launches["ftcs3d"] > 0, "no ftcs3d launch")
        _, got = read_dat(WORK / "soln.dat", ndim=3)
        oracle = solve(cfg.with_(backend="serial")).T
        check(got.shape == oracle.shape and np.isfinite(got).all(),
              "bad soln.dat")
        err = float(np.abs(got - oracle).max())
        print(f"  soln.dat vs serial oracle: max|err| {err:g} "
              f"(atol {F32_ATOL:g}), {launches['ftcs3d']} ftcs3d launches")
        check(err <= F32_ATOL, f"3D {bc} cuda solve off the serial oracle")
        errs[f"64^3 {bc}"] = err
    return errs


def lane_case(nd, B, dtype, k, seed):
    """One phase-2 lane case on the card: (fields, r, n, rem) of 4 lanes."""
    import torch

    L = 4
    m = B + 2
    f = field((L,) + (m,) * nd, dtype, seed)
    f[(3,) + (1 + B // 2,) * nd] = float("nan")
    dev = f.device
    n = torch.tensor([B - 3, B, B, B], dtype=torch.int32, device=dev)
    rem = torch.tensor([k + 3, k // 2 if k > 1 else 0, 0, k + 1],
                       dtype=torch.int32, device=dev)
    r = torch.tensor(LANE_R[nd] + LANE_R[nd][:1], dtype=torch.float32,
                     device=dev)
    return f, r, n, rem


def phase_lane_compare():
    """lanes2d/lanes3d against their plain versions, bytes. Returns max
    |err| per (kernel, bucket)."""
    import torch

    from heat_tpu_torch.ops import cuda_lanes as cl

    errs = {}
    t0 = time.perf_counter()
    ncases = 0
    for nd, buckets in ((2, (12, 256, 1024)), (3, (8, 64, 256))):
        for B in buckets:
            for dt in (torch.float32, torch.bfloat16):
                for bc_lo in (0, 1):
                    for k in (1, 5, 16, 37):
                        f, r, n, rem = lane_case(nd, B, dt, k, seed=ncases)
                        got = cl.lane_multistep(f, r, n, rem, k, bc_lo)
                        want = cl.lane_multistep(f, r, n, rem, k, bc_lo,
                                                 plain=True)
                        torch.cuda.synchronize()
                        ndiff = int((bits(got[0]) != bits(want[0])).sum())
                        fin_ok = torch.equal(got[1], want[1])
                        ok = want[1]
                        st_ok = torch.equal(got[2][:3, ok], want[2][:3, ok])
                        heat = float(((got[2][3, ok] - want[2][3, ok]).abs()
                                      / want[2][3, ok].abs()).max())
                        g, w = got[0].float(), want[0].float()
                        both = torch.isfinite(g) & torch.isfinite(w)
                        err = float((g[both] - w[both]).abs().max())
                        key = (cl._KERNELS[nd], B)
                        errs[key] = max(errs.get(key, 0.0), err)
                        what = (f"{key[0]} B={B} {dt_name(dt)} "
                                f"{('ghost', 'edges')[bc_lo]} k={k}")
                        if ndiff or not (fin_ok and st_ok) or heat > 1e-5:
                            print(f"  {what}: {ndiff} cells differ, finite "
                                  f"{got[1].tolist()} vs {want[1].tolist()}, "
                                  f"stats equal {st_ok}, heat rel {heat:g}")
                        check(ndiff == 0, f"lane kernel != plain: {what}")
                        check(fin_ok, f"finite bits differ: {what}")
                        check(st_ok, f"resid/tmin/tmax differ: {what}")
                        check(heat <= 1e-5, f"heat off by {heat:g}: {what}")
                        ncases += 1
                        del f, got, want, g, w
            torch.cuda.empty_cache()
    print(f"[phase 2] {ncases} lane-kernel-vs-plain cases, 0 differing bytes, "
          f"stats equal, heat within 1e-5 ({time.perf_counter() - t0:.1f} s)")
    return errs


def phase_lane_times():
    """One serving chunk (``lane_chunk``: the stats init and the kernel
    passes) of 8 lanes at the main path's buckets: kernel and plain version,
    and the bound: the stack read and written once per pass against 7 (2D)
    or 9 (3D) f32 operations per live cell-step (every lane n = B under
    edges BC: (B-2)^nd live cells, each stepped k times); beside it the
    bound at the reference's CostEstimate count over every cell."""
    import torch

    from heat_tpu_torch.machine import device_model
    from heat_tpu_torch.ops import cuda_lanes as cl

    dm = device_model(0)
    f32, bf16 = torch.float32, torch.bfloat16
    times = {}
    L = 8
    for nd, B, dt, k, reps in ((2, 256, f32, 16, 200), (2, 512, f32, 16, 100),
                               (2, 1024, f32, 16, 50), (2, 1024, bf16, 16, 50),
                               (3, 256, f32, 1, 50), (3, 256, bf16, 1, 50)):
        m = B + 2
        A = field((L,) + (m,) * nd, dt, seed=B)
        S = torch.empty_like(A)
        dev = A.device
        n = torch.full((L,), B, dtype=torch.int32, device=dev)
        rem = torch.full((L,), 1 << 30, dtype=torch.int32, device=dev)
        rem_out = torch.empty_like(rem)
        r = torch.tensor((LANE_R[nd] * 3)[:L], dtype=torch.float32, device=dev)
        bnd = torch.empty((cl.K_BOUNDARY, L), dtype=torch.int32, device=dev)

        def chunk(plain):
            return cl.lane_chunk(A, S, r, n, rem, rem_out, bnd, k, 1,
                                 plain=plain)

        ms = event_ms(lambda: chunk(False), reps)
        plain_ms = event_ms(lambda: chunk(True), 1)
        bound_s, bound_by = dm.pass_bound_s(
            A.numel(), A.element_size(), k, ndim=nd,
            op_points=L * (B - 2) ** nd)
        bytes_s, _ = dm.pass_bound_s(A.numel(), A.element_size(), k,
                                     ndim=nd, op_points=0)
        ce_s = max(bytes_s, LANE_COST_ESTIMATE_OPS[nd] * A.numel() * k
                   / dm.peaks.f32_flops_per_s)
        name = cl._KERNELS[nd]
        times[(name, B, dt)] = dict(k=k, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_s * 1e3, bound_by=bound_by,
                                    cost_estimate_bound_ms=ce_s * 1e3)
        print(f"  {name} {L}x{m}^{nd} {dt_name(dt)} k={k}: {ms:.4f} ms/chunk "
              f"(plain {plain_ms:.2f} ms, bound {bound_s * 1e3:.4f} ms by "
              f"{bound_by}, {bound_s * 1e3 / ms:.1%} of it; at the "
              f"reference's CostEstimate count {ce_s * 1e3:.4f} ms)")
        del A, S
        torch.cuda.empty_cache()
    print("[phase 2] lane times taken")
    return times


def serve_population(path: Path) -> list:
    """Phase 5's requests, written to ``path`` as JSON lines; returns them."""
    import numpy as np

    rng = np.random.default_rng(0)
    ics = ICS

    def ntime(lo, hi):
        while True:
            t = int(rng.integers(lo, hi + 1))
            if t % 16:
                return t

    reqs = []
    for i in range(40):
        reqs.append(dict(id=f"f32-{i:02d}", n=int(rng.integers(128, 1025)),
                         ntime=ntime(1000, 8000), dtype="float32",
                         sigma=float(rng.choice(LANE_R[2])),
                         bc=("edges", "ghost")[i % 2], bc_value=1.0,
                         ic=ics[i % 4]))
    for i in range(8):        # bf16 twins of every fifth f32 request
        reqs.append(dict(reqs[5 * i], id=f"bf16-{i}", dtype="bfloat16"))
    for i in range(8):
        reqs.append(dict(id=f"3d-{i}", ndim=3, n=int(rng.integers(64, 257)),
                         ntime=ntime(100, 800), dtype="float32",
                         sigma=float(rng.choice(LANE_R[3])),
                         bc=("edges", "ghost")[i % 2], bc_value=1.0,
                         ic=ics[i % 4]))
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    return reqs


def cli_serve(reqfile: Path, out_dir: Path, *extra):
    """One ``serve`` through the CLI entry point, the lane launch counts
    zeroed just before and read just after. Returns (rc, records, summary,
    launches by kernel, wall seconds)."""
    from heat_tpu_torch import cli
    from heat_tpu_torch.ops import cuda_lanes as cl

    buf = io.StringIO()
    cl.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve", "--requests", str(reqfile), "--out-dir",
                       str(out_dir), "--json", *SERVE_ARGS, *extra])
    wall = time.perf_counter() - t0
    launches = dict(cl.launches)
    lines = buf.getvalue().splitlines()
    records = [json.loads(x) for x in lines if x.startswith("{")
               and json.loads(x).get("event") == "serve_request"]
    summary = json.loads(lines[-1])
    print("".join(f"    | {x}\n" for x in lines
                  if not x.startswith('{"bc"')), end="")
    return rc, records, summary, launches, wall


def npz_differ(ids, a: Path, b: Path) -> list:
    """The ids whose ``<id>.npz`` in ``a`` and ``b`` are not byte-equal."""
    return [i for i in ids
            if (a / f"{i}.npz").read_bytes() != (b / f"{i}.npz").read_bytes()]


def phase_serve(smi):
    """The serve main path on the card (see the module docstring)."""
    import numpy as np

    from heat_tpu_torch import HeatConfig, solve
    from heat_tpu_torch.serve.engine import bf16_to_float32

    reqfile = WORK / "requests.jsonl"
    reqs = serve_population(reqfile)
    ids = [r["id"] for r in reqs]
    by_id = {r["id"]: r for r in reqs}
    out_k, out_t = WORK / "serve-cuda", WORK / "serve-torch"
    print(f"[phase 5] serve {len(reqs)} requests: {' '.join(SERVE_ARGS)}")
    rc, recs, summary, launches, wall = cli_serve(reqfile, out_k)
    check(rc == 0, f"serve exited {rc}")
    check(len(recs) == len(reqs) and all(r["status"] == "ok" for r in recs),
          "not every request served ok")
    check(summary["lane_kernel_fallbacks"] == 0, "a bucket fell back to torch")
    passes = summary["lane_passes"]
    check(launches == {k: passes.get(k, 0) for k in launches},
          f"lane launches {launches} != the dispatched chunks' passes {passes}")
    check(launches["lanes2d"] > 0 and launches["lanes3d"] > 0,
          f"serve did not launch both lane kernels: {launches}")
    # the launches by bucket, from the scheduler's count of the dispatched
    # chunks' passes (whose totals the wrappers' counts just matched)
    by_bucket = summary["lane_passes_by_bucket"]
    cell_steps = sum(r["n"] ** r.get("ndim", 2) * r["ntime"] for r in reqs)
    rate = cell_steps / wall
    print(f"  served {len(recs)} requests, {cell_steps} cell-steps in "
          f"{wall:.3f} s: {rate:.6g} cell-steps/s; "
          f"{summary['chunks_dispatched']} chunks ({summary['tail_chunks']} "
          f"tail), boundary_wait_s {summary['boundary_wait_s']}, est. device "
          f"idle {summary['device_idle_s']} s, launches {launches} on {smi}")
    for bucket, count in by_bucket.items():
        print(f"    {count} launches of {bucket}")

    profile = profiled_serve(reqfile, WORK / "serve-profiled", wall, ids, out_k)

    print("[phase 5] the same file with --serve-lane-kernel torch (the plain "
          "versions, on the card)")
    rc_t, recs_t, summary_t, launches_t, wall_t = cli_serve(
        reqfile, out_t, "--serve-lane-kernel", "torch")
    check(rc_t == 0 and all(r["status"] == "ok" for r in recs_t),
          "torch lane body run failed")
    check(not any(launches_t.values()) and not summary_t["lane_passes"],
          f"torch body launched {launches_t}")
    ndiff = npz_differ(ids, out_k, out_t)
    print(f"  {len(reqs) - len(ndiff)} of {len(reqs)} npz files byte-equal "
          f"(torch body {wall_t:.3f} s, {cell_steps / wall_t:.6g} "
          f"cell-steps/s)")
    check(not ndiff, f"npz differ from the plain versions' run: {ndiff}")

    def field_of(rid):
        with np.load(out_k / f"{rid}.npz") as z:
            T = z["T"]
        return bf16_to_float32(T) if T.dtype == np.dtype("V2") else T

    def cost(r):
        return r["n"] ** r.get("ndim", 2) * r["ntime"]

    def config(r):
        return HeatConfig(**{k: v for k, v in r.items() if k != "id"})

    small = (sorted((r for r in reqs if r["dtype"] == "float32"
                     and r.get("ndim", 2) == 2), key=cost)[:4]
             + sorted((r for r in reqs if r.get("ndim", 2) == 3), key=cost)[:2])
    oracle_errs = {}
    for r in small:
        cfg = config(r)
        want = solve(cfg.with_(backend="serial")).T
        got = field_of(r["id"])
        check(got.shape == want.shape and np.isfinite(got).all(),
              f"bad field {r['id']}")
        err = float(np.abs(got - want).max())
        atol = F32_ATOL * cfg.ntime / 30
        oracle_errs[r["id"]] = err
        print(f"  {r['id']} ({cfg.n}^{cfg.ndim}, {cfg.ntime} steps, sigma "
              f"{cfg.sigma:.6g}, {cfg.bc}) vs serial oracle: max|err| "
              f"{err:g} (atol {atol:g} = 5e-6 per 30 steps)")
        check(err <= atol, f"{r['id']} off the serial oracle")
    # every field inside the discrete maximum principle's envelope: the
    # initial conditions and bc_value lie in [1, 2], and an FTCS step at
    # sigma <= 1/(2 ndim) is a convex combination (an ulp of rounding aside)
    for r in reqs:
        T = field_of(r["id"])
        lo, hi = float(T.min()), float(T.max())
        check(1.0 - ENVELOPE_TOL <= lo and hi <= 2.0 + ENVELOPE_TOL,
              f"{r['id']} left the [1, 2] envelope: [{lo!r}, {hi!r}]")
    print(f"  all {len(reqs)} fields inside the [1, 2] envelope "
          f"(+-{ENVELOPE_TOL:g})")
    # bf16 against f32: a measurement, not a check. The lanes round to bf16
    # after EVERY step (the reference's lane programs do), so a cell stops
    # moving once its update is under half a bf16 ulp (2^-8 on [1, 2)) and
    # over thousands of steps the bf16 field stagnates behind the f32 one.
    # Beside each gap stand the planted faults' readings: how far the f32
    # request's field lies from an f32 solve (on the card) of the same
    # request with another sigma or another initial condition, that is, the
    # gap a lane that took another request's r or IC would show. Where the
    # stagnation gap is the larger, no limit on it tells such a fault apart;
    # the bf16 lanes are held to the plain body's bytes above instead (and,
    # in the CPU tests, to the JAX engine's).
    drift = {}
    for i in range(8):
        twin = by_id[f"bf16-{i}"]
        src = next(r for r in reqs if r["dtype"] == "float32"
                   and all(r.get(k) == twin.get(k) for k in
                           ("n", "ntime", "sigma", "bc", "ic")))
        f32 = field_of(src["id"]).astype(np.float64)
        d = float(np.mean(np.abs(field_of(twin["id"]) - f32)))
        planted = {}
        for key, values in (("sigma", LANE_R[2]), ("ic", ICS)):
            for v in values:
                if v != src[key]:
                    T = solve(config(dict(src, **{key: v})).with_(
                        backend="cuda"), device="cuda").T
                    planted[f"{key} {v:.6g}" if key == "sigma"
                            else f"{key} {v}"] = float(np.mean(np.abs(T - f32)))
        drift[twin["id"]] = dict(gap=d, planted=planted)
        print(f"  {twin['id']} ({twin['n']}^2, {twin['ntime']} steps, sigma "
              f"{twin['sigma']:.6g}, {twin['ic']}) vs {src['id']}: mean |dT| "
              f"{d:.6g}; planted faults in f32: "
              + ", ".join(f"{k} {v:.6g}" for k, v in planted.items()))
    return dict(launches=launches, by_bucket=by_bucket, summary=summary,
                wall_s=wall, cell_steps_per_s=rate, oracle_errs=oracle_errs,
                bf16_drift=drift, profile=profile)


def profiled_serve(reqfile: Path, out_dir: Path, wall: float, ids: list,
                   ref_dir: Path):
    """The kernel-body serve once more under ``torch.profiler``: the card's
    busy time by kernel (the unprofiled run's wall is the denominator of the
    busy share, since profiling slows the host) and the host's heaviest
    calls. The run is checked as the first one is (exit code, every record
    ok) and its npz files must be byte-equal to the first run's; only the
    profiler's own steps report "not measured" where they fail."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print("[phase 5] the same file once more under torch.profiler")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 — a measurement, not a check
        print(f"  device busy share: not measured (the profiler did not "
              f"start: {type(e).__name__}: {e})")
        prof = None
    rc, recs, _, _, pwall = cli_serve(reqfile, out_dir)
    check(rc == 0, f"profiled serve exited {rc}")
    check(len(recs) == len(ids) and all(r["status"] == "ok" for r in recs),
          "not every request of the profiled serve ok")
    ndiff = npz_differ(ids, out_dir, ref_dir)
    check(not ndiff, f"profiled serve's npz differ from the first run's: "
                     f"{ndiff}")
    print(f"  {len(ids)} of {len(ids)} npz files byte-equal to the first "
          f"run's")
    if prof is None:
        return None
    try:
        prof.stop()
        torch.cuda.synchronize()
        rows = prof.key_averages()
    except Exception as e:  # noqa: BLE001 — a measurement, not a check
        print(f"  device busy share: not measured ({type(e).__name__}: {e})")
        return None

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0))

    device = sorted(((dev_us(e), e.key, e.count) for e in rows
                     if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                    reverse=True)
    busy_s = sum(t for t, _, _ in device) / 1e6
    if busy_s <= 0:
        print("  device busy share: not measured (the profiler recorded no "
              "device time)")
        return None
    print(f"  device busy {busy_s:.6f} s: {busy_s / wall:.1%} of the "
          f"unprofiled serve's {wall:.3f} s wall ({busy_s / pwall:.1%} of "
          f"the profiled {pwall:.3f} s)")
    for t, key, count in device[:6]:
        print(f"    device {t / 1e6:.6f} s in {count} x {key[:60]}")
    host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in rows
                   if e.device_type == DeviceType.CPU), reverse=True)
    for t, key, count in host[:8]:
        print(f"    host {t / 1e6:.6f} s in {count} x {key[:60]}")
    return dict(busy_s=busy_s, busy_share=busy_s / wall,
                profiled_wall_s=pwall,
                device=[(key, t / 1e6, count) for t, key, count in device[:6]])



def nan_bits_equal(a, b) -> bool:
    """The same NaN cells, and the same bytes everywhere else (the card
    writes a computed NaN as 0x7fffffff, the host as 0x7fc00000: the NaN's
    payload is not part of the function)."""
    import torch

    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    return bool(torch.equal(na, nb)
                and torch.equal(bits(a)[~na], bits(b)[~nb]))


def lab_inputs(name, dtype, seed, nan=False):
    """The JAX lab's check shape for ``name``: (padded field on the card,
    logical extent, TPU geometry keywords, the deepest ksteps it allows,
    bounds narrower than the field or None). With ``nan``, one interior
    cell is NaN and the narrower bounds lie 3 cells from it."""
    import torch

    if "3d" in name:
        logical, pad = (40, 24, 300), (40, 24, 384)
        geo = dict(R=8, M=8, k=4, km=4 if name == "lab_3d_tiled" else 8)
        kmax, narrow = 4, (2, 36, 3, 20, 5, 290)
    elif name == "lab_thin2d_variant":
        logical, pad = (96, 260), (128, 384)
        geo, kmax, narrow = dict(tile=32, kpad=16), 16, None
    else:
        logical, pad = (100, 500), (112, 512)
        geo = dict(R=16, C=256, kr=16, kc=128)
        kmax, narrow = 16, (3, 95, 5, 490)
    T = torch.zeros(pad, dtype=dtype, device="cuda")
    T[tuple(slice(0, s) for s in logical)] = field(logical, dtype, seed)
    if nan:
        at = tuple(s // 2 for s in logical)
        T[at] = float("nan")
        narrow = tuple(v for a in at for v in (a - 3, a + 3))
    return T, logical, geo, kmax, narrow


def lab_call(name, variant, T, r, k, logical, geo, bounds, **kw):
    from heat_tpu_torch.ops import cuda_lab as cl

    fn = getattr(cl, name)
    if variant is not None:
        kw["variant"] = variant
    if bounds is not None:
        kw["bounds"] = bounds
    return fn(T, r, k, logical=logical, **geo, **kw)


def phase_lab_compare():
    """Every lab (kernel, variant, dtype) against its plain version on the
    card, bytes: the JAX lab's check shapes at depths 1 and the maximum on
    both compiled tiles, bounds narrower than the field, a NaN planted in an
    interior cell with frozen cells 3 cells away; then the K1-form
    instances against ftcs2d and L1 against ftcs3d on the same inputs.
    Returns max |err| (finite cells) per (kernel, variant)."""
    import torch

    from heat_tpu_torch.ops import cuda_lab as cl
    from heat_tpu_torch.ops import cuda_stencil as cs

    t0 = time.perf_counter()
    errs, ncases = {}, 0
    for (name, variant), form in cl.FORMS.items():
        blocks = cl.BLOCKS_2D if form.ndim == 2 else cl.BLOCKS_3D
        r = 0.2 if form.ndim == 2 else 1 / 6
        for dt in (torch.float32, torch.bfloat16):
            T, logical, geo, kmax, narrow = lab_inputs(name, dt, ncases)
            cases = [(k, block, None, T) for k in (1, kmax) for block in blocks]
            if narrow is not None:
                cases.append((kmax, blocks[0], narrow, T))
            Tn, _, _, _, nb = lab_inputs(name, dt, ncases, nan=True)
            if name == "lab_thin2d_variant":   # it takes no bounds
                nb = None
            cases.append((kmax, blocks[0], nb, Tn))
            for k, block, bounds, X in cases:
                got = lab_call(name, variant, X, r, k, logical, geo, bounds,
                               block=block)
                want = lab_call(name, variant, X, r, k, logical, geo, bounds,
                                plain=True)
                torch.cuda.synchronize()
                what = (f"{cl.key(name, variant)} {dt_name(dt)} k={k} tile "
                        f"{block} bounds {bounds}")
                g, w = got.float(), want.float()
                fin = torch.isfinite(g) & torch.isfinite(w)
                err = float((g[fin] - w[fin]).abs().max())
                key = cl.key(name, variant)
                errs[key] = max(errs.get(key, 0.0), err)
                if X is Tn:
                    spread = int(torch.isnan(w).sum())
                    check(spread > 1 and (bounds is None or bool(torch.isnan(
                        w[(bounds[0],) + tuple(s // 2 for s in logical[1:])]))),
                          f"the NaN did not spread into frozen cells: {what}")
                    ok = nan_bits_equal(got, want)
                else:
                    ok = torch.equal(bits(got), bits(want))
                if not ok:
                    print(f"  {what}: {int((bits(got) != bits(want)).sum())} "
                          f"cells differ")
                check(ok, f"lab kernel != plain: {what}")
                ncases += 1
    # at the shipped tile the K1-form instances and L1 are the template
    # instances that ftcs2d.cu / ftcs3d.cu build (stencil2d.cuh /
    # stencil3d.cuh), compiled into the lab's libraries: the same input
    # gives the same bytes
    nsame = 0
    for dt in (torch.float32, torch.bfloat16):
        T2 = field((1000, 4099), dt, seed=3)
        b2 = full_bounds(T2.shape)
        T3 = field((67, 45, 129), dt, seed=4)
        b3 = full_bounds(T3.shape)
        want2 = cs._launch(T2, 0.2, 16, b2, None)
        want3 = cs._launch(T3, 1 / 6, 8, b3, None)
        for name, variant, X, r, k, b, want in (
                ("lab_thin2d_variant", "shrink", T2, 0.2, 16, b2, want2),
                ("lab_thin2d_variant", "rolled", T2, 0.2, 16, b2, want2),
                ("lab_2d_coltiled_rolled", "f32", T2, 0.2, 16, b2, want2),
                ("lab_3d_tiled", None, T3, 1 / 6, 8, b3, want3)):
            block = (cl.BLOCKS_2D if X.dim() == 2 else cl.BLOCKS_3D)[0]
            got = cl._launch(name, variant, X, r, k, b, block, None)
            check(torch.equal(bits(got), bits(want)),
                  f"{cl.key(name, variant)} {dt_name(dt)} != the shipped "
                  f"kernel")
            nsame += 1
        torch.cuda.synchronize()
    print(f"[phase 6] {ncases} lab-kernel-vs-plain cases, 0 differing bytes "
          f"(NaN cells alike); {nsame} K1/K3-form launches equal to "
          f"ftcs2d/ftcs3d ({time.perf_counter() - t0:.1f} s)")
    return errs


def phase_lab(smi):
    """The lab's main path: ``kernel_lab.main`` (what ``python -m
    heat_tpu_torch.labs.kernel_lab`` calls) for every check and then
    LAB_BENCHES, the lab launch counts zeroed just before and read just
    after; then each bench row's plain version timed once at its shape (and
    its output held to the kernel's, bytes). Returns (rows, launches)."""
    import torch

    from heat_tpu_torch.labs import kernel_lab
    from heat_tpu_torch.ops import cuda_lab as cl

    t0 = time.perf_counter()
    rows = []
    cl.reset_launches()
    for exp in sorted(kernel_lab.CHECKS):
        print(f"[phase 6] kernel_lab {exp}")
        check(kernel_lab.main([exp]) == 0, f"kernel_lab {exp} failed")
    for argv in LAB_BENCHES:
        print(f"[phase 6] kernel_lab {' '.join(argv)}")
        check(kernel_lab.main(list(argv), results=rows) == 0,
              f"kernel_lab {' '.join(argv)} failed")
    launches = dict(cl.launches)
    print(f"  lab launches: {launches} ({time.perf_counter() - t0:.1f} s)")
    for key, count in launches.items():
        check(count > 0, f"the lab's run never launched {key}")
    for row in rows:
        dt = getattr(torch, row["dtype"])
        T = kernel_lab._field(row["shape"], dt, "cuda")
        k, block, logical = row["k"], row["block"], row["logical"]
        nd = len(logical)
        geo = ((k, k, k, k) if row["name"] != "lab_thin2d_variant"
               else (k, k))
        fn = getattr(cl, row["name"])
        args = (T, 0.25 if nd == 2 else 0.15, k, *geo)
        kw = {} if row["variant"] is None else dict(variant=row["variant"])
        if row["name"] == "lab_thin2d_variant":
            args, kw = args + (row["variant"], logical), {}
        else:
            args = args + (logical,)
        got = fn(*args, block=block, **kw)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        want = fn(*args, plain=True, **kw)
        e1.record()
        e1.synchronize()
        row["plain_ms"] = e0.elapsed_time(e1)      # one call, as phase 2's
        check(torch.equal(bits(got), bits(want)),
              f"{cl.key(row['name'], row['variant'])} at {row['shape']} != "
              f"plain")
        del got, want
        print(f"  {cl.key(row['name'], row['variant'])} "
              f"{'x'.join(map(str, row['shape']))} {dt_name(dt)} k={k} tile "
              f"{'x'.join(map(str, block))}: {row['ms']:.4f} ms/pass, bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bound_ms'] / row['ms']:.1%} of it), plain "
              f"{row['plain_ms']:.2f} ms, shipped {row['shipped_ms']:.4f} ms "
              f"({row['ms'] / row['shipped_ms']:.4f}x) on {smi}")
        del T
        torch.cuda.empty_cache()
    print(f"[phase 6] lab done ({time.perf_counter() - t0:.1f} s)")
    return rows, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not (ROOT / "heat_tpu_torch").is_dir():
        print(f"chip_smoke: no heat_tpu_torch package beside {__file__}; run "
              f"it from the repository root", file=sys.stderr)
        return 1
    smi = smi_line()
    print(smi)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    t0 = time.perf_counter()
    try:
        phase_build()
        errs = phase_compare()
        times = phase_times()
        errs.update(phase_lane_compare())
        times.update(phase_lane_times())
        runs = phase_main_path(smi)
        phase_oracle()
        serve = phase_serve(smi)
        lab_errs = phase_lab_compare()
        lab_rows, lab_launches = phase_lab(smi)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")

    f32, bf16 = torch.float32, torch.bfloat16
    kernels = []
    for key, name, shape, dt, k, replaces in (
            ("4096 f32", "ftcs2d", (4096, 4096), f32, 16, K1),
            ("32768 f32", "ftcs2d", (32768, 32768), f32, 16, K2),
            ("32768 bf16", "ftcs2d", (32768, 32768), bf16, 16, K2),
            ("512^3 f32", "ftcs3d", (512,) * 3, f32, 8, K3),
            ("512^3 bf16", "ftcs3d", (512,) * 3, bf16, 4, K3),
            ("1024^3 f32", "ftcs3d", (1024,) * 3, f32, 5, K3)):
        t = times[(name, shape, dt, k)]
        launches = runs[key]["launches"][name]
        check(launches > 0, f"main path {key} never launched {name}")
        kernels.append(dict(
            name=f"{name} {'x'.join(map(str, shape))} {dt_name(dt)} k={k}",
            route="cuda", source=SOURCES[name], replaces=replaces,
            launches=launches, max_abs_err=errs[(name, shape)],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    # the lane kernels at the serve main path's buckets: one serving chunk
    # of 8 lanes (k steps: lanes2d one pass, lanes3d one launch per step),
    # launches those of phase 5 at that bucket and dtype (every lane tier);
    # no single PyTorch call computes the fused lane chunk; bound_ms at the
    # kernels' own operation count, cost_estimate_bound_ms at the
    # reference's
    for name, B, dt, replaces in (("lanes2d", 256, f32, K4),
                                  ("lanes2d", 512, f32, K4),
                                  ("lanes2d", 1024, f32, K4),
                                  ("lanes2d", 1024, bf16, K4),
                                  ("lanes3d", 256, f32, K5)):
        t = times[(name, B, dt)]
        nd = 2 if name == "lanes2d" else 3
        launches = serve["by_bucket"].get(
            f"{name} {B} {str(dt).replace('torch.', '')}", 0)
        check(launches > 0, f"phase 5 never launched {name} at {B + 2}^{nd} "
                            f"{dt_name(dt)}")
        kernels.append(dict(
            name=f"{name} 8x{B + 2}^{nd} {dt_name(dt)} k={t['k']}",
            route="cuda", source=SOURCES[name], replaces=replaces,
            launches=launches,
            max_abs_err=max(v for (n_, _), v in errs.items() if n_ == name),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None,
            cost_estimate_bound_ms=t["cost_estimate_bound_ms"]))
    # the kernel lab's candidates (phase 6): one row per (kernel, variant,
    # dtype) benched, launches those of the lab's run; shipped_ms is the
    # shipped kernel (ftcs2d/ftcs3d) at the same shape, dtype and depth
    from heat_tpu_torch.ops import cuda_lab as cl

    for row in lab_rows:
        lkey = cl.key(row["name"], row["variant"])
        nd = cl.FORMS[(row["name"], row["variant"])].ndim
        kernels.append(dict(
            name=(f"{lkey} {'x'.join(map(str, row['shape']))} "
                  f"{dt_name(getattr(torch, row['dtype']))} k={row['k']} tile "
                  f"{'x'.join(map(str, row['block']))}"),
            route="cuda", source=SOURCES[f"lab{nd}d"],
            replaces=L_REPLACES[row["name"]], launches=lab_launches[lkey],
            max_abs_err=lab_errs[lkey], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, shipped_ms=row["shipped_ms"]))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
