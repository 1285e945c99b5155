#!/usr/bin/env python3
"""On-card smoke test of heat_tpu_torch: builds the CUDA kernels, holds them
against their plain PyTorch versions byte for byte, drives the ``run`` path
at the shipped sizes in 2D and 3D, and checks the answer against the serial
oracle.

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
   tests/test_backends.py).

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
SOURCES = {"ftcs2d": "heat_tpu_torch/ops/csrc/ftcs2d.cu",
           "ftcs3d": "heat_tpu_torch/ops/csrc/ftcs3d.cu"}
K1 = "heat_tpu/ops/pallas_stencil.py:256"   # _pallas_2d
K2 = "heat_tpu/ops/pallas_stencil.py:633"   # _pallas_2d_coltiled
K3 = "heat_tpu/ops/pallas_stencil.py:489"   # _pallas_3d_aligned
F32_ATOL = 5e-6                 # tests/test_backends.py:33
SIGMA_3D = 1 / 6                # benchmarks/run_all.py:192


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
        runs = phase_main_path(smi)
        phase_oracle()
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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
