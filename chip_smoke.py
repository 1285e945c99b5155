#!/usr/bin/env python3
"""On-card smoke test of heat_tpu_torch: builds the CUDA kernels, holds them
against their plain PyTorch versions byte for byte, drives the ``run`` path
at the shipped sizes, and checks the answer against the serial oracle.

Usage, from the repository root on a host with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without a card, or outside
a checkout of the repository, it exits non-zero and prints no result):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, the
   kernel build (``nvcc`` for sm_90a) and its ptxas register report;
2. ``ftcs2d`` against ``ftcs_multistep_2d_plain`` on the card, bytes
   compared: 67x130, 1000x4099 and 4096^2 under edges/ghost/periodic,
   f32/bf16, k in {1, 7, 16}, r in {0.25, 0.2}; one 16-step 32768^2 pass in
   f32 and bf16; then per-pass times of kernel and plain version;
3. the main path, ``heat_tpu_torch.cli.main(["run", "--backend", "cuda",
   "--json", ...])`` (what ``python -m heat_tpu_torch run`` calls) with the
   launch counts zeroed just before and read just after: 4096^2 f32 for 8192
   steps (the python/cuda benchmark shape), 32768^2 in f32 and bf16 (the
   hip.dat size, ntime cut to 256); each run's global sum checked equal to
   that of the plain version run in the same passes;
4. configs/serial.dat (1024^2, 30 steps) on ``cuda`` in f32, written to
   soln.dat and read back, against the serial numpy oracle at the
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
SOURCE = "heat_tpu_torch/ops/csrc/ftcs2d.cu"
K1 = "heat_tpu/ops/pallas_stencil.py:256"   # _pallas_2d
K2 = "heat_tpu/ops/pallas_stencil.py:633"   # _pallas_2d_coltiled
F32_ATOL = 5e-6                 # tests/test_backends.py:33


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


# --------------------------------------------------------------------------


def phase_build():
    import torch

    from heat_tpu_torch.ops import _build

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load("ftcs2d")
    print(f"[phase 1] ftcs2d built for sm_90a in {time.perf_counter() - t0:.3f} s")
    for line in _build.build_log("ftcs2d").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def phase_compare():
    """Kernel vs plain version, bytes. Returns max |err| per shape."""
    import torch

    from heat_tpu_torch.ops import cuda_stencil as cs

    def run(bc, T, r, k, plain):
        if bc == "edges":
            return cs.ftcs_multistep_edges_cuda(T, r, k, plain=plain)
        if bc == "ghost":
            return cs.ftcs_multistep_ghost_cuda(T, r, 1.0, k, plain=plain)
        return cs.ftcs_multistep_periodic_cuda(T, r, k, plain=plain)

    cases = [(shape, bc, dt, k, r)
             for shape in ((67, 130), (1000, 4099), (4096, 4096))
             for bc in ("edges", "ghost", "periodic")
             for dt in (torch.float32, torch.bfloat16)
             for k in (1, 7, 16) for r in (0.25, 0.2)]
    cases += [((32768, 32768), "edges", dt, 16, 0.2)
              for dt in (torch.float32, torch.bfloat16)]
    errs = {}
    t0 = time.perf_counter()
    for i, (shape, bc, dt, k, r) in enumerate(cases):
        T = field(shape, dt, seed=i)
        got = run(bc, T, r, k, plain=False)
        want = run(bc, T, r, k, plain=True)
        torch.cuda.synchronize()
        ndiff = int((bits(got) != bits(want)).sum())
        err = float((got.float() - want.float()).abs().max())
        errs[shape] = max(errs.get(shape, 0.0), err)
        if shape[0] >= 4096 or ndiff:
            print(f"  {shape} {bc} {str(dt)[6:]} k={k} r={r}: "
                  f"{ndiff} cells differ, max|err| {err:g}")
        check(ndiff == 0, f"kernel != plain at {shape} {bc} {dt} k={k} r={r}")
        del T, got, want
    torch.cuda.empty_cache()
    print(f"[phase 2] {len(cases)} kernel-vs-plain cases, 0 differing bytes "
          f"({time.perf_counter() - t0:.1f} s)")
    return errs


def phase_times():
    """ms per 16-step pass: kernel (mean of many launches) and plain."""
    import torch

    from heat_tpu_torch.machine import device_model
    from heat_tpu_torch.ops import cuda_stencil as cs

    dm = device_model(0)
    times = {}
    for (m, n), dt, reps in (((4096, 4096), torch.float32, 200),
                             ((4096, 4096), torch.bfloat16, 200),
                             ((32768, 32768), torch.float32, 10),
                             ((32768, 32768), torch.bfloat16, 10)):
        A = field((m, n), dt, seed=1)
        B = torch.empty_like(A)
        bounds = (0, m - 1, 0, n - 1)
        ms = event_ms(lambda: cs._launch(A, 0.25, 16, bounds, B), reps)
        plain_ms = event_ms(lambda: cs.ftcs_multistep_2d_plain(A, 0.25, 16),
                            3 if m <= 4096 else 1)
        bound_s, bound_by = dm.pass_bound_s(m * n, A.element_size(), 16)
        times[(m, n, dt)] = dict(ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_s * 1e3, bound_by=bound_by)
        print(f"  ftcs2d {m}x{n} {str(dt)[6:]} k=16: {ms:.4f} ms/pass "
              f"(plain {plain_ms:.2f} ms, bound {bound_s * 1e3:.4f} ms "
              f"by {bound_by}, {bound_s * 1e3 / ms:.1%} of it)")
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
        launches = cs.launches["ftcs2d"]
    finally:
        os.chdir(cwd)
    out = buf.getvalue()
    print("".join(f"    | {line}\n" for line in out.splitlines()), end="")
    check(rc == 0, f"run exited {rc}")
    return out, launches


def phase_main_path(smi):
    import numpy as np
    import torch

    from heat_tpu_torch import HeatConfig
    from heat_tpu_torch.backends.common import host_fetch
    from heat_tpu_torch.grid import initial_condition_device
    from heat_tpu_torch.ops.cuda_stencil import ftcs_multistep_edges_cuda

    # bench.py's shape (the python/cuda benchmark) and configs/hip.dat's
    specs = {"4096 f32": (4096, 0.05, 2.0, 8192, "float32"),
             "32768 f32": (32768, 0.05, 1.0, 256, "float32"),
             "32768 bf16": (32768, 0.05, 1.0, 256, "bfloat16")}
    runs = {}
    for key, (n, nu, dom_len, ntime, dtype) in specs.items():
        print(f"[phase 3] run --backend cuda, {n}^2 {dtype}, {ntime} steps")
        out, launches = cli_run(f"{n} 0.25 {nu} {dom_len} {ntime}\n", "--json",
                                "--dtype", dtype, "--report-sum")
        rec = json.loads(out.strip().splitlines()[-1])
        check(rec["launches"]["ftcs2d"] == launches, "launch count mismatch")
        n_fused, rem = divmod(ntime, 16)
        timed, warm = n_fused + rem, 1 + (1 if rem else 0)
        check(rec["kernel"] == "cuda ftcs2d", f"kernel {rec['kernel']}")
        check(launches == timed + warm,
              f"{launches} launches, expected {timed + warm}")
        check(rec["gsum"] is not None and rec["gsum"] == rec["gsum"]
              and abs(rec["gsum"]) < float("inf"), "non-finite field")
        print(f"  {key}: {rec['points_per_s']:.6g} points/s, "
              f"{rec['per_step_s'] * 1e3:.6f} ms/step, {launches} launches "
              f"({timed} timed + {warm} warm-up) on {smi}")
        runs[key] = rec
        torch.cuda.empty_cache()
    # each run's field against the plain version run in the same 16-step
    # passes from the same initial field: the global sums (f64, on the
    # host, as the run reports it) must be equal
    for key, (n, nu, dom_len, ntime, dtype) in specs.items():
        cfg = HeatConfig(n=n, sigma=0.25, nu=nu, dom_len=dom_len, ntime=ntime,
                         dtype=dtype)
        T = initial_condition_device(cfg, "cuda")
        for _ in range(ntime // 16):
            T = ftcs_multistep_edges_cuda(T, cfg.r, 16, plain=True)
        ref = float(np.sum(np.asarray(host_fetch(T), np.float64)))
        got = runs[key]["gsum"]
        print(f"  {key}: gsum {got!r}, plain version {ref!r}")
        check(got == ref, f"{key}: main path's field is not the plain version's")
        del T
        torch.cuda.empty_cache()
    # bf16 vs f32 at the same size: the reference's bf16 bound (atol 3e-2
    # per cell, tests/test_backends.py:43) bounds the mean
    diff = abs(runs["32768 bf16"]["gsum"] - runs["32768 f32"]["gsum"]) / 32768**2
    print(f"  32768 bf16 vs f32: mean |dT| bound {diff:.3g}")
    check(diff < 3e-2, "bf16 run drifted from f32")
    return runs


def phase_serial_dat():
    import numpy as np

    from heat_tpu_torch import parse_input, solve
    from heat_tpu_torch.io import read_dat

    src = ROOT / "configs" / "serial.dat"
    cfg = parse_input(src)
    print(f"[phase 4] configs/serial.dat ({cfg.n}^2, {cfg.ntime} steps) on cuda f32")
    _, launches = cli_run(src.read_text(), "--dtype", "float32", "--soln",
                          "--out", "soln.dat")
    check(launches == 1 + 14 + 2, f"{launches} launches, expected 17")
    _, got = read_dat(WORK / "soln.dat")
    oracle = solve(cfg.with_(backend="serial", dtype="float32")).T
    check(got.shape == oracle.shape and np.isfinite(got).all(), "bad soln.dat")
    err = float(np.abs(got - oracle).max())
    print(f"  soln.dat vs serial oracle: max|err| {err:g} (atol {F32_ATOL:g})")
    check(err <= F32_ATOL, "cuda solve off the serial oracle")


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
    try:
        phase_build()
        errs = phase_compare()
        times = phase_times()
        runs = phase_main_path(smi)
        phase_serial_dat()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    kernels = []
    for key, shape, dt, replaces in (
            ("4096 f32", (4096, 4096), torch.float32, K1),
            ("32768 f32", (32768, 32768), torch.float32, K2),
            ("32768 bf16", (32768, 32768), torch.bfloat16, K2)):
        t = times[(*shape, dt)]
        launches = runs[key]["launches"]["ftcs2d"]
        check(launches > 0, f"main path {key} never launched ftcs2d")
        kernels.append(dict(
            name=f"ftcs2d {shape[0]}x{shape[1]} {str(dt)[6:]} k=16",
            route="cuda", source=SOURCE, replaces=replaces,
            launches=launches, max_abs_err=errs[shape],
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
