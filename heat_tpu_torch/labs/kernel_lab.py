"""Kernel experiments on the card: the candidate stencil bodies of
``ops/cuda_lab`` (L1-L5) checked against the plain PyTorch step and timed
against the shipped kernels (``ops/cuda_stencil``'s ``ftcs2d``/``ftcs3d``).

Run: ``python -m heat_tpu_torch.labs.kernel_lab <exp> [args] [--device D]``

``--device`` is ``cuda`` (the default; it raises without a card) or ``cpu``
(the plain versions; the checks run there, a bench fails: it times the
card). Experiments, with the JAX lab's names and argv, the TPU geometry
replaced by a Hopper tile and depth:

- ``check3d``, ``check3d_rolled``, ``checkthin``, ``check2d``,
  ``check2d_rolled``: each candidate against ``ops.stencil.ftcs_step_edges``
  stepped k times, at the JAX lab's shapes, seeds and tolerances, with
  every compiled tile on the card;
- ``bench3d`` / ``bench3d_rolled [TZ,TY,TX,k ...]``,
  ``bench3d_rolled_var {f32|fma} [...]``: L1 / L2 at 512^3 f32; the tile
  ``256,32,32`` is the streamed design ``ftcs3d`` ships (256-row segments of
  a 32x32 (mid, col) tile), ``16,16,32`` and ``8,16,64`` are output tiles
  of its earlier band design (``bench3d`` with no config times both at
  k=8);
- ``bench2d`` / ``bench2d_f32 [BR,BC,k ...]``: L4 at 32768^2 bf16 / f32;
  the tile ``256,128`` is the streamed design ``ftcs2d`` ships (segments
  of up to 256 rows of a 128-wide region), ``64,96`` and ``32,192`` are output
  tiles of its earlier band design (``bench2d`` with no config times the
  streamed tile and ``64,96`` at k=16);
  ``bench2d_rolled`` / ``bench2d_rolled_f32 [...]``: L5 f32 there;
  ``bench2d_rolled_var {f32|fma|bf16native|bf16fma} [...] [--n2 N]``;
- ``benchthin N {float32|bfloat16} [variant,BR,BC,k ...] [--steps S]``: L3;
- ``framework [case ...]``: the shipped path,
  ``cuda_stencil.ftcs_multistep_edges_cuda`` in ``ops/pass_schedule``'s
  passes, on the JAX lab's ``FRAMEWORK_CASES``.

A bench prints, per config, ms per pass, the rate, the pass's bound
(``machine.DeviceModel.pass_bound_s`` at the variant's own f32 operation
count) and the share of it reached, and the shipped kernel's ms at the same
shape, dtype and depth. A config that cannot launch prints ``FAILED`` with
the reason and the run goes on; the process then exits 1. A check that
fails raises.
"""

from __future__ import annotations

import gc
import sys
from typing import Callable, Optional

import numpy as np
import torch

from ..backends import resolve_device
from ..machine import device_model
from ..ops import cuda_lab as cl
from ..ops import cuda_stencil as cs
from ..ops import pass_schedule
from ..ops.stencil import ftcs_step_edges
from ..runtime.timing import two_point_rate

USAGE = ("python -m heat_tpu_torch.labs.kernel_lab <exp> [args] "
         "[--device cuda|cpu]")

# the JAX lab's shipped-path cases: (label, shape, dtype, ksteps, steps)
FRAMEWORK_CASES = {
    "2d4096": ("2d 4096^2 f32", (4096, 4096), "float32", 16, 2048),
    "2d32k_bf16": ("2d 32768^2 bf16", (32768, 32768), "bfloat16", 16, 96),
    "2d32k_f32": ("2d 32768^2 f32", (32768, 32768), "float32", 16, 96),
    "3d512": ("3d 512^3 f32", (512, 512, 512), "float32", 8, 480),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad(T: torch.Tensor, shape) -> torch.Tensor:
    """T zero-padded at the high end of every axis to ``shape``."""
    out = torch.zeros(shape, dtype=T.dtype, device=T.device)
    out[tuple(slice(0, s) for s in T.shape)] = T
    return out


def _field(shape, dtype, device, seed: int = 0) -> torch.Tensor:
    """Uniform [1, 2) made on ``device`` from a seed, in ``dtype``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (1.0 + torch.rand(shape, generator=g, device=device)).to(dtype)


def ref_steps(T: torch.Tensor, r: float, ksteps: int) -> torch.Tensor:
    """``ksteps`` plain PyTorch edges steps (the XLA step's arithmetic)."""
    for _ in range(ksteps):
        T = ftcs_step_edges(T, r)
    return T


def _blocks(ndim: int, device: torch.device, ksteps: int) -> list:
    """The compiled tiles that a check runs on the card (those that can take
    ``ksteps``); one pass-through on the CPU, where the tile is moot."""
    if device.type != "cuda":
        return [None]
    out = []
    for block in (cl.BLOCKS_2D if ndim == 2 else cl.BLOCKS_3D):
        try:
            out.append(cl.check_launch(ndim, block, ksteps))
        except ValueError:
            pass
    return out


def _check(label: str, run: Callable, T: torch.Tensor, r: float, ksteps,
           logical, tol: float, ndim: int, device) -> None:
    """Run ``run(Tp, ks, block)`` on the padded field at each depth and
    tile, crop, and hold it to ``ref_steps`` within ``tol``."""
    crop = tuple(slice(0, s) for s in logical)
    for ks in ksteps:
        ref = ref_steps(T[crop], r, ks).float()
        for block in _blocks(ndim, device, ks):
            out = run(ks, block)[crop]
            err = float((out.float() - ref).abs().max())
            tile = "" if block is None else f" tile {'x'.join(map(str, block))}"
            print(f"{label} ksteps={ks}{tile}: max err {err:.2e}", flush=True)
            if not err < tol:     # not an assert: it must hold under -O too
                raise AssertionError(f"{label} ksteps={ks}{tile}: max err "
                                     f"{err:.2e} over {tol:.0e}")


def check_3d(device) -> None:
    rng = np.random.default_rng(0)
    m, mid, n = 40, 24, 300
    T = torch.from_numpy(rng.uniform(1, 2, (m, mid, n)).astype(np.float32))
    T = T.to(device)
    Tp = _pad(T, (_round_up(m, 8), _round_up(mid, 8), _round_up(n, 128)))
    _check("3d tiled", lambda ks, block: cl.lab_3d_tiled(
        Tp, 0.15, ks, 8, 8, 4, 4, (m, mid, n), block=block),
        Tp, 0.15, (1, 3, 4), (m, mid, n), 2e-6, 3, device)


def check_3d_rolled(device) -> None:
    rng = np.random.default_rng(7)
    m, mid, n = 40, 24, 300
    T = torch.from_numpy(rng.uniform(1, 2, (m, mid, n)).astype(np.float32))
    Tp = _pad(T.to(device), (_round_up(m, 8), _round_up(mid, 8),
                             _round_up(n, 128)))
    for variant in ("f32", "fma"):
        _check(f"3d rolled {variant}", lambda ks, block: cl.lab_3d_rolled(
            Tp, 0.15, ks, 8, 8, 4, 8, (m, mid, n), variant=variant,
            block=block), Tp, 0.15, (1, 3, 4), (m, mid, n), 2e-6, 3, device)


def check_thin2d_variants(device) -> None:
    rng = np.random.default_rng(2)
    m, n = 96, 260
    for variant, dt, tol in (("shrink", torch.float32, 2e-6),
                             ("bf16native", torch.bfloat16, 5e-2),
                             ("rolled", torch.float32, 2e-6),
                             ("rolledfma", torch.float32, 2e-6)):
        T = torch.from_numpy(rng.uniform(1, 2, (m, n)).astype(np.float32))
        Tp = _pad(T.to(device, dt), (_round_up(m, 32), _round_up(n, 128)))
        _check(f"thin2d {variant}", lambda ks, block: cl.lab_thin2d_variant(
            Tp, 0.2, ks, 32, 16, variant, (m, n), block=block),
            Tp, 0.2, (1, 6), (m, n), tol, 2, device)


def check_2d_coltiled(device) -> None:
    rng = np.random.default_rng(1)
    m, n = 100, 500
    for dt, tol in ((torch.float32, 2e-6), (torch.bfloat16, 3e-2)):
        T = torch.from_numpy(rng.uniform(1, 2, (m, n)).astype(np.float32))
        Tp = _pad(T.to(device, dt), (_round_up(m, 16), _round_up(n, 256)))
        _check(f"2d coltiled {str(dt)[6:]}", lambda ks, block:
               cl.lab_2d_coltiled(Tp, 0.2, ks, 16, 256, 16, 128, (m, n),
                                  block=block),
               Tp, 0.2, (1, 5, 16), (m, n), tol, 2, device)


def check_2d_coltiled_rolled(device) -> None:
    rng = np.random.default_rng(3)
    m, n = 100, 500
    cases = ((torch.float32, "f32", 2e-6), (torch.float32, "fma", 2e-6),
             (torch.bfloat16, "f32", 3e-2), (torch.bfloat16, "fma", 3e-2),
             # per-mini-step bf16 rounding accumulates: looser tolerance
             (torch.bfloat16, "bf16native", 6e-2),
             (torch.bfloat16, "bf16fma", 6e-2))
    for dt, variant, tol in cases:
        T = torch.from_numpy(rng.uniform(1, 2, (m, n)).astype(np.float32))
        Tp = _pad(T.to(device, dt), (_round_up(m, 16), _round_up(n, 256)))
        _check(f"2d coltiled-rolled {str(dt)[6:]} {variant}",
               lambda ks, block: cl.lab_2d_coltiled_rolled(
                   Tp, 0.2, ks, 16, 256, 16, 128, (m, n), variant=variant,
                   block=block),
               Tp, 0.2, (1, 5, 16), (m, n), tol, 2, device)


# --------------------------------------------------------------------------
# benches
# --------------------------------------------------------------------------


def _require_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise RuntimeError(f"a bench times the card; device {device} has "
                           f"none (the CPU runs the plain versions)")


def _time_passes(pass_fn: Callable, T: torch.Tensor, npasses: int,
                 work: float):
    """(two_point_rate result, ms per pass) of ``npasses`` passes per call,
    ``pass_fn(src, dst)`` ping-ponging between T and one more buffer."""
    spare = torch.empty_like(T)

    def call(x):
        other = spare if x is not spare else T
        for _ in range(npasses):
            pass_fn(x, other)
            x, other = other, x
        return x

    rate = two_point_rate(call, T, work)
    return rate, work / rate[0] / npasses * 1e3


def _bench_rows(label: str, name: str, variant: Optional[str], configs,
                make, device, dtype: torch.dtype, steps: int, r: float,
                results: list) -> list:
    """Time each Hopper config ``(block, k)`` of (``name``, ``variant``):
    ``make(k)`` gives (padded field, logical extent, pass_fn(src, dst,
    block)). Prints a line per config and appends a row to ``results``."""
    rows = []
    nd = 3 if "3d" in name else 2
    for block, k in configs:
        tag = f"{label} tile {'x'.join(map(str, block))} k={k}"
        row = dict(name=name, variant=variant, block=tuple(block), k=k,
                   dtype=str(dtype).replace("torch.", ""), failed=None)
        try:
            cl.check_launch(nd, block, k)
            _require_card(device)
            if steps < k:
                raise ValueError(f"steps {steps} < k {k}: zero passes")
            T, logical, pass_fn = make(k)
            npasses = steps // k
            points = float(np.prod(logical))
            rate, ms = _time_passes(lambda s, d: pass_fn(s, d, block), T,
                                    npasses, points * npasses * k)
            bound_s, bound_by = device_model(device).pass_bound_s(
                T.numel(), T.element_size(), k, ndim=nd,
                ops_per_cell_step=cl.ops_per_cell_step(name, variant))
            bounds = tuple(v for s in logical for v in (0, s - 1))
            _, shipped_ms = _time_passes(
                lambda s, d: cs._launch(s, r, k, bounds, d), T, npasses,
                points * npasses * k)
            row.update(shape=tuple(T.shape), logical=tuple(logical),
                       ms=ms, pts_per_s=rate[0], raw_pts_per_s=rate[1],
                       fell_back=rate.fell_back, bound_ms=bound_s * 1e3,
                       bound_by=bound_by, shipped_ms=shipped_ms)
            print(f"{tag}: {ms:.4f} ms/pass, {rate[0]:.4e} pts/s (raw "
                  f"{rate[1]:.4e}{', two-point fell back' if rate.fell_back else ''}"
                  f"), bound {bound_s * 1e3:.4f} ms by {bound_by} "
                  f"({bound_s * 1e3 / ms:.1%} of it); shipped "
                  f"{cs._KERNELS[nd]} {shipped_ms:.4f} ms/pass", flush=True)
            del T
        except Exception as e:  # noqa: BLE001 — reported, and rc 1 at exit
            row["failed"] = f"{type(e).__name__}: {str(e)[:300]}"
            print(f"{tag}: FAILED {row['failed']}", flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
    results.extend(rows)
    return rows


def bench_3d(configs, device, results: list, n3: int = 512, steps: int = 240,
             variant: Optional[str] = None) -> list:
    """L1 (``variant`` None) or L2 at ``n3``^3 f32, r = 0.15."""
    name = "lab_3d_tiled" if variant is None else "lab_3d_rolled"
    r = 0.15

    def make(k):
        T = _field((_round_up(n3, k), _round_up(n3, k), n3), torch.float32,
                   device)
        logical = (n3, n3, n3)
        kw = {} if variant is None else dict(variant=variant)
        fn = getattr(cl, name)
        return T, logical, lambda s, d, block: fn(
            s, r, k, k, k, k, k, logical, block=block, out=d, **kw)

    label = f"{name}{'' if variant is None else ' ' + variant} {n3}^3 float32"
    return _bench_rows(label, name, variant, configs, make, device,
                       torch.float32, steps, r, results)


def bench_2d(configs, device, results: list, n2: int = 32768,
             dtype: str = "bfloat16", steps: int = 96,
             variant: Optional[str] = None) -> list:
    """L4 (``variant`` None) or L5 at ``n2``^2, r = 0.25."""
    name = "lab_2d_coltiled" if variant is None else "lab_2d_coltiled_rolled"
    dt = _DTYPES[dtype]
    r = 0.25

    def make(k):
        T = _field((_round_up(n2, k), _round_up(n2, k)), dt, device)
        logical = (n2, n2)
        kw = {} if variant is None else dict(variant=variant)
        fn = getattr(cl, name)
        return T, logical, lambda s, d, block: fn(
            s, r, k, k, k, k, k, logical, block=block, out=d, **kw)

    label = f"{name}{'' if variant is None else ' ' + variant} {n2}^2 {dtype}"
    return _bench_rows(label, name, variant, configs, make, device, dt,
                       steps, r, results)


def bench_thin2d_variants(n2: int, dtype: str, configs, device,
                          results: list, steps: int = 64) -> list:
    """L3 at ``n2``^2, r = 0.25; configs are (variant, (BR, BC), k)."""
    dt = _DTYPES[dtype]
    r = 0.25
    rows = []
    for variant, block, k in configs:
        def make(k):
            T = _field((_round_up(n2, k), n2), dt, device)
            logical = (n2, n2)
            return T, logical, lambda s, d, block: cl.lab_thin2d_variant(
                s, r, k, k, k, variant, logical, block=block, out=d)

        rows += _bench_rows(f"lab_thin2d_variant {variant} {n2}^2 {dtype}",
                            "lab_thin2d_variant", variant, [(block, k)],
                            make, device, dt, steps, r, results)
    return rows


def bench_framework(cases, device, results: list) -> list:
    """The shipped path: ``ftcs_multistep_edges_cuda`` in the reference's
    passes (``pass_schedule``), r = 0.2, as the JAX lab's framework bench
    runs the shipped Pallas path."""
    rows = []
    r = 0.2
    dm = None
    for label, shape, dtype, ksteps, steps in cases:
        row = dict(name="framework", label=label, shape=shape, dtype=dtype,
                   k=ksteps, failed=None)
        plan = pass_schedule.passes(shape, _DTYPES[dtype], ksteps)
        try:
            _require_card(device)
            dm = dm or device_model(device)
            T = _field(shape, _DTYPES[dtype], device)
            spare = torch.empty_like(T)
            ncalls = steps // ksteps

            def call(x):
                other = spare if x is not spare else T
                for _ in range(ncalls):
                    cs.ftcs_multistep_edges_cuda(x, r, ksteps, out=other)
                    x, other = other, x
                return x

            work = float(np.prod(shape)) * ncalls * ksteps
            rate = two_point_rate(call, T, work)
            bound_s = sum(dm.pass_bound_s(T.numel(), T.element_size(), k,
                                          ndim=len(shape))[0] for k in plan)
            ms = work / rate[0] / ncalls * 1e3
            row.update(plan=plan, ms_per_call=ms, pts_per_s=rate[0],
                       raw_pts_per_s=rate[1], bound_ms=bound_s * 1e3)
            print(f"{label:28s} passes={plan}: {rate[0]:.4e} pts/s, "
                  f"{ms:.4f} ms per {ksteps} steps (bound "
                  f"{bound_s * 1e3:.4f} ms, {bound_s * 1e3 / ms:.1%} of it; "
                  f"raw single-call {rate[1]:.4e})", flush=True)
            del T, spare
        except Exception as e:  # noqa: BLE001 — reported, and rc 1 at exit
            row["failed"] = f"{type(e).__name__}: {str(e)[:300]}"
            print(f"{label:28s} passes={plan}: FAILED {row['failed']}",
                  flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
    results.extend(rows)
    return rows


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------


CHECKS = {"check3d": check_3d, "check3d_rolled": check_3d_rolled,
          "checkthin": check_thin2d_variants, "check2d": check_2d_coltiled,
          "check2d_rolled": check_2d_coltiled_rolled}
DEFAULT_3D = [(cl.STREAM_3D, 8), ((16, 16, 32), 8)]
DEFAULT_2D = [(cl.STREAM_2D, 16), ((64, 96), 16)]


def _configs(args, ndim: int, default):
    """Hopper configs from argv: ``TZ,TY,TX,k`` (3D) or ``BR,BC,k`` (2D)."""
    out = []
    for a in args:
        vals = tuple(int(t) for t in a.split(","))
        if len(vals) != ndim + 1:
            raise SystemExit(f"a {ndim}D config is "
                             f"{'TZ,TY,TX,k' if ndim == 3 else 'BR,BC,k'}, "
                             f"got {a!r}")
        out.append((vals[:-1], vals[-1]))
    return out or list(default)


def _take_int(argv: list, flag: str, default: int, usage: str):
    """Pop ``flag N`` from argv: (N, the rest)."""
    if flag not in argv:
        return default, argv
    i = argv.index(flag)
    try:
        value = int(argv[i + 1])
    except (IndexError, ValueError):
        raise SystemExit(usage)
    if value <= 0:
        raise SystemExit(usage)
    return value, argv[:i] + argv[i + 2:]


def run(exp: str, argv: list, device: torch.device,
        results: list) -> None:
    """One experiment; bench rows are appended to ``results``."""
    if exp in CHECKS:
        if argv:
            raise SystemExit(f"{exp} takes no arguments")
        CHECKS[exp](device)
    elif exp == "bench3d":
        bench_3d(_configs(argv, 3, DEFAULT_3D), device, results)
    elif exp == "bench3d_rolled":
        bench_3d(_configs(argv, 3, DEFAULT_3D), device, results,
                 variant="f32")
    elif exp == "bench3d_rolled_var":
        if not argv or argv[0] not in ("f32", "fma"):
            raise SystemExit("usage: kernel_lab bench3d_rolled_var {f32|fma} "
                             "[TZ,TY,TX,k ...]")
        bench_3d(_configs(argv[1:], 3, DEFAULT_3D), device, results,
                 variant=argv[0])
    elif exp in ("bench2d", "bench2d_f32"):
        bench_2d(_configs(argv, 2, DEFAULT_2D), device, results,
                 dtype="float32" if exp == "bench2d_f32" else "bfloat16")
    elif exp in ("bench2d_rolled", "bench2d_rolled_f32"):
        bench_2d(_configs(argv, 2, DEFAULT_2D), device, results,
                 dtype="float32" if exp.endswith("_f32") else "bfloat16",
                 variant="f32")
    elif exp == "bench2d_rolled_var":
        usage = ("usage: kernel_lab bench2d_rolled_var "
                 "{f32|fma|bf16native|bf16fma} [BR,BC,k ...] [--n2 N]")
        n2, argv = _take_int(argv, "--n2", 32768, usage)
        if not argv or ("lab_2d_coltiled_rolled", argv[0]) not in cl.FORMS:
            raise SystemExit(usage)
        bench_2d(_configs(argv[1:], 2, DEFAULT_2D), device, results, n2=n2,
                 variant=argv[0])
    elif exp == "benchthin":
        usage = ("usage: kernel_lab benchthin N {float32|bfloat16} "
                 "[variant,BR,BC,k ...] [--steps S]")
        steps, argv = _take_int(argv, "--steps", 64, usage)
        if len(argv) < 2 or argv[1] not in _DTYPES:
            raise SystemExit(usage)
        cfgs = []
        for a in argv[2:]:
            parts = a.split(",")
            if len(parts) != 4 or ("lab_thin2d_variant",
                                   parts[0]) not in cl.FORMS:
                raise SystemExit(usage)
            cfgs.append((parts[0], tuple(int(p) for p in parts[1:3]),
                         int(parts[3])))
        bench_thin2d_variants(int(argv[0]), argv[1], cfgs, device, results,
                              steps=steps)
    elif exp == "framework":
        unknown = [k for k in argv if k not in FRAMEWORK_CASES]
        if unknown:
            raise SystemExit(f"unknown framework cases {unknown}; the cases "
                             f"are {sorted(FRAMEWORK_CASES)}")
        bench_framework([FRAMEWORK_CASES[k] for k in argv or FRAMEWORK_CASES],
                        device, results)
    else:
        raise SystemExit(f"unknown experiment {exp!r}\nusage: {USAGE}")


def parse_device(argv: list):
    """Pop ``--device D`` from argv: (the resolved device, the rest)."""
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device takes cuda or cpu")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    return resolve_device(device), argv


def main(argv=None, results: Optional[list] = None) -> int:
    """Run one experiment; 0 unless a bench config failed (a failing check
    raises). Bench rows are appended to ``results`` when it is given."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = parse_device(argv)
    exp = argv[0] if argv else "check3d"
    rows: list = []
    run(exp, argv[1:], device, rows)
    if results is not None:
        results.extend(rows)
    failed = [r for r in rows if r["failed"]]
    if failed:
        print(f"{len(failed)} of {len(rows)} configs FAILED", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
