"""``calibrate``: fit the planner's chip model from sweeps on the card.

Counterpart of ``heat_tpu/calibrate.py``. The pass planner
(``ops/pass_schedule.py``) ranks candidate passes with the reference's cost
model, whose inputs are three rates and four caps (``machine.ChipModel``).
Without a calibration it reads the reference's off-TPU table
(``machine.DEFAULT``). This command measures the three rates on the card:

- ``hbm_bytes_per_s``: a STREAM of in-place ``add_`` passes over a 256 MiB
  f32 buffer, 256 passes a call so the two-point correction
  (``runtime/timing.two_point_rate``) clears its noise floor (a plain
  elementwise pass, which the reference too leaves to its compiler);
- ``vpu_ops_per_s``: the 2D rate of the ``cuda`` backend (``ftcs2d``) at
  4096^2 f32, 16 steps a pass, inverted through the planner's own
  ``cost_thin_2d``;
- ``ops_rate_3d``: the 3D rate (``ftcs3d``) at 512^3 f32, 8 steps a pass,
  inverted through ``cost_3d`` at the planner's geometry.

It writes the reference's record (either package's ``from_calibration``
reads it), which ``HEAT_CHIP_CALIBRATION=<path>`` hands to the planner.
The caps are carried over from ``DEFAULT``: they are the reference
kernel's VMEM limits, not rates of the card.

A fit is refused, and the table value kept, wherever the measurement says
nothing about the card: an HBM or stencil rate whose two-point correction
fell back to the raw single-call rate (overhead-dominated), and a stencil
rate no rate in the bracket explains. ``calibrated`` is true only when
every rate was fitted on the card. On the CPU (``--device cpu``) the sweep
runs at tiny shapes so the harness is testable anywhere, and the record is
labelled ``trustworthy: false``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import torch


def measure_hbm(device, mib: int = 256, repeats: int = 3,
                passes: int = 256) -> dict:
    """STREAM-style memory bandwidth: each call runs ``passes`` in-place
    read+write sweeps of a ``mib`` MiB f32 buffer (``add_``), timed by the
    two-point protocol (CUDA events on the card). One 256 MiB sweep is
    about 0.16 ms on an H100, so a call of one sweep would sit at the
    protocol's noise floor; 256 make a call about 40 ms."""
    from .runtime.timing import two_point_rate

    n = mib * (1 << 20) // 4
    x = torch.zeros((n,), dtype=torch.float32, device=device)

    def sweep(a):
        for _ in range(passes):
            a.add_(1.0)
        return a

    res = two_point_rate(sweep, x, 2.0 * n * 4 * passes, repeats=repeats)
    rate, raw = res
    return {"hbm_bytes_per_s": rate, "hbm_bytes_per_s_raw": raw,
            "floor_fallback": res.fell_back,
            "buffer_mib": mib, "passes": passes}


def _solve_rate(cfg, device, repeats: int = 2) -> tuple:
    """(points/s, overhead_dominated) of ``cfg`` through the ``cuda``
    backend's own solve, in benchmark mode (no fetch, the two-point rate on
    a copy of the final state). ``overhead_dominated`` is True where the
    two-point correction hit its noise floor (or did not run) and the rate
    is the raw one: a fit from it would bake launch overhead into a rate."""
    from .backends import solve

    res = solve(cfg, device=device, fetch=False, warm_exec=True,
                two_point_repeats=repeats)
    t = res.timing
    if t.points_per_s_two_point and t.two_point_fell_back is False:
        return t.points_per_s_two_point, False
    return (t.points_per_s_two_point or t.points_per_s), True


def _invert_rate(cost_at_rate, t_pp: float, lo: float = 1e8,
                 hi: float = 1e16) -> Optional[float]:
    """The compute rate at which the cost model (decreasing in the rate)
    predicts the measured ``t_pp``: 200 geometric bisections against the
    planner's own cost function. None where no rate in [lo, hi] explains
    the measurement (faster than the model's bandwidth floor: the model is
    wrong there, so nothing is fitted)."""
    if not (cost_at_rate(hi) < t_pp < cost_at_rate(lo)):
        return None
    for _ in range(200):
        mid = (lo * hi) ** 0.5
        if cost_at_rate(mid) > t_pp:
            lo = mid
        else:
            hi = mid
    return (lo * hi) ** 0.5


def fit_vpu_2d(t_pp: float, shape, dtype_str: str, ksteps: int,
               chip_with_hbm) -> Optional[float]:
    """``vpu_ops_per_s`` from inverting ``cost_thin_2d`` at the depth the
    planner picks for this shape. None for a column-tiled plan (not the
    calibration's target) or an uninvertible measurement."""
    from .ops import pass_schedule as ps

    plan = ps.plan_2d(tuple(shape), dtype_str, ksteps)
    if plan is None or plan[0] != "thin":
        return None
    kchunk = plan[1]
    n_pad = ps._round_up(max(shape[1], 128), 128)
    return _invert_rate(
        lambda v: ps.cost_thin_2d(
            n_pad, kchunk, dtype_str,
            dataclasses.replace(chip_with_hbm, vpu_ops_per_s=v)),
        t_pp)


def fit_ops_3d(t_pp: float, shape, dtype_str: str, ksteps: int,
               chip_with_hbm) -> Optional[float]:
    """``ops_rate_3d`` from inverting ``cost_3d`` at the planner's (R, M, k)
    for this shape, charged the alignment padding as the planner charges
    it."""
    from .ops import pass_schedule as ps

    plan = ps.plan_3d(tuple(shape), dtype_str, ksteps)
    if plan is None:
        return None
    (m_pad, mid_pad, _n_pad), R, M, k = plan
    pad = m_pad * mid_pad / max(shape[0] * shape[1], 1)
    return _invert_rate(
        lambda v: ps.cost_3d(R, M, k, dtype_str,
                             dataclasses.replace(chip_with_hbm,
                                                 ops_rate_3d=v)) * pad,
        t_pp)


def run(out_path, quick: bool = False, device=None) -> dict:
    """The calibration sweep on ``device`` (default: the card; raises
    without one). Writes ``out_path`` (JSON, atomically) and returns the
    record."""
    from . import machine
    from .backends import resolve_device
    from .config import HeatConfig
    from .labs._util import stamp

    device = resolve_device(device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    base = machine.DEFAULT

    # full size on the card (each sweep a fraction of a second there);
    # tiny everywhere else, where the rates describe no card
    full = on_card and not quick
    n2d = 4096 if full else 256
    n3d = 512 if full else 32
    steps2 = 8192 if full else 16
    steps3 = 1024 if full else 16
    hbm_mib = 256 if on_card else 8
    hbm_passes = 256 if on_card else 2

    rec: dict = {"ts": time.time(), **stamp(device), "device_kind": kind,
                 "chip_class": base.name, "trustworthy": on_card,
                 "params": {"n2d": n2d, "n3d": n3d, "steps2": steps2,
                            "steps3": steps3, "hbm_mib": hbm_mib,
                            "hbm_passes": hbm_passes}}

    print(f"calibrate: platform={device.type} device={kind!r} "
          f"(base table {base.label})")
    stream = measure_hbm(device, mib=hbm_mib, passes=hbm_passes)
    # a floor fallback is the launch-dominated single-call rate: keep the
    # table's value in the model and in the fit; the raw reading stays in
    # rec["stream"]
    floor_fallback = stream["floor_fallback"]
    rec["stream"] = stream
    if floor_fallback:
        hbm = base.hbm_bytes_per_s
        print(f"  HBM stream: overhead-dominated "
              f"({stream['hbm_bytes_per_s'] / 1e9:.1f} GB/s raw) — "
              f"keeping table value {hbm / 1e9:.0f} GB/s")
    else:
        hbm = stream["hbm_bytes_per_s"]
        print(f"  HBM stream: {hbm / 1e9:.1f} GB/s")

    chip_meas = dataclasses.replace(base, hbm_bytes_per_s=float(hbm))
    k2 = 16
    cfg2 = HeatConfig(n=n2d, ntime=steps2, dtype="float32", backend="cuda",
                      fuse_steps=k2)
    rate2, od2 = _solve_rate(cfg2, device)
    vpu = (None if od2 else
           fit_vpu_2d(1.0 / rate2, (n2d, n2d), "float32", k2, chip_meas))
    rec["sweep_2d"] = {"n": n2d, "fuse": k2, "points_per_s": rate2,
                       "overhead_dominated": od2, "vpu_ops_per_s_fit": vpu}
    print(f"  2D {n2d}^2 fuse={k2}: {rate2:.3e} pts/s -> vpu "
          f"{vpu / 1e12 if vpu else float('nan'):.2f} Tops/s"
          + (" [overhead-dominated, fit refused]" if od2 else ""))

    k3 = 8
    cfg3 = HeatConfig(n=n3d, ndim=3, ntime=steps3, dtype="float32",
                      backend="cuda", fuse_steps=k3)
    rate3, od3 = _solve_rate(cfg3, device)
    ops3 = (None if od3 else
            fit_ops_3d(1.0 / rate3, (n3d,) * 3, "float32", k3, chip_meas))
    rec["sweep_3d"] = {"n": n3d, "fuse": k3, "points_per_s": rate3,
                       "overhead_dominated": od3, "ops_rate_3d_fit": ops3}
    print(f"  3D {n3d}^3 fuse={k3}: {rate3:.3e} pts/s -> ops3d "
          f"{ops3 / 1e12 if ops3 else float('nan'):.2f} Tops/s"
          + (" [overhead-dominated, fit refused]" if od3 else ""))

    rec["chip_model"] = dataclasses.asdict(dataclasses.replace(
        base,
        name=kind if on_card else f"{base.name}-proxy",
        hbm_bytes_per_s=float(hbm),
        vpu_ops_per_s=float(vpu) if vpu else base.vpu_ops_per_s,
        ops_rate_3d=float(ops3) if ops3 else base.ops_rate_3d,
        # every rate fitted on the card, or not calibrated
        calibrated=bool(on_card and vpu and ops3 and not floor_fallback)))
    rec["hbm_fitted"] = not floor_fallback
    rec["fit_complete"] = bool(vpu and ops3 and not floor_fallback)
    if on_card:
        # the card has no shipped planner table to reproduce: the HBM rate
        # is set against the data sheet, the two stencil rates against the
        # reference's table the planner reads without a calibration
        peaks = next((p for key, p in machine.PEAKS.items() if key in kind),
                     None)
        rec["vs_table"] = {
            "hbm_ratio": (None if floor_fallback or peaks is None
                          else hbm / peaks.hbm_bytes_per_s),
            "vpu_ratio": (vpu / base.vpu_ops_per_s) if vpu else None,
            "ops3d_ratio": (ops3 / base.ops_rate_3d) if ops3 else None,
            "basis": {
                "hbm_ratio": ("measured / data sheet "
                              + (peaks.source if peaks else "(none)")),
                "vpu_ratio": "fitted / machine.DEFAULT (reference table)",
                "ops3d_ratio": "fitted / machine.DEFAULT (reference table)"},
        }
        print("  vs data sheet / DEFAULT: " + ", ".join(
            f"{k}={v:.2f}x" if v else f"{k}=n/a"
            for k, v in rec["vs_table"].items() if k != "basis"))
    else:
        print("  NOT TRUSTWORTHY: CPU rates say nothing about any card "
              "(harness check only)")

    tmp = str(out_path) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=2, default=float)
    os.replace(tmp, out_path)
    print(f"wrote {out_path}")
    if rec["fit_complete"] and rec["trustworthy"]:
        print(f"use it: HEAT_CHIP_CALIBRATION={out_path} "
              f"python -m heat_tpu_torch run ...")
    else:
        print("record is incomplete or untrusted — NOT for "
              "HEAT_CHIP_CALIBRATION use (see fit_complete/trustworthy)")
    return rec
