"""Serial numpy backend — the correctness oracle.

A faithful, dependency-light reimplementation of the reference's serial
solvers (``fortran/serial/heat.f90:61-69``, ``python/serial/heat.py:48-58``):
host-only, per-step full-array snapshot, vectorized slice stencil. A copy of
``heat_tpu.backends.serial_np``; every other backend is tested against it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..config import HeatConfig
from ..grid import np_dtype
from ..runtime import checkpoint, debug, faults
from ..runtime.logging import master_print
from ..runtime.timing import Timing
from . import SolveResult, register


def _lap_interior(T: np.ndarray) -> np.ndarray:
    # summation order = the reference expression left-to-right (+1 neighbors
    # in axis order, then -1 neighbors, then -2*nd*center — fortran/serial/
    # heat.f90:64-68), so f64 runs bit-match the reference on any field
    nd = T.ndim
    ctr = tuple(slice(1, -1) for _ in range(nd))
    shifted = []
    for off in (slice(2, None), slice(0, -2)):
        for d in range(nd):
            sl = list(ctr)
            sl[d] = off
            shifted.append(T[tuple(sl)])
    acc = shifted[0]
    for s in shifted[1:]:
        acc = acc + s
    return acc + (-2.0 * nd) * T[ctr]


def step_edges_np(T: np.ndarray, r: float) -> np.ndarray:
    """Frozen-boundary step (serial loop bounds 2..n-1, heat.f90:64-68)."""
    ctr = tuple(slice(1, -1) for _ in range(T.ndim))
    out = T.copy()
    out[ctr] = T[ctr] + r * _lap_interior(T)
    return out


def step_ghost_np(T: np.ndarray, r: float, bc_value: float) -> np.ndarray:
    """Dirichlet-by-ghost step: all cells update against a bc_value ring
    (the undecomposed equivalent of fortran/mpi+cuda/heat.F90:206-219)."""
    padded = np.pad(T, 1, mode="constant", constant_values=bc_value)
    return T + r * _lap_interior(padded)


def step_periodic_np(T: np.ndarray, r: float) -> np.ndarray:
    """Torus step: wrap-pad supplies the opposite-edge neighbors — the
    ``pbc=.true.`` topology the reference's cartesian communicator carries
    but never enables (fortran/mpi+cuda/heat.F90:76,97)."""
    padded = np.pad(T, 1, mode="wrap")
    return T + r * _lap_interior(padded)


@register("serial")
def solve(cfg: HeatConfig, T0: Optional[np.ndarray] = None, **_) -> SolveResult:
    from .common import load_or_init

    t_all0 = time.perf_counter()
    dt = np_dtype(cfg.dtype)
    T0_host, start_step = load_or_init(cfg, T0)
    T = np.array(T0_host, dtype=dt)
    r = dt(cfg.r)

    plan = faults.plan_for(cfg)  # None in every normal run (strictly opt-in)
    t0 = time.perf_counter()
    for i in range(start_step + 1, cfg.ntime + 1):
        if cfg.heartbeat_every and i % cfg.heartbeat_every == 0:
            master_print(" time_it:", i)  # fortran/serial/heat.f90:62
        if cfg.bc == "edges":
            T = step_edges_np(T, r)
        elif cfg.bc == "periodic":
            T = step_periodic_np(T, r)
        else:
            T = step_ghost_np(T, r, dt(cfg.bc_value))
        if plan is not None:
            plan.maybe_crash(i)
            T = plan.maybe_nan(i, T)
        if cfg.check_numerics:
            debug.check_finite(T, i)  # per step: name the blow-up step and
                                      # never checkpoint a NaN field
        if cfg.checkpoint_every and i % cfg.checkpoint_every == 0:
            checkpoint.save(cfg, T, i)
    solve_s = time.perf_counter() - t0

    gsum = float(T.sum(dtype=np.float64)) if cfg.report_sum else None
    timing = Timing(total_s=time.perf_counter() - t_all0, solve_s=solve_s,
                    steps=cfg.ntime - start_step, points=cfg.points)
    return SolveResult(cfg=cfg, T=T, timing=timing, gsum=gsum,
                       gsum_dtype="float64" if gsum is not None else None,
                       start_step=start_step, device="host")
