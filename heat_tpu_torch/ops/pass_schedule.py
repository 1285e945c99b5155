"""Where a fused multistep rounds: the per-launch step counts of ``k`` steps.

A pass of the stencil kernels runs its steps on an f32 band and rounds to
the storage dtype once, at its end. So the bytes of a bf16 solve depend on
how ``k`` steps are cut into passes (f32 bytes do not: an f32 band rounds
to f32 at every step anyway). The port cuts them exactly where the
reference does. There, the pass depth is chosen by the Pallas planners of
``heat_tpu/ops/pallas_stencil.py``:

- 2D (``_multistep``, :718-748): ``_plan_2d`` (:535) picks the thin
  row-band kernel, whose passes are ``min(k, _thin_chunk_cap)`` deep
  (:154), or the column-tiled kernel with its own ``kchunk`` in
  {4, 8, 16, 32};
- 3D (:749-764): ``_plan_3d`` (:387) searches (R, M, k <= 8) under a cost
  model and returns its ``kchunk``, or no plan at all; the reference then
  takes the XLA step (``pallas_available``, :706), and the port the plain
  ``torch`` step.

This module is a copy of that planning arithmetic, float for float, so
ties break the same way. Its inputs (rates, VMEM caps) are the reference's
``ChipModel``'s, read from ``machine.current()``: the reference's off-TPU
table (``machine.DEFAULT``) unless ``HEAT_CHIP_CALIBRATION`` names a
``calibrate`` record, exactly as the reference's planner reads them. They
fix where bf16 rounds, as the reference's planner decides it; the port's
kernels take any depth up to their cap whatever these say.

The shape given is the one the kernel sees: ghost and wrap padding
included, as the reference plans after padding.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

from .. import machine

# per-pass depth caps (pallas_stencil.py:87-91) and the thin kernel's deep
# pass threshold (:151)
KMAX_2D = 32
KMAX_3D = 8
_THIN_DEEP_BAND_CAP = 6 * 1024 * 1024

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _dtype_name(dtype) -> str:
    """'float32' / 'bfloat16' from a torch dtype or a string."""
    name = str(dtype).replace("torch.", "")
    if name not in _ITEMSIZE:
        raise ValueError(f"no pass schedule for dtype {dtype}")
    return name


def _sublane(dt: str) -> int:
    return 16 if dt == "bfloat16" else 8


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _fits(band_cells: int, tile_cells: int, item: int) -> bool:
    """``_fits_vmem`` (:330)."""
    pipeline = 2 * (band_cells + tile_cells) * item
    working = 3 * band_cells * 4
    return pipeline + working <= machine.current().vmem_fit_bytes


# -- 2D ----------------------------------------------------------------------


def _halo_2d(ksteps: int, dt: str) -> int:
    return _round_up(max(ksteps, 1), _sublane(dt))


def _tile_2d(n_pad: int, kpad: int) -> int:
    """``_tile_2d`` (:177): sized by the current model's band budget."""
    cap = machine.current().band_budget_bytes // (n_pad * 4) - 2 * kpad
    tile = min(256, max(cap, kpad))
    return max(kpad, (tile // kpad) * kpad)


def _thin_chunk_cap(n_pad: int, dt: str) -> int:
    kpad = _halo_2d(KMAX_2D, dt)
    band = (_tile_2d(n_pad, kpad) + 2 * kpad) * n_pad * 4
    return 16 if band > _THIN_DEEP_BAND_CAP else KMAX_2D


def cost_thin_2d(n_pad: int, kchunk: int, dt, chip) -> float:
    """``cost_thin_2d`` (:187): modelled seconds per point-step of the thin
    kernel at depth ``kchunk`` under ``chip``'s rates (the tile is sized by
    the current model, as in the reference). ``calibrate`` inverts it."""
    dt = _dtype_name(dt)
    item = _ITEMSIZE[dt]
    kpad = _halo_2d(kchunk, dt)
    tile = _tile_2d(n_pad, kpad)
    compute = 11.0 * (tile + 2 * kpad) / tile / chip.vpu_ops_per_s
    bw = (2.0 * tile + 2 * kpad) * item / (tile * kchunk) / chip.hbm_bytes_per_s
    return compute + bw


@functools.lru_cache(maxsize=None)
def plan_2d(shape: tuple, dt: str, ksteps: int) -> tuple:
    """``_plan_2d`` (:535): ``("thin", kchunk)`` or ``("coltiled", R, C, kr,
    kc, kchunk)``, the reference's tuples."""
    m, n = shape
    item = _ITEMSIZE[dt]
    sub = _sublane(dt)
    n_pad = _round_up(max(n, 128), 128)
    chip = machine.current()
    k_thin = min(max(ksteps, 1), _thin_chunk_cap(n_pad, dt))
    best_col = None
    for k in (4, 8, 16, 32):
        if k > max(ksteps, 1):
            continue
        kr = _round_up(k, sub)
        kc = 128
        for C in (2048, 4096, 8192):
            if C >= n_pad:
                continue
            for R in (128, 256, 512, 1024):
                R = _round_up(R, kr)
                R = min(R, _round_up(max(m, kr), kr))
                band = (R + 2 * kr) * (C + 2 * kc)
                tile = R * C
                if not _fits(band, tile, item):
                    continue
                if band * 4 > chip.coltiled_band_cap_bytes:
                    continue
                compute = 11.0 * band / tile / chip.vpu_ops_per_s
                bw = (band + tile) * item / (tile * k) / chip.hbm_bytes_per_s
                key = (compute + bw, band, -k)
                if best_col is None or key < best_col[0]:
                    best_col = (key, R, C, kr, kc, k)
    if best_col is not None and best_col[0][0] < 0.9 * cost_thin_2d(
            n_pad, k_thin, dt, chip):
        _, R, C, kr, kc, k = best_col
        return ("coltiled", R, C, kr, kc, k)
    return ("thin", k_thin)


@functools.lru_cache(maxsize=None)
def chunk_2d(shape: tuple, dt: str, ksteps: int) -> int:
    """Steps per pass of a 2D multistep (all passes but a shorter last), as
    ``_multistep`` (:718) cuts them: the thin kernel's cap, or the
    column-tiled plan's own ``kchunk``."""
    plan = plan_2d(shape, dt, ksteps)
    if plan[0] == "thin":
        return _thin_chunk_cap(_round_up(max(shape[1], 128), 128), dt)
    return plan[-1]


def effective_chunk_2d(shape, dtype, ksteps: Optional[int] = None) -> int:
    """Per-pass depth of the 2D kernel at a runtime shape, ghosts included
    (``effective_chunk_2d``, pallas_stencil.py:163): the thin kernel's
    ``min(ksteps, cap)`` or the column-tiled kernel's own ``kchunk``. The
    sharded backend's fuse depth is capped by it."""
    plan = plan_2d(tuple(int(s) for s in shape), _dtype_name(dtype),
                   KMAX_2D if ksteps is None else ksteps)
    return plan[1] if plan[0] == "thin" else plan[-1]


# -- 3D ----------------------------------------------------------------------


def cost_3d(R: int, M: int, k: int, dt, chip) -> float:
    """``cost_3d`` (:202): modelled seconds per computed point-step of the
    3D kernel at (R, M, k) under ``chip``'s rates."""
    dt = _dtype_name(dt)
    item = _ITEMSIZE[dt]
    km = _round_up(k, _sublane(dt))
    band = (R + 2 * k) * (M + 2 * km)
    tile = R * M
    compute = 13.0 * band / tile / chip.ops_rate_3d
    bw = (band + tile) * item / (tile * k) / chip.hbm_bytes_per_s
    return compute + bw


@functools.lru_cache(maxsize=None)
def plan_3d(shape: tuple, dt: str, ksteps: int) -> Optional[tuple]:
    """``_plan_3d`` (:387): ``((m_pad, mid_pad, n_pad), R, M, kchunk)``, or
    None where it has no plan."""
    m, mid, n = shape
    sub = _sublane(dt)
    n_pad = _round_up(max(n, 128), 128)
    item = _ITEMSIZE[dt]
    chip = machine.current()
    best = None
    for k in range(1, min(max(ksteps, 1), KMAX_3D) + 1):
        km = _round_up(k, sub)
        for R in (8, 16, 32, 48, 64, 96, 128):
            if R % k:
                R = _round_up(R, k)
            R = min(R, _round_up(max(m, k), k))
            for M in (sub, 32, 64, 96, 128, 192):
                M = _round_up(M, km)
                M = min(M, _round_up(max(mid, km), km))
                band = (R + 2 * k) * (M + 2 * km)
                tile = R * M
                if not _fits(band * n_pad, tile * n_pad, item):
                    continue
                pad = (_round_up(max(m, R), R) * _round_up(max(mid, M), M)
                       / max(m * mid, 1))
                key = (cost_3d(R, M, k, dt, chip) * pad, band, -k)
                if best is None or key < best[0]:
                    best = (key, R, M, k)
    if best is None:
        return None
    _, R, M, k = best
    return ((_round_up(max(m, R), R), _round_up(max(mid, M), M), n_pad),
            R, M, k)


@functools.lru_cache(maxsize=None)
def chunk_3d(shape: tuple, dt: str, ksteps: int) -> Optional[int]:
    """``_plan_3d``'s kchunk for this shape, or None where it has no plan."""
    plan = plan_3d(shape, dt, ksteps)
    return None if plan is None else plan[-1]


# the plans depend on the chip model: a calibration loaded (or a model
# overridden) after the first plan must not be answered from the cache
for _cached in (plan_2d, plan_3d, chunk_2d, chunk_3d):
    machine.register_cache(_cached.cache_clear)


# -- the schedule ------------------------------------------------------------


def passes(shape: Sequence[int], dtype, ksteps: int) -> Optional[List[int]]:
    """Per-launch step counts of ``ksteps`` fused steps on a field of this
    shape (2D or 3D, f32 or bf16), as the reference's ``_multistep`` cuts
    them: full passes of the planned depth, then the remainder. None where
    the reference has no kernel plan (3D only)."""
    shape = tuple(int(s) for s in shape)
    dt = _dtype_name(dtype)
    if len(shape) == 2:
        chunk = chunk_2d(shape, dt, ksteps)
    elif len(shape) == 3:
        chunk = chunk_3d(shape, dt, ksteps)
        if chunk is None:
            return None
    else:
        raise ValueError(f"no pass schedule for a {len(shape)}D field")
    full, rem = divmod(max(ksteps, 0), chunk)
    return [chunk] * full + ([rem] if rem else [])
