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
ties break the same way. The constants below are those the reference's
planner reads off-TPU (``heat_tpu/machine.py:98``, ``_DEFAULT``). They fix
where bf16 rounds, as the reference's planner decides it; they are not the
geometry of the card the port runs on and describe no chip's speed. The
port's kernels take any depth up to their cap whatever these say.

The shape given is the one the kernel sees: ghost and wrap padding
included, as the reference plans after padding.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

_MIB = 1024 * 1024

# heat_tpu/machine.py:98 (_DEFAULT): the planner's inputs off-TPU
_HBM = 819e9
_VPU_OPS = 2.2e12
_OPS_3D = 2.86e12
_VMEM_FIT = 88 * _MIB
_BAND_BUDGET = 12 * _MIB
_COLTILED_BAND_CAP = 10 * _MIB

# per-pass depth caps (pallas_stencil.py:87-91) and the thin kernel's deep
# pass threshold (:151)
KMAX_2D = 32
KMAX_3D = 8
_THIN_DEEP_BAND_CAP = 6 * _MIB

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
    return pipeline + working <= _VMEM_FIT


# -- 2D ----------------------------------------------------------------------


def _halo_2d(ksteps: int, dt: str) -> int:
    return _round_up(max(ksteps, 1), _sublane(dt))


def _tile_2d(n_pad: int, kpad: int) -> int:
    cap = _BAND_BUDGET // (n_pad * 4) - 2 * kpad
    tile = min(256, max(cap, kpad))
    return max(kpad, (tile // kpad) * kpad)


def _thin_chunk_cap(n_pad: int, dt: str) -> int:
    kpad = _halo_2d(KMAX_2D, dt)
    band = (_tile_2d(n_pad, kpad) + 2 * kpad) * n_pad * 4
    return 16 if band > _THIN_DEEP_BAND_CAP else KMAX_2D


def _cost_thin_2d(n_pad: int, kchunk: int, dt: str) -> float:
    item = _ITEMSIZE[dt]
    kpad = _halo_2d(kchunk, dt)
    tile = _tile_2d(n_pad, kpad)
    compute = 11.0 * (tile + 2 * kpad) / tile / _VPU_OPS
    bw = (2.0 * tile + 2 * kpad) * item / (tile * kchunk) / _HBM
    return compute + bw


@functools.lru_cache(maxsize=None)
def chunk_2d(shape: tuple, dt: str, ksteps: int) -> int:
    """Steps per pass of a 2D multistep (all passes but a shorter last)."""
    m, n = shape
    item = _ITEMSIZE[dt]
    sub = _sublane(dt)
    n_pad = _round_up(max(n, 128), 128)
    cap = _thin_chunk_cap(n_pad, dt)
    k_thin = min(max(ksteps, 1), cap)
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
                if band * 4 > _COLTILED_BAND_CAP:
                    continue
                compute = 11.0 * band / tile / _VPU_OPS
                bw = (band + tile) * item / (tile * k) / _HBM
                key = (compute + bw, band, -k)
                if best_col is None or key < best_col[0]:
                    best_col = (key, k)
    if best_col is not None and best_col[0][0] < 0.9 * _cost_thin_2d(
            n_pad, k_thin, dt):
        return best_col[1]
    return cap


def effective_chunk_2d(shape, dtype, ksteps: Optional[int] = None) -> int:
    """Per-pass depth of the 2D kernel at a runtime shape, ghosts included
    (``effective_chunk_2d``, pallas_stencil.py:163): the thin kernel's
    ``min(ksteps, cap)`` or the column-tiled kernel's own ``kchunk``. The
    sharded backend's fuse depth is capped by it."""
    k = KMAX_2D if ksteps is None else ksteps
    return min(max(k, 1), chunk_2d(tuple(int(s) for s in shape),
                                   _dtype_name(dtype), k))


# -- 3D ----------------------------------------------------------------------


def _cost_3d(R: int, M: int, k: int, dt: str) -> float:
    item = _ITEMSIZE[dt]
    km = _round_up(k, _sublane(dt))
    band = (R + 2 * k) * (M + 2 * km)
    tile = R * M
    compute = 13.0 * band / tile / _OPS_3D
    bw = (band + tile) * item / (tile * k) / _HBM
    return compute + bw


@functools.lru_cache(maxsize=None)
def chunk_3d(shape: tuple, dt: str, ksteps: int) -> Optional[int]:
    """``_plan_3d``'s kchunk for this shape, or None where it has no plan."""
    m, mid, n = shape
    sub = _sublane(dt)
    n_pad = _round_up(max(n, 128), 128)
    item = _ITEMSIZE[dt]
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
                key = (_cost_3d(R, M, k, dt) * pad, band, -k)
                if best is None or key < best[0]:
                    best = (key, k)
    return None if best is None else best[1]


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
