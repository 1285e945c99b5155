"""Coordinates, initial conditions, and boundary conditions.

The reference builds coordinates by cumulative addition from 0 with the last
row pre-pinned to ``dom_len`` (``fortran/serial/heat.f90:28-36``); that is
``linspace(0, dom_len, n)`` up to rounding, which is what we use. Each
reference variant silently ships a *different* hat initial condition; they
are named presets here:

- ``hat``       : T=2 on [0.5,1.5]x[0.5,1.5], else 1   (fortran/serial/heat.f90:40-48)
- ``hat_half``  : T=2 on [0.5,1.5]x[0.5,1.0], else 1   (fortran/cuda_kernel/heat.F90:98)
- ``hat_small`` : T=2 on [0.5,1.0]x[0.5,1.0], else 1   (python/serial/heat.py:25)
- ``uniform``   : T=2 everywhere (the MPI variants' setup, mpi+cuda/heat.F90:243-251)
- ``zero``      : T=0 (testing)
- ``sine``      : product of per-axis ``sin(pi * i / (n-1))``, the fundamental
                  discrete eigenmode of the FTCS operator under frozen edges

Two construction paths, bit-identical by design: ``initial_condition`` is
pure numpy on the host and remains the oracle; device backends use
``initial_condition_device``, which builds the same field on the device with
torch, so no n^d host array or host-to-device copy exists at full size
(8 GiB of f64 for the 32768^2 configs).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .config import HeatConfig
from .utils import torch_dtype

_NP_DTYPES = {"float64": np.float64, "float32": np.float32, "bfloat16": np.float32}


def np_dtype(name: str):
    """Host-side dtype; bfloat16 ICs are built in f32 and cast on device."""
    return _NP_DTYPES[name]


def coords_1d(n: int, dom_len: float, dtype=np.float64) -> np.ndarray:
    """1-D coordinate axis, 0 .. dom_len inclusive (delta = dom_len/(n-1))."""
    return np.linspace(0.0, dom_len, n, dtype=dtype)


def coords(cfg: HeatConfig) -> Tuple[np.ndarray, ...]:
    """ndim coordinate axes (all identical: square/cubic domain)."""
    ax = coords_1d(cfg.n, cfg.dom_len, np_dtype(cfg.dtype))
    return (ax,) * cfg.ndim


# (x-interval, y-interval, z-interval) of the hot region per preset; z reuses
# the y interval in 3D runs of the half/small presets.
_HAT_BOXES = {
    "hat": ((0.5, 1.5), (0.5, 1.5), (0.5, 1.5)),
    "hat_half": ((0.5, 1.5), (0.5, 1.0), (0.5, 1.0)),
    "hat_small": ((0.5, 1.0), (0.5, 1.0), (0.5, 1.0)),
}


def _sine_axis(n: int, dt) -> np.ndarray:
    """Per-axis fundamental-mode samples ``sin(pi * i/(n-1))`` with the two
    edge samples pinned to exactly zero. Built on the host for both
    construction paths, so the sine itself is computed once and the device
    field is bit-identical to the host one."""
    ax = np.sin(np.pi * np.arange(n, dtype=dt) / dt(n - 1)).astype(dt)
    ax[0] = 0.0
    ax[-1] = 0.0
    return ax


def _sine_field_np(cfg: HeatConfig, dt) -> np.ndarray:
    ax = _sine_axis(cfg.n, dt)
    out = None
    for d in range(cfg.ndim):
        sh = [1] * cfg.ndim
        sh[d] = cfg.n
        a = ax.reshape(sh)
        out = a if out is None else out * a
    return np.ascontiguousarray(np.broadcast_to(out, cfg.shape))


def sine_decay_factor(cfg: HeatConfig) -> float:
    """Closed-form per-step decay of the ``sine`` eigenmode under
    ``bc="edges"``: ``1 - 4*ndim*r*sin^2(pi/(2*(n-1)))``."""
    lam = math.sin(math.pi / (2.0 * (cfg.n - 1))) ** 2
    return 1.0 - 4.0 * cfg.ndim * float(cfg.r) * lam


def ic_envelope(cfg: HeatConfig) -> Tuple[float, float]:
    """Analytic ``[min, max]`` of the initial field including the boundary
    ring — the discrete-maximum-principle envelope. ``ghost`` BCs clamp the
    ring at ``bc_value``, which therefore joins the envelope."""
    lo, hi = {
        "uniform": (2.0, 2.0), "zero": (0.0, 0.0), "sine": (0.0, 1.0),
    }.get(cfg.ic, (1.0, 2.0))   # the hat presets: 1 background, 2 hot
    if cfg.bc == "ghost":
        lo = min(lo, cfg.bc_value)
        hi = max(hi, cfg.bc_value)
    return float(lo), float(hi)


def initial_condition(cfg: HeatConfig) -> np.ndarray:
    """Build the full initial field on the host (numpy).

    For the "ghost" BC the returned array is the *owned* field only; the
    ghost ring (fixed at ``bc_value``) is supplied by the step itself.
    """
    dt = np_dtype(cfg.dtype)
    shape = cfg.shape
    if cfg.ic == "uniform":
        return np.full(shape, 2.0, dtype=dt)
    if cfg.ic == "zero":
        return np.zeros(shape, dtype=dt)
    if cfg.ic == "sine":
        return _sine_field_np(cfg, dt)
    box = _HAT_BOXES[cfg.ic]
    ax = coords_1d(cfg.n, cfg.dom_len, dt)
    field = np.ones(shape, dtype=dt)
    masks = []
    for d in range(cfg.ndim):
        lo, hi = box[d]
        m1 = (ax >= lo) & (ax <= hi)
        sh = [1] * cfg.ndim
        sh[d] = cfg.n
        masks.append(m1.reshape(sh))
    hot = masks[0]
    for m in masks[1:]:
        hot = hot & m
    field[np.broadcast_to(hot, shape)] = 2.0
    return field


def _hat_index_bounds(cfg: HeatConfig):
    """Per-dimension [first, last] hot-cell indices of the hat box, computed
    on the host exactly as ``initial_condition`` computes its masks — so the
    device-side version below is bit-identical to the host one."""
    box = _HAT_BOXES[cfg.ic]
    ax = coords_1d(cfg.n, cfg.dom_len, np_dtype(cfg.dtype))
    bounds = []
    for d in range(cfg.ndim):
        lo, hi = box[d]
        idx = np.nonzero((ax >= lo) & (ax <= hi))[0]
        bounds.append((int(idx[0]), int(idx[-1])) if idx.size else (1, 0))
    return bounds


def initial_condition_device(cfg: HeatConfig, device) -> torch.Tensor:
    """Build the initial field directly on ``device`` with torch.

    Same field as ``initial_condition``: the hat region comes from the
    identical host-side coordinate comparison and the sine axis from the
    same host samples (only their O(n^d) outer product runs on the device,
    in f32 for bf16 with one cast at the end, as the host path casts)."""
    dt = torch_dtype(cfg.dtype)
    shape = cfg.shape
    if cfg.ic == "uniform":
        return torch.full(shape, 2.0, dtype=dt, device=device)
    if cfg.ic == "zero":
        return torch.zeros(shape, dtype=dt, device=device)
    if cfg.ic == "sine":
        ax = torch.from_numpy(_sine_axis(cfg.n, np_dtype(cfg.dtype))).to(device)
        out = None
        for d in range(cfg.ndim):
            sh = [1] * cfg.ndim
            sh[d] = cfg.n
            a = ax.reshape(sh)
            out = a if out is None else out * a
        return out.expand(shape).to(dt).contiguous()
    hot = None
    for d, (lo_i, hi_i) in enumerate(_hat_index_bounds(cfg)):
        sh = [1] * cfg.ndim
        sh[d] = cfg.n
        io = torch.arange(cfg.n, device=device).reshape(sh)
        m = (io >= lo_i) & (io <= hi_i)
        hot = m if hot is None else hot & m
    two = torch.tensor(2.0, dtype=dt, device=device)
    one = torch.tensor(1.0, dtype=dt, device=device)
    return torch.where(hot.expand(shape), two, one).contiguous()


def boundary_mask(cfg: HeatConfig) -> np.ndarray:
    """Boolean mask of the outermost cell ring (the frozen cells in "edges" BC,
    i.e. the cells the serial loop never touches, fortran/serial/heat.f90:64-68)."""
    mask = np.zeros(cfg.shape, dtype=bool)
    for d in range(cfg.ndim):
        sl0 = [slice(None)] * cfg.ndim
        sl1 = [slice(None)] * cfg.ndim
        sl0[d] = 0
        sl1[d] = -1
        mask[tuple(sl0)] = True
        mask[tuple(sl1)] = True
    return mask
