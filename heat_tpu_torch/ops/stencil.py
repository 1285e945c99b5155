"""Plain PyTorch stencil ops: the FTCS update as functions on tensors.

The counterpart of ``heat_tpu.ops.stencil`` (the XLA step): the 5-point (2D)
/ 7-point (3D) update as shifted slices, in the same summation order and
with the same two roundings, so it reproduces the XLA step byte for byte.

Math (fortran/serial/heat.f90:64-68):
    T[j,k] = T_old[j,k] + r * (T_old[j+1,k] + T_old[j,k+1]
                               + T_old[j-1,k] + T_old[j,k-1] - 4*T_old[j,k])

Three boundary semantics are kept:

- ``edges``: only interior cells update; the outermost ring is frozen
  (serial + single-GPU variants, fortran/serial/heat.f90:64).
- ``ghost``: ALL owned cells update, reading a ghost ring fixed at
  ``bc_value`` (MPI variants, fortran/mpi+cuda/heat.F90:209-215).
- ``periodic``: ALL cells update with wrap-around neighbours.

bfloat16 runs compute in float32 and round the result back.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def accum_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f32 for bf16, else the storage dtype itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def laplacian_interior(T: torch.Tensor) -> torch.Tensor:
    """Discrete 2*ndim+1-point Laplacian numerator on the interior, in the
    accumulation dtype: shape (m0-2, ..., m_{d-1}-2).

    Summation order is the reference expression's left-to-right order — all
    +1 neighbours in axis order, then all -1 neighbours, then the centre
    term — so f64 runs bit-match the reference on any field.
    """
    nd = T.dim()
    Tc = T.to(accum_dtype_for(T.dtype))
    ctr = tuple(slice(1, -1) for _ in range(nd))
    shifted = []
    for off in (slice(2, None), slice(0, -2)):
        for d in range(nd):
            sl = list(ctr)
            sl[d] = off
            shifted.append(Tc[tuple(sl)])
    acc = shifted[0]
    for s in shifted[1:]:
        acc = acc + s
    return acc + (-2.0 * nd) * Tc[ctr]


def _coef(r, dtype: torch.dtype, device) -> torch.Tensor:
    """r rounded once to the accumulation dtype, as ``jnp.asarray(r, acc)``.
    Filled on the device (``torch.tensor`` of a host scalar is a
    synchronous copy to the card)."""
    return torch.full((), r, dtype=dtype, device=device)


def ftcs_step_edges(T: torch.Tensor, r) -> torch.Tensor:
    """One FTCS step, frozen-boundary ("edges") semantics: interior cells get
    T + r*lap (two roundings), the outermost ring is returned unchanged."""
    acc_dt = accum_dtype_for(T.dtype)
    ctr = tuple(slice(1, -1) for _ in range(T.dim()))
    interior = T[ctr].to(acc_dt) + _coef(r, acc_dt, T.device) * laplacian_interior(T)
    out = T.clone()
    out[ctr] = interior.to(T.dtype)
    return out


def pad_with_ghosts(T: torch.Tensor, bc_value) -> torch.Tensor:
    """Surround the owned field with a one-cell ghost ring at ``bc_value``
    (the ng=1 ghost allocation of fortran/mpi+cuda/heat.F90:41,107-111)."""
    value = _coef(bc_value, T.dtype, "cpu").item()  # bc_value in T's dtype
    return F.pad(T, (1, 1) * T.dim(), mode="constant", value=value)


def ftcs_step_ghost(T: torch.Tensor, r, bc_value) -> torch.Tensor:
    """One FTCS step, Dirichlet-by-ghost ("ghost") semantics: every owned
    cell updates against a ring held at ``bc_value``."""
    acc_dt = accum_dtype_for(T.dtype)
    lap = laplacian_interior(pad_with_ghosts(T, bc_value))
    out = T.to(acc_dt) + _coef(r, acc_dt, T.device) * lap
    return out.to(T.dtype)


def laplacian_periodic(T: torch.Tensor) -> torch.Tensor:
    """Discrete Laplacian numerator with wrap-around neighbours, full array,
    in ``laplacian_interior``'s summation order."""
    nd = T.dim()
    Tc = T.to(accum_dtype_for(T.dtype))
    shifted = []
    for shift in (-1, 1):  # roll -1 brings index j+1 to j (the +1 neighbour)
        for d in range(nd):
            shifted.append(torch.roll(Tc, shift, dims=d))
    acc = shifted[0]
    for s in shifted[1:]:
        acc = acc + s
    return acc + (-2.0 * nd) * Tc


def ftcs_step_periodic(T: torch.Tensor, r) -> torch.Tensor:
    """One FTCS step on the torus: every cell updates, neighbours wrap."""
    acc_dt = accum_dtype_for(T.dtype)
    out = T.to(acc_dt) + _coef(r, acc_dt, T.device) * laplacian_periodic(T)
    return out.to(T.dtype)


def run_steps(T: torch.Tensor, nsteps: int,
              step_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Apply ``step_fn`` ``nsteps`` times."""
    for _ in range(nsteps):
        T = step_fn(T)
    return T
