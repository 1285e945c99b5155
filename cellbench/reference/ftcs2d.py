"""The plain reference of the 2D configurations: explicit FTCS for the
heat equation, written from the upstream's update,

    T[j,k] = T_old[j,k] + r * (T_old[j+1,k] + T_old[j,k+1]
                               + T_old[j-1,k] + T_old[j,k-1] - 4*T_old[j,k])

with ``r = nu * dt / delta**2``, ``dt = sigma * delta**2 / nu`` and
``delta = dom_len / (n - 1)`` (fortran/serial/heat.f90:15-17,59-68 of
cssrikanth/CUDA-HIP-MPI-Heat-equation-test). Two boundaries:

- ``edges``: the outermost ring of the field is frozen at its initial
  values, only interior cells update (the single-GPU variants);
- ``ghost``: every owned cell updates and reads a ring of ghosts fixed at
  ``bc_value`` outside the field (the MPI and HIP variants).

Plain ``torch`` elementwise operations on whole fields, one step at a
time, in the field's dtype, on whatever device the field is given on;
leading dimensions are a batch of fields. It imports nothing of the
program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def coefficient(n: int, sigma: float, nu: float, dom_len: float) -> float:
    """``r`` derived through ``dt`` as the upstream derives it."""
    delta = dom_len / (n - 1)
    dt = sigma * delta ** 2 / nu
    return nu * dt / delta ** 2


def _frozen_ring(P: torch.Tensor, r: float, steps: int) -> torch.Tensor:
    """``steps`` updates of every cell of ``P`` but its outermost ring,
    which keeps its values. Two buffers, one scratch for the sum."""
    P = P.clone()
    Q = P.clone()
    acc = torch.empty_like(P[..., 1:-1, 1:-1])
    for _ in range(steps):
        c = P[..., 1:-1, 1:-1]
        torch.add(P[..., 2:, 1:-1], P[..., 1:-1, 2:], out=acc)
        acc += P[..., :-2, 1:-1]
        acc += P[..., 1:-1, :-2]
        acc.sub_(c, alpha=4)
        torch.add(c, acc, alpha=r, out=Q[..., 1:-1, 1:-1])
        P, Q = Q, P
    return P


def edges(T: torch.Tensor, r: float, steps: int) -> torch.Tensor:
    """``steps`` steps with the outermost ring frozen."""
    return _frozen_ring(T, r, steps)


def ghost(T: torch.Tensor, r: float, bc_value: float, steps: int) -> torch.Tensor:
    """``steps`` steps of every cell against ghosts fixed at ``bc_value``."""
    padded = F.pad(T, (1, 1, 1, 1), mode="constant", value=float(bc_value))
    return _frozen_ring(padded, r, steps)[..., 1:-1, 1:-1]


def run(config: dict, T: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` steps of ``T`` under ``config``'s boundary and physics."""
    r = coefficient(config["n"], config["sigma"], config["nu"],
                    config["dom_len"])
    if config["bc"] == "edges":
        return edges(T, r, steps)
    if config["bc"] == "ghost":
        return ghost(T, r, config["bc_value"], steps)
    raise ValueError(f"no reference for bc={config['bc']!r}")
