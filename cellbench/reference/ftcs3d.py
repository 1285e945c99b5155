"""The plain reference of the 3D configurations: explicit FTCS for the
heat equation on a cube, the 7-point extension of the upstream's 2D
update (``reference/ftcs2d.py``),

    T[i,j,k] = T_old[i,j,k] + r * (T_old[i+1,j,k] + T_old[i-1,j,k]
                                   + T_old[i,j+1,k] + T_old[i,j-1,k]
                                   + T_old[i,j,k+1] + T_old[i,j,k-1]
                                   - 6*T_old[i,j,k])

with ``r`` derived through ``dt`` as ``ftcs2d.coefficient`` derives it.
One boundary, ``edges``: the outermost shell of the cube is frozen at its
initial values and only interior cells update (heat-tpu's 3D deployment,
BASELINE.md config 4); any other ``bc`` raises.

Plain ``torch`` elementwise operations on whole fields, one step at a
time, in the field's dtype, on whatever device the field is given on;
leading dimensions are a batch of fields. It imports nothing of the
program under test.

The one departure from the program's kernel, ``ftcs3d``: the kernel
contracts two products into fused multiply-adds, ``s - 6*T`` and
``T + r*lap``, each rounded once (ROADMAP), while the reference sums in
its own order with PyTorch's elementwise kernels, rounding each of its
operations. The two agree to a few units in the last place a step, not
in every bit, so ``correct`` compares them within a limit and not by
bytes.
"""

from __future__ import annotations

import torch


def coefficient(n: int, sigma: float, nu: float, dom_len: float) -> float:
    """``r`` derived through ``dt`` as the upstream derives it."""
    delta = dom_len / (n - 1)
    dt = sigma * delta ** 2 / nu
    return nu * dt / delta ** 2


def edges(T: torch.Tensor, r: float, steps: int) -> torch.Tensor:
    """``steps`` updates of every cell of ``T`` but its outermost shell,
    which keeps its values. Two buffers, one scratch for the sum."""
    P = T.clone()
    Q = T.clone()
    inner = (..., slice(1, -1), slice(1, -1), slice(1, -1))
    acc = torch.empty_like(P[inner])
    for _ in range(steps):
        c = P[inner]
        torch.add(P[..., 2:, 1:-1, 1:-1], P[..., :-2, 1:-1, 1:-1], out=acc)
        acc += P[..., 1:-1, 2:, 1:-1]
        acc += P[..., 1:-1, :-2, 1:-1]
        acc += P[..., 1:-1, 1:-1, 2:]
        acc += P[..., 1:-1, 1:-1, :-2]
        acc.sub_(c, alpha=6)
        torch.add(c, acc, alpha=r, out=Q[inner])
        P, Q = Q, P
    return P


def run(config: dict, T: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` steps of ``T`` under ``config``'s boundary and physics."""
    if config["bc"] != "edges":
        raise ValueError(f"no 3D reference for bc={config['bc']!r}")
    r = coefficient(config["n"], config["sigma"], config["nu"],
                    config["dom_len"])
    return edges(T, r, steps)
