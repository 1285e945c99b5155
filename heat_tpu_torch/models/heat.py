"""Model definitions: the PDE problems the framework solves.

The reference codes solve one model, 2D FTCS diffusion (dT/dt = nu
lap(T), fortran/serial/heat.f90:64-68), on a square domain; the framework
adds the 3D 7-point extension (BASELINE.md config 4). Each model carries
its explicit stability bound and its t->inf limit, which the CLI and the
oracle tests read. The port's copy of ``heat_tpu/models/heat.py``: numpy
only (the ``edges`` limit loads ``grid`` for the boundary ring).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import HeatConfig


@dataclasses.dataclass(frozen=True)
class HeatModel:
    ndim: int
    stencil_points: int

    def stability_limit(self) -> float:
        """Explicit FTCS stability bound on sigma: 1/(2*ndim)."""
        return 1.0 / (2 * self.ndim)

    def is_stable(self, cfg: HeatConfig) -> bool:
        return cfg.sigma <= self.stability_limit() + 1e-12

    def steady_state(self, cfg: HeatConfig, T0=None) -> np.ndarray:
        """t->inf limit, per BC family.

        - ``ghost``: uniform ``bc_value``; the Dirichlet ghost walls drain
          all heat to it.
        - ``periodic``: no walls, heat is conserved, so the uniform MEAN of
          the initial field (``T0`` required).
        - ``edges``: the frozen ring keeps its initial values and the limit
          is that ring's harmonic extension; a uniform ring gives the ring
          constant (``T0`` required), any other ring raises.
        """
        if cfg.bc == "periodic":
            if T0 is None:
                raise ValueError(
                    "periodic steady state is the IC mean — pass T0")
            return np.full(cfg.shape, np.mean(np.asarray(T0, np.float64)))
        if cfg.bc == "edges":
            if T0 is None:
                raise ValueError(
                    "edges steady state is set by the frozen IC boundary "
                    "ring — pass T0")
            from ..grid import boundary_mask

            ring = np.asarray(T0, np.float64)[boundary_mask(cfg)]
            if np.ptp(ring) > 1e-12:
                raise NotImplementedError(
                    "non-uniform frozen ring: the t->inf limit is its "
                    "harmonic extension, which this constant oracle "
                    "cannot represent")
            return np.full(cfg.shape, ring.flat[0])
        return np.full(cfg.shape, cfg.bc_value)


Heat2D = HeatModel(ndim=2, stencil_points=5)
Heat3D = HeatModel(ndim=3, stencil_points=7)

MODELS = {2: Heat2D, 3: Heat3D}


def get_model(cfg: HeatConfig) -> HeatModel:
    return MODELS[cfg.ndim]
