"""The ``torch`` backend: the plain PyTorch step, one device.

Counterpart of heat_tpu's ``xla`` backend (the compiler-generated-kernel
variant, fortran/cuda_cuf/heat.F90:31-38): the shifted-slice stencil of
``ops.stencil``, eager, one step after another — byte-identical to the XLA
step on the same inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import HeatConfig
from ..ops.stencil import (ftcs_step_edges, ftcs_step_ghost,
                           ftcs_step_periodic, run_steps)
from . import SolveResult, register
from .common import drive, resolve_initial_field


def make_step(cfg: HeatConfig):
    """The one-step function of ``cfg``'s boundary condition."""
    r = cfg.r
    if cfg.bc == "edges":
        return lambda t: ftcs_step_edges(t, r)
    if cfg.bc == "periodic":
        return lambda t: ftcs_step_periodic(t, r)
    return lambda t: ftcs_step_ghost(t, r, cfg.bc_value)


@register("torch")
def solve(cfg: HeatConfig, T0: Optional[np.ndarray] = None, device=None,
          fetch: bool = True, warm_exec: bool = False,
          two_point_repeats: int = 0, **_) -> SolveResult:
    step = make_step(cfg)
    T, start_step = resolve_initial_field(cfg, T0, device)
    return drive(cfg, T, lambda t, k: run_steps(t, k, step),
                 warm=lambda t, k: step(t), start_step=start_step,
                 kernel="torch-step", fetch=fetch, warm_exec=warm_exec,
                 two_point_repeats=two_point_repeats)
