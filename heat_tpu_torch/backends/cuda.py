"""The ``cuda`` backend: the hand-written Hopper kernel, one device.

Counterpart of heat_tpu's ``pallas`` backend (and of the reference's
explicit CUDA Fortran / HIP C++ kernels, fortran/cuda_kernel/heat.F90,
fortran/hip/heat_kernel.cpp). Each chunk runs ``fuse_depth`` fused steps
per kernel launch, then one-step launches for the remainder, exactly the
reference's pass schedule (heat_tpu/backends/pallas.py:61-66). For the
edges BC the launches ping-pong between two field buffers, so stepping
allocates nothing. f64 has no kernel and takes the plain PyTorch step, as
the reference's Pallas backend takes the XLA step; the timing record says
so (``kernel: torch-step (f64)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import HeatConfig
from ..ops.cuda_stencil import (ftcs_multistep_edges_cuda,
                                ftcs_multistep_ghost_cuda,
                                ftcs_multistep_periodic_cuda, kernel_available)
from ..utils import torch_dtype
from . import SolveResult, register
from .common import drive, resolve_initial_field

# default temporal-blocking depth: one kernel launch per 16 steps, the
# reference's default and the kernel's widest halo
_AUTO_FUSE = 16


def fuse_depth(cfg: HeatConfig) -> int:
    if cfg.fuse_steps:
        return cfg.fuse_steps
    if cfg.dtype != "float64":
        return _AUTO_FUSE
    return 1


def make_advance(cfg: HeatConfig):
    """(advance, warm): ``advance(T, k)`` runs k steps as fused passes plus
    one-step passes for the remainder; ``warm(T, k)`` makes each distinct
    launch of ``advance(T, k)`` once."""
    r = cfg.r
    bc_value = cfg.bc_value
    kf = fuse_depth(cfg)
    spare: list = [None]  # the edges ping-pong buffer

    def multi(T: torch.Tensor, k: int) -> torch.Tensor:
        if cfg.bc == "edges":
            out = spare[0]
            if out is None or out.shape != T.shape or out.device != T.device:
                out = torch.empty_like(T)
            res = ftcs_multistep_edges_cuda(T, r, k, out=out)
            spare[0] = T if res is out else None
            return res
        if cfg.bc == "periodic":
            return ftcs_multistep_periodic_cuda(T, r, k)
        return ftcs_multistep_ghost_cuda(T, r, bc_value, k)

    def advance(T: torch.Tensor, k: int) -> torch.Tensor:
        n_fused, rem = divmod(k, kf)
        if kf > 1:
            for _ in range(n_fused):
                T = multi(T, kf)
        else:
            rem = k
        for _ in range(rem):
            T = multi(T, 1)
        return T

    def warm(T: torch.Tensor, k: int) -> None:
        n_fused, rem = divmod(k, kf)
        if kf > 1 and n_fused:
            T = multi(T, kf)
        if rem or kf == 1:
            multi(T, 1)

    return advance, warm


@register("cuda")
def solve(cfg: HeatConfig, T0: Optional[np.ndarray] = None, device=None,
          **_) -> SolveResult:
    if cfg.ndim != 2:
        raise NotImplementedError(
            "the cuda backend runs 2D fields in this port; --ndim 3 comes "
            "with the 3D kernel K3 (ROADMAP.md §1 step 5); the torch "
            "backend runs 3D")
    T, start_step = resolve_initial_field(cfg, T0, device)
    if not kernel_available(cfg.shape, torch_dtype(cfg.dtype)):
        kernel = "torch-step (f64)"
    elif T.device.type == "cuda":
        kernel = "cuda ftcs2d"
    else:  # a CPU solve, asked for: the wrappers run the plain version
        kernel = "ftcs2d plain version (cpu)"
    advance, warm = make_advance(cfg)
    return drive(cfg, T, advance, warm, start_step=start_step, kernel=kernel)
