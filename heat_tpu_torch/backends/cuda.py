"""The ``cuda`` backend: the hand-written Hopper kernels, one device.

Counterpart of heat_tpu's ``pallas`` backend (and of the reference's
explicit CUDA Fortran / HIP C++ kernels, fortran/cuda_kernel/heat.F90,
fortran/hip/heat_kernel.cpp). Each chunk runs ``fuse_depth`` fused steps
per multistep call, then one-step calls for the remainder, exactly the
reference's schedule (heat_tpu/backends/pallas.py:61-66); a multistep call
is cut into kernel launches where the reference cuts it
(``ops.pass_schedule``: 16 steps are one ``ftcs2d`` launch in 2D, two
8-step ``ftcs3d`` launches at 512^3 f32). For the edges BC the last launch
of a call writes into a second field buffer, so the two ping-pong and a
one-launch call allocates nothing. f64, and 3D shapes where the
reference's planner has no plan, have no kernel and take the plain
PyTorch step, as the reference's Pallas backend takes the XLA step; the
timing record says so (``kernel: torch-step (f64)``).
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

# default temporal-blocking depth: 16 steps per multistep call, the
# reference's default
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
            # the spare is the previous call's input: never the live input
            # (a ``warm`` on the field itself leaves the field there)
            if out is None or out is T or out.shape != T.shape \
                    or out.device != T.device:
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


def launches_per_solve(cfg: HeatConfig) -> int:
    """Kernel launches of one solve of ``cfg`` from step 0, the warm-up not
    counted: the drive loop's chunks (``common.event_interval``), each cut
    as ``advance`` cuts it, each multistep call cut by its wrapper into the
    reference's passes (on the ghost-padded shape, or per wrap-padded
    chunk). 0 where the plain torch step runs."""
    from ..ops import pass_schedule
    from ..ops.cuda_stencil import periodic_pad_width
    from .common import event_interval

    dt = torch_dtype(cfg.dtype)
    shape = cfg.shape
    kf = fuse_depth(cfg)

    def multi(k: int) -> int:
        if cfg.bc == "edges":
            return (len(pass_schedule.passes(shape, dt, k))
                    if kernel_available(shape, dt) else 0)
        if cfg.bc == "ghost":
            padded = tuple(s + 2 for s in shape)
            return (len(pass_schedule.passes(padded, dt, k))
                    if kernel_available(shape, dt)
                    and kernel_available(padded, dt) else 0)
        cap = periodic_pad_width(shape, k)
        widths = {min(cap, k), k % cap or cap}
        if not all(kernel_available(tuple(s + 2 * w for s in shape), dt)
                   for w in widths):
            return 0
        total, done = 0, 0
        while done < k:
            w = min(cap, k - done)
            total += len(pass_schedule.passes(
                tuple(s + 2 * w for s in shape), dt, w))
            done += w
        return total

    def advance(k: int) -> int:
        if kf <= 1:
            return k * multi(1)
        n_fused, rem = divmod(k, kf)
        return n_fused * multi(kf) + rem * multi(1)

    chunk = min(event_interval(cfg), max(cfg.ntime, 1))
    full, rem = divmod(cfg.ntime, chunk)
    return full * advance(chunk) + (advance(rem) if rem else 0)


def kernel_label(cfg: HeatConfig, device) -> str:
    """What steps the field: the timing record's ``kernel``."""
    if cfg.dtype == "float64":
        return "torch-step (f64)"
    if not kernel_available(cfg.shape, torch_dtype(cfg.dtype)):
        return "torch-step (no 3D kernel plan)"
    name = "ftcs2d" if cfg.ndim == 2 else "ftcs3d"
    if torch.device(device).type == "cuda":
        return f"cuda {name}"
    return f"{name} plain version (cpu)"  # a CPU solve, asked for


@register("cuda")
def solve(cfg: HeatConfig, T0: Optional[np.ndarray] = None, device=None,
          fetch: bool = True, warm_exec: bool = False,
          two_point_repeats: int = 0, **_) -> SolveResult:
    T, start_step = resolve_initial_field(cfg, T0, device)
    advance, warm = make_advance(cfg)
    return drive(cfg, T, advance, warm, start_step=start_step,
                 kernel=kernel_label(cfg, T.device), fetch=fetch,
                 warm_exec=warm_exec, two_point_repeats=two_point_repeats)
