"""Backend registry.

The reference implements each programming model as a standalone program;
here the variants are pluggable backends behind one registry:

- ``serial``  : numpy oracle on the host   (== fortran/serial, python/serial)
- ``torch``   : plain PyTorch step         (== cuda_cuf: compiler-generated
                                             kernel; heat_tpu's ``xla``)
- ``cuda``    : hand-written Hopper kernel (== cuda_kernel, hip
                                             heat_kernel.cpp; heat_tpu's ``pallas``)
- ``sharded`` : the field decomposed over a mesh of shards, halo
                exchange over ``torch.distributed`` or within the process,
                ``cuda``'s kernels on every shard (== mpi+cuda, hip)

Device backends run on the card unless the caller asks for the CPU:
``solve(cfg)`` resolves to ``cuda`` and raises when there is none;
``solve(cfg, device="cpu")`` runs the same code on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import HeatConfig
from ..runtime.timing import Timing

_REGISTRY: Dict[str, Callable] = {}


@dataclasses.dataclass
class SolveResult:
    cfg: HeatConfig
    T: Optional[np.ndarray]        # final field on the host (bf16 widened
                                   # to f32, exactly)
    timing: Timing
    gsum: Optional[float] = None   # global temperature sum if report_sum
    gsum_dtype: Optional[str] = None  # accumulation dtype of gsum
    start_step: int = 0            # nonzero when resumed from checkpoint
    T_dev: Any = None              # final field as a tensor on its device
                                   # (sharded: this process's shards)
    device: Optional[str] = None   # where the solve ran ("host" = numpy)
    mesh_shape: Optional[tuple] = None  # sharded: the mesh of shards
    mesh: Any = None               # sharded: its RankMesh
    exchange: Optional[dict] = None  # sharded: exchanges, bytes received,
                                     # fuse depth kf, local kernel


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_backend(name: str) -> Callable:
    from . import cuda, serial_np, sharded, torch_step  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: ``cuda`` unless the caller names another.
    Raises when CUDA is asked for (explicitly or by default) and missing —
    a solve never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "(CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def solve(cfg: HeatConfig, T0: Optional[np.ndarray] = None, device=None,
          **kw) -> SolveResult:
    """Run the configured backend end to end on ``device`` (default cuda;
    the ``serial`` oracle always runs on the host)."""
    fn = get_backend(cfg.backend)
    if cfg.backend == "serial":
        return fn(cfg, T0=T0, **kw)
    return fn(cfg, T0=T0, device=resolve_device(device), **kw)
