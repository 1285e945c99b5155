"""Dtype plumbing.

The reference is double precision everywhere (``real*8``,
fortran/serial/heat.f90:5) with a ``SINGLE_PRECISION`` escape hatch
(fortran/hip/heat_kernel.cpp:5-9). The port keeps the three storage modes:
f64 parity, f32, and bf16 storage with f32 accumulation.
"""

from __future__ import annotations

import torch

_TORCH = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def torch_dtype(dtype_name: str) -> torch.dtype:
    return _TORCH[dtype_name]
