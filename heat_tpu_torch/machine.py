"""Device model of the card a solve runs on.

What the card reports about itself (``torch.cuda.get_device_properties``):
name, SM count, the shared memory a block may opt into, L2 and device
memory. Beside it, the published peak rates of the parts the port targets
(NVIDIA's data sheets, SXM parts, dense), for roofline bounds: the card
cannot report them, and a card set below its 700 W power limit reaches less.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class PeakRates:
    hbm_bytes_per_s: float      # device-memory bandwidth
    f32_flops_per_s: float      # f32 outside the tensor cores
    source: str


# f32 operations per cell-step of the fused stencil, by dimension
_OPS_PER_CELL_STEP = {2: 7, 3: 9}

# Keyed by a substring of the reported device name.
PEAKS = {
    "H100": PeakRates(3.35e12, 67e12, "NVIDIA H100 SXM data sheet"),
    "H200": PeakRates(4.8e12, 67e12, "NVIDIA H200 SXM data sheet"),
}


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    sm_count: int
    smem_per_block_optin: Optional[int]   # bytes a block may opt into
    l2_bytes: Optional[int]
    mem_bytes: int
    peaks: Optional[PeakRates]            # None for a part not in PEAKS

    def pass_bound_s(self, points: int, itemsize: int, ksteps: int,
                     ndim: int = 2, op_points: Optional[int] = None
                     ) -> tuple:
        """(seconds, "bytes"|"operations"): the least time one fused pass
        could take — the field of ``points`` cells read once and written
        once over the memory rate, against the f32 operations over the f32
        rate. A cell-step is 7 operations in 2D (3 adds, the exact 4*c, a
        subtract, the update FMA as 2) and 9 in 3D (5 adds, two FMAs of 2
        each), counted over ``op_points`` cells where only those update
        (the lane kernels: the live cells of the run's lanes), else over
        every cell."""
        if self.peaks is None:
            raise ValueError(f"no published peak rates for {self.name!r}")
        updated = points if op_points is None else op_points
        t_bytes = 2 * itemsize * points / self.peaks.hbm_bytes_per_s
        t_ops = (_OPS_PER_CELL_STEP[ndim] * updated * ksteps
                 / self.peaks.f32_flops_per_s)
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_model(device=None) -> DeviceModel:
    """The model of ``device`` (default: the current CUDA device)."""
    props = torch.cuda.get_device_properties(device or torch.cuda.current_device())
    peaks = next((p for key, p in PEAKS.items() if key in props.name), None)
    return DeviceModel(
        name=props.name,
        sm_count=props.multi_processor_count,
        smem_per_block_optin=getattr(props, "shared_memory_per_block_optin", None),
        l2_bytes=getattr(props, "L2_cache_size", None),
        mem_bytes=props.total_memory,
        peaks=peaks,
    )
