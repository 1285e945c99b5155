"""Device model of the card a solve runs on, and the planner's chip model.

What the card reports about itself (``torch.cuda.get_device_properties``):
name, SM count, the shared memory a block may opt into, L2 and device
memory. Beside it, the published peak rates of the parts the port targets
(NVIDIA's data sheets, SXM parts, dense), for roofline bounds: the card
cannot report them, and a card set below its 700 W power limit reaches less.

Below them, ``ChipModel``: the inputs of the pass planner's cost model,
``DEFAULT`` or a ``calibrate`` fit (``HEAT_CHIP_CALIBRATION``).
"""

from __future__ import annotations

import dataclasses
import json
import os
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
                     ndim: int = 2, op_points: Optional[int] = None,
                     ops_per_cell_step: Optional[int] = None) -> tuple:
        """(seconds, "bytes"|"operations"): the least time one fused pass
        could take — the field of ``points`` cells read once and written
        once over the memory rate, against the f32 operations over the f32
        rate. A cell-step is 7 operations in 2D (3 adds, the exact 4*c, a
        subtract, the update FMA as 2) and 9 in 3D (5 adds, two FMAs of 2
        each), counted over ``op_points`` cells where only those update
        (the lane kernels: the live cells of the run's lanes), else over
        every cell. ``ops_per_cell_step`` replaces that count for a body
        of another form (the kernel lab's candidates, ``ops/cuda_lab``)."""
        if self.peaks is None:
            raise ValueError(f"no published peak rates for {self.name!r}")
        updated = points if op_points is None else op_points
        t_bytes = 2 * itemsize * points / self.peaks.hbm_bytes_per_s
        ops = (_OPS_PER_CELL_STEP[ndim] if ops_per_cell_step is None
               else ops_per_cell_step)
        t_ops = ops * updated * ksteps / self.peaks.f32_flops_per_s
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


# -- the planner's chip model --------------------------------------------------
#
# The pass schedule (``ops/pass_schedule.py``) is a copy of the reference's
# Pallas planners, and those rank candidate passes with a cost model whose
# inputs are per-chip rates and VMEM caps (``heat_tpu/machine.py``). The
# port reads the same inputs from here: the reference's off-TPU table
# (``DEFAULT``), or a ``calibrate`` record named by ``HEAT_CHIP_CALIBRATION``.
# A calibration moves the cuts of f32 and bf16 alike, as in the reference,
# whose ``machine.current()`` returns the file's model on any platform. The
# data sheet's ``PEAKS`` above stay the source of every bound: a fitted
# planner rate describes what the planner should assume, not what the card
# could do.

_MIB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class ChipModel:
    """The reference's ``ChipModel`` (``heat_tpu/machine.py:36-60``), field
    for field, so either package reads the other's calibration files."""

    name: str                     # short name of the table or the fit
    hbm_bytes_per_s: float        # sustained device-memory bandwidth
    vpu_ops_per_s: float          # effective 2D stencil op rate
    ops_rate_3d: float            # effective 3D stencil op rate
    vmem_limit_bytes: int         # the reference kernel's VMEM ceiling
    vmem_fit_bytes: int           # planner feasibility bound
    band_budget_bytes: int        # 2D thin-band target footprint
    coltiled_band_cap_bytes: int  # column-tiled band cap
    calibrated: bool              # True = every rate fitted on a card

    @property
    def label(self) -> str:
        return self.name + ("" if self.calibrated else " (uncalibrated)")


# The reference's off-TPU planner table (``heat_tpu/machine.py:98``
# ``_DEFAULT``: its v5e rates, labelled uncalibrated). Without a calibration
# the port cuts passes where the reference cuts them off-TPU.
DEFAULT = ChipModel("v5e", hbm_bytes_per_s=819e9, vpu_ops_per_s=2.2e12,
                    ops_rate_3d=2.86e12, vmem_limit_bytes=110 * _MIB,
                    vmem_fit_bytes=88 * _MIB, band_budget_bytes=12 * _MIB,
                    coltiled_band_cap_bytes=10 * _MIB, calibrated=False)

_override: Optional[ChipModel] = None
_cache: Optional[ChipModel] = None
_dependent_caches: list = []


def register_cache(clear) -> None:
    """Planner caches whose entries depend on the chip model register their
    ``cache_clear`` here; ``override`` flushes them."""
    _dependent_caches.append(clear)


def from_calibration(path) -> ChipModel:
    """The chip model of a ``calibrate`` record (either package's). Raises on
    a missing or malformed file: a mistyped ``HEAT_CHIP_CALIBRATION`` must
    fail loudly, not plan on the wrong chip. An untrustworthy record (made on
    the CPU) loads with ``calibrated=False``."""
    with open(path) as f:
        rec = json.load(f)
    cm = rec["chip_model"]
    return ChipModel(**{**cm, "calibrated": bool(cm.get("calibrated")
                                                 and rec.get("trustworthy"))})


def current() -> ChipModel:
    """The planner's chip model: ``override``'s, else the record named by
    ``HEAT_CHIP_CALIBRATION`` (read once a process), else ``DEFAULT``."""
    global _cache
    if _override is not None:
        return _override
    if _cache is None:
        path = os.environ.get("HEAT_CHIP_CALIBRATION")
        _cache = from_calibration(path) if path else DEFAULT
    return _cache


def override(model: Optional[ChipModel]) -> None:
    """Plan with ``model`` (what-if planning, tests); None goes back to the
    environment's. Flushes the registered planner caches either way."""
    global _override, _cache
    _override = model
    _cache = None
    for clear in _dependent_caches:
        clear()
