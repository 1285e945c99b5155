"""Wall-clock timing and throughput accounting.

The reference uses two timing styles: ``cpu_time`` around everything
including IO (fortran/serial/heat.f90:25,71) and barrier-bracketed
``MPI_Wtime`` around the solve only, reported as *average seconds per
timestep* (fortran/mpi+cuda/heat.F90:253,264,292). We report all three,
labelled correctly, plus the derived grid-points/sec metric.

``torch.cuda.synchronize`` stands in for the device sync + MPI barrier
pair: a CUDA launch returns before the device has run it, so every host
clock reading around device work follows a ``sync``.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def sync(x=None):
    """Block until the device work queued so far is done
    (== cudaDeviceSynchronize before reading the clock,
    fortran/mpi+cuda/heat.F90:262-264). A no-op for host tensors."""
    if isinstance(x, torch.Tensor) and x.device.type != "cuda":
        return x
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return x


class TwoPointResult(tuple):
    """(rate_corrected, rate_raw) that also carries ``fell_back`` — True
    when the noise-floor fallback fired and corrected IS the raw rate."""

    fell_back: bool

    def __new__(cls, rate: float, raw: float, fell_back: bool):
        self = super().__new__(cls, (rate, raw))
        self.fell_back = fell_back
        return self

    def __getnewargs__(self):
        return (self[0], self[1], self.fell_back)


def two_point_rate(call, x, work, repeats: int = 2, fence=None):
    """(rate_corrected, rate_raw) for ``call`` doing ``work`` units/call.

    One call (T1) and two back-to-back calls (T2) are timed; a fixed
    per-measurement cost cancels in T2-T1. When T2-T1 < 20% of T1 the
    measurement is overhead-dominated and the raw single-call rate is
    returned instead, flagged on ``fell_back``. The output is recycled as
    the next input (timing does not care about values).

    A tensor on the card is timed with CUDA events on the current stream.
    Anything else (a CPU tensor, or a state spread over several devices,
    where ``fence`` waits for all of it) is timed by the host clock around
    the calls, each measurement ended by ``fence`` (default ``sync``): the
    reference's protocol.
    """
    x = call(x)  # warm
    if fence is None and getattr(x, "device", None) is not None \
            and x.device.type == "cuda":
        sync(x)
        best1 = best2 = float("inf")
        for _ in range(repeats):
            e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
            e0.record()
            x = call(x)
            e1.record()
            x = call(call(x))
            e2.record()
            e2.synchronize()
            best1 = min(best1, e0.elapsed_time(e1) / 1e3)
            best2 = min(best2, e1.elapsed_time(e2) / 1e3)
    else:
        fence = fence or sync
        fence(x)
        best1 = best2 = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            x = call(x)
            fence(x)
            best1 = min(best1, time.perf_counter() - t0)
            t0 = time.perf_counter()
            x = call(call(x))
            fence(x)
            best2 = min(best2, time.perf_counter() - t0)
    raw = work / best1
    diff = best2 - best1
    if diff <= 0.2 * best1:
        return TwoPointResult(raw, raw, fell_back=True)
    return TwoPointResult(work / diff, raw, fell_back=False)


@dataclasses.dataclass
class Timing:
    total_s: float = 0.0          # everything: setup + build + solve + IO
    compile_s: float = 0.0        # kernel build + warmup launches
    solve_s: float = 0.0          # solve-only wall clock
    steps: int = 0
    points: int = 0               # grid points updated per step
    # The overhead-corrected rate of the two-point protocol
    # (``two_point_rate``) over the solve's chunk, run on a copy of the
    # final state when the solve asked for ``two_point_repeats > 0``; None
    # otherwise. ``two_point_fell_back`` is True where the protocol's noise
    # floor fired and the rate above is the raw single-call one (a rate
    # ``calibrate`` must not fit), None where it did not run.
    points_per_s_two_point: float | None = None
    two_point_fell_back: bool | None = None
    # Async I/O pipeline accounting (None when no async writer ran):
    # overlap_s is the checkpoint D2H + disk wall time hidden behind
    # compute, io_wait_s what the drive loop paid (backpressure + final drain).
    overlap_s: float | None = None
    io_wait_s: float | None = None
    # Which stepping body ran: "cuda ftcs2d" for the hand-written kernel,
    # "ftcs2d plain version (cpu)" for its plain version in a CPU solve,
    # "torch-step" for the plain PyTorch step, "torch-step (f64)" where the
    # cuda backend takes the torch step because the kernel has no f64 path.
    kernel: str | None = None

    @property
    def per_step_s(self) -> float:
        return self.solve_s / self.steps if self.steps else 0.0

    @property
    def points_per_s(self) -> float:
        return self.points * self.steps / self.solve_s if self.solve_s > 0 else 0.0

    def report_lines(self) -> list[str]:
        """Human-readable report, keeping the reference's familiar lines."""
        lines = [
            "simulation completed!!!!",                       # serial/heat.f90:73
            f"total time: {self.total_s:.6f}",                # serial/heat.f90:74
            f"solve time: {self.solve_s:.6f}",
            f"Average time per timestep: {self.per_step_s:.9f}",  # hip/heat.F90:323
            f"throughput: {self.points_per_s:.4g} points/s",
        ]
        if self.compile_s:
            lines.insert(2, f"compile time: {self.compile_s:.6f}")
        if self.kernel is not None:
            lines.append(f"kernel: {self.kernel}")
        if self.overlap_s is not None:
            lines.append(f"async I/O overlap: {self.overlap_s:.6f} hidden, "
                         f"{self.io_wait_s or 0.0:.6f} blocked")
        return lines
