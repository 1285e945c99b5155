"""Numerics checking and the profiler hook.

The debug mode that matters for an explicit stencil is *numerics*: catching
NaN/Inf blow-ups (e.g. sigma above the FTCS stability bound) at the step
where they appear instead of in the final output. Profiling upgrades the
reference's two wall-clock timers to a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], device=None):
    """Wrap a region in a ``torch.profiler`` trace when a directory is
    given; the Chrome trace lands in ``trace_dir/trace.json``."""
    if not trace_dir:
        yield
        return
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))


def finite_flag(T):
    """All-finite reduction WITHOUT blocking the host on it.

    A tensor reduces on its own device and the 0-d bool tensor is returned
    still there: the caller holds it and reads it at the NEXT chunk
    boundary (``raise_if_flagged``), by which point the device has
    computed it behind the following chunk's work. Host arrays reduce
    eagerly (nothing to overlap)."""
    if isinstance(T, torch.Tensor):
        return torch.isfinite(T).all()
    return np.isfinite(np.asarray(T).astype(np.float32)).all()


def raise_if_flagged(flag, step: int, label: str = "field") -> None:
    """Read a ``finite_flag`` result (one scalar) and raise with the step
    context the flag was computed at."""
    if not bool(flag):
        raise FloatingPointError(
            f"non-finite values in {label} at step {step} — check the CFL "
            f"bound sigma <= 1/(2*ndim) and the fuse/halo configuration"
        )


def check_finite(T, step: int, label: str = "field") -> None:
    """Synchronous form: compute the flag and block on it immediately."""
    raise_if_flagged(finite_flag(T), step, label)
