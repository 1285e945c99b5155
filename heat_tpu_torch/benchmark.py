"""Headline benchmark core: grid points/s/card of the f32 ``ftcs2d`` kernel.

One measurement definition, two front doors: ``python -m
heat_tpu_torch.bench`` (supervised subprocess, retries under one wall
budget, one JSON line) and ``python -m heat_tpu_torch bench`` (inline).
Both report the overhead-corrected two-point rate with the raw
single-call rate beside it (``runtime/timing.two_point_rate``, CUDA events
on the card). The port of ``heat_tpu/benchmark.py``.

The shape is the reference's single-GPU benchmark's (python/cuda/cuda.py:
4096^2, 10k steps; 8192 steps here have the same steady per-step cost),
through the ``cuda`` backend's advance: 16-step ``ftcs2d`` passes, 512 a
call. ``vs_baseline`` divides by the card's one-pass-per-step bound, its
data-sheet memory rate over 2 * 4 bytes a point (each step reads and
writes the f32 field once: 4.1875e11 points/s on an H100 SXM). A
temporally blocked kernel reads the field once per 16 steps, so it can
and does read above 1: the number says how far the design beats every
one-launch-per-step implementation, not what share of the card's bound
the kernel reaches (that is ``machine.DeviceModel.pass_bound_s``).
"""

from __future__ import annotations

N = 4096
STEPS = 8192
REPEATS = 3
ITEMSIZE = 4  # f32


def metric_name(n: int = N) -> str:
    return f"grid_points_per_sec_per_chip_{n}x{n}_f32_cuda"


def headline_config(n: int = N, steps: int = STEPS):
    """The measured configuration: the ``hat`` IC at the default sigma,
    frozen edges, f32, the ``cuda`` backend."""
    from .config import HeatConfig

    return HeatConfig(n=n, ntime=steps, dtype="float32", ic="hat",
                      backend="cuda")


def headline_advance(cfg, device):
    """(x, advance, warm) of ``cfg``: the initial field on ``device`` and
    the ``cuda`` backend's ``make_advance`` pair."""
    import torch

    from .backends.cuda import make_advance
    from .grid import initial_condition

    x = torch.from_numpy(initial_condition(cfg).astype("float32")).to(device)
    advance, warm = make_advance(cfg)
    return x, advance, warm


def one_pass_bound(device, itemsize: int = ITEMSIZE) -> tuple:
    """(points/s, label): the card's one-pass-per-step bound for a field of
    ``itemsize`` bytes a point, and what it is; (None, label) on the CPU or
    on a card without published rates."""
    import torch

    if torch.device(device).type != "cuda":
        return None, "cpu (no published roofline)"
    from .machine import device_model

    dm = device_model(device)
    if dm.peaks is None:
        return None, f"{dm.name} (no published peak rates)"
    rate = dm.peaks.hbm_bytes_per_s / (2 * itemsize)
    return rate, (f"{dm.name}: one-pass HBM bound "
                  f"{dm.peaks.hbm_bytes_per_s / 1e12:.2f} TB/s / "
                  f"{2 * itemsize} B a point ({dm.peaks.source})")


def headline_measure(n: int = N, steps: int = STEPS, repeats: int = REPEATS,
                     device=None) -> dict:
    """Run the headline measurement on ``device`` (default the card; raises
    without one) and return the record ``bench`` prints as JSON."""
    from .backends import resolve_device
    from .backends.cuda import kernel_label
    from .labs._util import stamp
    from .ops import cuda_stencil
    from .runtime.timing import sync, two_point_rate

    device = resolve_device(device)
    cfg = headline_config(n, steps)
    x, advance, warm = headline_advance(cfg, device)
    warm(x.clone(), steps)  # builds and loads the library, first launches
    sync(x)
    before = cuda_stencil.launches["ftcs2d"]
    tp = two_point_rate(lambda t: advance(t, steps), x, n * n * steps,
                        repeats=repeats)
    pts_per_s, raw = tp
    # every call is alike: the protocol's warm call, then 3 per repeat
    calls = 1 + 3 * repeats
    launches = cuda_stencil.launches["ftcs2d"] - before
    bound, label = one_pass_bound(device)
    where = stamp(device)
    card = where.pop("card")
    return {
        "metric": metric_name(n),
        "value": pts_per_s,
        "unit": "points/s",
        "vs_baseline": None if bound is None else pts_per_s / bound,
        "raw_single_call": raw,
        "platform": device.type,
        "baseline_chip": label,
        "kernel": kernel_label(cfg, device),
        "launches_per_call": launches // calls,
        "calls": calls,
        "two_point_fell_back": tp.fell_back,
        "n": n, "steps": steps, "repeats": repeats,
        "device": card["name"] if card else "cpu",
        "smi": card["smi"] if card else None,
        **where,
    }
