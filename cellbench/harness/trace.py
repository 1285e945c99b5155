"""The profiled stretch of a ``--trace 1`` run, and interval arithmetic
for the readers.

``Stretch`` runs ``torch.profiler`` (CPU and CUDA activities, CUPTI on
the card) over a steady run of whole units of the window, marked by a
``record_function`` annotation: the annotation's host interval is the
stretch, and every unit in it ends in a synchronisation, so the device
work of its units lies inside it. ``summary`` gives the device operations
and the host operations of the stretch as ``(name, start_s, end_s)``,
seconds from the stretch's start.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

MARK = "cellbench.stretch"
COPY_PREFIXES = ("Memcpy", "Memset")

Interval = Tuple[str, float, float]


class Stretch:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.prof = None
        self.mark = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = record_function(MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self, host: bool = True) -> dict:
        """``{"seconds", "device", "host"}``: the stretch's length and its
        device and host operations, clipped to it (host ones only with
        ``host``)."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        marks = [e for e in events
                 if e.name == MARK and e.device_type == DeviceType.CPU]
        if not marks:
            raise RuntimeError("the profiler recorded no stretch mark")
        t0 = marks[0].time_range.start
        t1 = marks[0].time_range.end
        dev: List[Interval] = []
        cpu: List[Interval] = []
        for e in events:
            if e.name == MARK:
                continue
            s, f = e.time_range.start, e.time_range.end
            if f <= t0 or s >= t1:
                continue
            item = (e.name, (max(s, t0) - t0) / 1e6, (min(f, t1) - t0) / 1e6)
            if e.device_type == DeviceType.CUDA:
                dev.append(item)
            elif host and e.device_type == DeviceType.CPU:
                cpu.append(item)
        return {"seconds": (t1 - t0) / 1e6, "device": dev, "host": cpu}


class Profiled:
    """The profiled stretch of a traced run's window: units ``skip`` to
    ``skip + units`` of the mix's ``profile`` (the window's numbering), the
    program's counts over them and the owned point-steps they did. A loop
    calls ``before(i)`` ahead of unit ``i`` and ``after(i, point_steps)``
    once it is done; ``pending`` holds the window open past ``--seconds``
    until the stretch is whole."""

    def __init__(self, ctx, counters):
        prof = ctx.cell.mix.get("profile", {})
        self.lo = int(prof.get("skip", 0))
        self.hi = self.lo + int(prof.get("units", 0))
        self.on = ctx.trace and self.hi > self.lo
        self.device = ctx.device
        self.counters = counters
        self.stretch = None
        self.first = self.last = None
        self.point_steps = 0
        self.counts = {}

    @property
    def pending(self) -> bool:
        return self.on and self.last is None

    def before(self, index: int) -> None:
        if self.on and index == self.lo and self.stretch is None:
            self.stretch = Stretch(self.device)
            self.stretch.start()
            self.first = index
            self.counts = self.counters()

    def after(self, index: int, point_steps: int) -> None:
        if self.stretch is None or self.last is not None:
            return
        self.point_steps += point_steps
        if index + 1 >= self.hi:
            self.close(index + 1)

    def close(self, end: int) -> None:
        """End the stretch after unit ``end - 1`` (the window closed)."""
        if self.stretch is None or self.last is not None:
            return
        self.stretch.stop()
        self.last = end
        after = self.counters()
        self.counts = {k: after[k] - self.counts.get(k, 0) for k in after}

    def info(self, unit_points: int):
        """What the run's report needs of the stretch, or None."""
        if self.stretch is None:
            return None
        return {"stretch": self.stretch, "units": self.last - self.first,
                "point_steps": self.point_steps, "unit_points": unit_points,
                "counters": self.counts}


def warm(device: torch.device) -> None:
    """One short profiled run in set-up: the profiler's first start
    (CUPTI's initialisation on the card) takes seconds, which would
    otherwise fall into the window."""
    s = Stretch(device)
    s.start()
    torch.ones(1024, device=device).sum().item()
    s.stop()
    s.summary(host=False)


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def kernels(device: Iterable[Interval], contains: str = "") -> List[Interval]:
    """The kernels among device operations (not copies or fills), those
    whose name contains ``contains`` (case-insensitive) where given."""
    key = contains.lower()
    return [e for e in device if not is_copy(e[0]) and key in e[0].lower()]


def union_seconds(intervals: Iterable[Interval]) -> float:
    """Seconds covered by at least one interval."""
    spans = sorted((s, f) for _, s, f in intervals if f > s)
    total, cur_s, cur_f = 0.0, None, None
    for s, f in spans:
        if cur_f is None or s > cur_f:
            if cur_f is not None:
                total += cur_f - cur_s
            cur_s, cur_f = s, f
        else:
            cur_f = max(cur_f, f)
    if cur_f is not None:
        total += cur_f - cur_s
    return total


def busy_seconds(intervals: Iterable[Interval]) -> float:
    """Summed durations (overlaps counted each time)."""
    return float(sum(f - s for _, s, f in intervals))


def gaps(intervals: Sequence[Interval], seconds: float) -> List[Tuple[float, float]]:
    """The stretch's spans of ``[0, seconds]`` that no interval covers."""
    out, t = [], 0.0
    for s, f in sorted((s, f) for _, s, f in intervals):
        if s > t:
            out.append((t, s))
        t = max(t, f)
    if seconds > t:
        out.append((t, seconds))
    return out


def label_gaps(gap_list: Sequence[Tuple[float, float]],
               host: Sequence[Interval], longest: int = 256) -> dict:
    """``{host operation: idle seconds}`` over the ``longest`` gaps, each
    named by the innermost host operation running at its middle
    (``python`` where the profiler recorded none)."""
    if not gap_list:
        return {}
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host], dtype=np.float64)
    ends = np.array([h[2] for h in host], dtype=np.float64)
    out: dict = {}
    for s, f in sorted(gap_list, key=lambda g: g[0] - g[1])[:longest]:
        mid = 0.5 * (s + f)
        name = "python"
        if len(names):
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            if inside.size:
                name = names[inside[np.argmin(ends[inside] - starts[inside])]]
        out[name] = out.get(name, 0.0) + (f - s)
    return out


def top(items: dict, count: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:count]]


def by_name(intervals: Iterable[Interval]) -> dict:
    out: dict = {}
    for name, s, f in intervals:
        out[name] = out.get(name, 0.0) + (f - s)
    return out

