"""One run of one cell: set-up, the measured window, the readings, the
comparison that decides ``correct``, and the result line.

Every rank of a world runs ``run``; rank 0 assembles and returns the
result, the others return None. The order after the window: the peak of
device memory is read, each rank summarises its profiled stretch and
counts, the loop frees the program's state and its reference checks the
program's output, and only then is ``sys.modules`` looked at.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Optional

import torch

from cellbench.harness import spec, trace, world

# top-level module names that may not be loaded in a run (compared whole:
# ``heat_tpu_torch`` is the program, ``heat_tpu`` the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "heat_tpu")
BREAKDOWN_ENTRIES = 10


@dataclasses.dataclass
class Ctx:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    dtype: Optional[str] = None   # the control's precision, else the config's


class Run:
    """What a metric's reader reads: ``units`` (rank 0's units of work in
    the window, each ``{"kind", "k", "points", "wall", "solve_s"}``),
    ``seconds`` (the window), ``counters`` (rank 0's counts over the
    window), ``ranks`` (per rank: ``counters`` and, in a traced run,
    ``stretch``: ``seconds``, ``device`` and ``host`` operations, ``units``,
    ``point_steps`` and ``unit_points`` owned by the rank, ``counters``),
    ``config``, ``mix``, ``card``, ``peak`` (the card's row of
    ``peaks.json``, or None)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({e})"


def _rank_report(ctx: Ctx, win: dict) -> dict:
    rep = {"counters": win["counters"], "peak": 0, "stretch": None}
    if ctx.device.type == "cuda":
        rep["peak"] = int(torch.cuda.max_memory_allocated(ctx.device))
    info = win.get("stretch")
    if info:
        summary = info["stretch"].summary(host=world.rank() == 0)
        rep["stretch"] = dict(summary, units=info["units"],
                              point_steps=info["point_steps"],
                              unit_points=info["unit_points"],
                              counters=info["counters"])
    return rep


def _breakdown(ranks: list) -> dict:
    """The device operations that took most time (seconds a card, over
    the cards) and rank 0's longest idle gaps by the host operation
    running in them."""
    stretches = [r["stretch"] for r in ranks if r["stretch"]]
    ops: dict = {}
    for s in stretches:
        for name, sec in trace.by_name(s["device"]).items():
            ops[name[:160]] = ops.get(name[:160], 0.0) + sec / len(stretches)
    s0 = stretches[0]
    idle = trace.label_gaps(trace.gaps(trace.kernels(s0["device"]),
                                       s0["seconds"]), s0["host"])
    return {"device_ops": trace.top(ops, BREAKDOWN_ENTRIES),
            "idle_gaps": trace.top({k[:160]: v for k, v in idle.items()},
                                   BREAKDOWN_ENTRIES)}


def run(ctx: Ctx, t_start: float) -> Optional[dict]:
    cell = ctx.cell
    loop = spec.loop(cell)
    state = loop.setup(ctx)
    if ctx.trace:
        trace.warm(ctx.device)
    world.barrier()
    setup_s = time.perf_counter() - t_start
    win = loop.window(ctx, state)
    t_compare = time.perf_counter()
    report = _rank_report(ctx, win)
    compared = loop.compare(ctx, state, win)
    del state
    if world.rank() == 0:
        print(f"cellbench: setup {setup_s:.3f} s, window {win['seconds']:.3f} s "
              f"({len(win['units'])} units), readings and compare "
              f"{time.perf_counter() - t_compare:.3f} s", file=sys.stderr)
        walls = sorted(u["wall"] for u in win["units"])
        if len(walls) >= 4:
            q = statistics.quantiles(walls, n=4)
            print(f"cellbench: unit wall median {q[1]!r} s, quartiles "
                  f"{q[0]!r} {q[2]!r}, solve_s median "
                  f"{statistics.median(u['solve_s'] for u in win['units'])!r} s",
                  file=sys.stderr)
        st = report["stretch"]
        if st:
            print(f"cellbench: stretch {st['seconds']:.3f} s, {st['units']} "
                  f"units, {len(st['device'])} device and {len(st['host'])} "
                  f"host operations", file=sys.stderr)
    report["forbidden"] = forbidden_modules()
    reports = world.gather_objects(report)
    if world.rank() != 0:
        return None
    on_card = ctx.device.type == "cuda"
    card = torch.cuda.get_device_name(ctx.device) if on_card else "cpu"
    r = Run(units=win["units"], seconds=win["seconds"],
            counters=win["counters"], ranks=reports, config=cell.config,
            mix=cell.mix, card=card, peak=spec.peak(card, cell.root))
    metrics = {}
    if on_card:
        wanted = cell.per_layer if ctx.trace else cell.end_to_end
        reads = spec.readers(cell, wanted)
        for m in wanted:
            value = setup_s if m["name"] == "setup_s" else reads[m["name"]](r)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell.limits["compared"]
    checks = {}
    for name, lim in limits.items():
        value = compared.get(name, math.inf)
        checks[name] = {"value": value, "limit": lim["limit"]}
    correct = (win["failed"] == 0 and bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    device = {"platform": "gpu" if on_card else "cpu", "kind": card,
              "count": world.size() if on_card else 0,
              "memory_peak_bytes": max(rp["peak"] for rp in reports)}
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": device}
    stretches = [rp["stretch"] for rp in reports if rp["stretch"]]
    if ctx.trace and stretches and on_card:
        device["busy_s"] = sum(trace.union_seconds(s["device"])
                               for s in stretches) / len(stretches)
        device["window_s"] = stretches[0]["seconds"]
        result["breakdown"] = _breakdown(reports)
    if on_card:
        print(f"card: {card_line(ctx.device)}", file=sys.stderr, flush=True)
    # last, once the readers are loaded too: this process and every rank
    found = sorted(set(forbidden_modules()).union(
        *(r["forbidden"] for r in reports)))
    if found:
        raise SystemExit(f"cellbench: modules that may not load were loaded "
                         f"after the window: {', '.join(found)}")
    result["compared"] = checks
    return result


def print_result(result: dict) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    # a gap that is not finite has no JSON number: null, and not correct
    for c in result["compared"].values():
        if not math.isfinite(c["value"]):
            c["value"] = None
    print(json.dumps(result), flush=True)
