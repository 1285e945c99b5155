"""Closed loop, one client: back-to-back whole solves through the port's
entry, ``heat_tpu_torch.backends.solve(cfg, T0=ic)``, each from an initial
field on the host to its final field on the host.

Mix keys: ``program`` (the ``HeatConfig`` options of the deployment's
backend), ``distinct_ics`` (seeded initial fields made in set-up; the
solves cycle through them), ``compare_sample`` (how many finished solves,
drawn from the seed by reservoir sampling over the whole window, the
reference checks), ``profile`` (``skip`` solves, then ``units`` solves in
the profiled stretch of a traced run, which runs on past ``--seconds``
until its stretch is whole).

A unit of the window is one solve: its wall is the host clock from the
call, with the initial field on the host, to the final field on the host.
"""

from __future__ import annotations

import random
import time
import traceback

import numpy as np
import torch

from cellbench.harness import ic, program, spec
from cellbench.harness.trace import Profiled


class State:
    def __init__(self, cfg, ics):
        self.cfg = cfg
        self.ics = ics
        self.sample = []


def setup(ctx) -> State:
    from heat_tpu_torch import backends

    cell = ctx.cell
    cfg = program.heat_config(cell.config, cell.mix, ctx.dtype)
    # the initial fields: built on the device in large calls, then held
    # on the host, where a user's field starts
    ics = [ic.field(cell.config["ic"], ctx.seed, j, cfg.n, cfg.ndim,
                    device=ctx.device).cpu().numpy()
           for j in range(int(cell.mix["distinct_ics"]))]
    # one whole solve of the cell's shape: the kernel library loads, every
    # pass depth launches once, the allocator holds the solve's buffers
    backends.solve(cfg, T0=ics[0], device=ctx.device)
    return State(cfg, ics)


def window(ctx, st: State) -> dict:
    from heat_tpu_torch import backends

    cfg = st.cfg
    keep = int(ctx.cell.mix["compare_sample"])
    rng = random.Random(f"{ctx.seed}:compare_sample")
    prof = Profiled(ctx, program.counters)
    units, failed = [], 0
    c0 = program.counters()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < ctx.seconds or prof.pending:
        prof.before(i)
        j = i % len(st.ics)
        ts = time.perf_counter()
        try:
            res = backends.solve(cfg, T0=st.ics[j], device=ctx.device)
        except Exception:
            traceback.print_exc()
            failed += 1
            break
        te = time.perf_counter()
        units.append({"kind": "solve", "k": cfg.ntime, "points": cfg.points,
                      "wall": te - ts, "solve_s": res.timing.solve_s})
        # reservoir sampling: every finished solve equally likely kept
        if len(st.sample) < keep:
            st.sample.append((i, j, res.T))
        else:
            slot = rng.randrange(i + 1)
            if slot < keep:
                st.sample[slot] = (i, j, res.T)
        del res
        prof.after(i, cfg.points * cfg.ntime)
        i += 1
    seconds = time.perf_counter() - t0
    prof.close(i)
    return {"units": units, "seconds": seconds, "attempted": i + failed,
            "failed": failed, "counters": program.delta(program.counters(), c0),
            "stretch": prof.info(cfg.points)}


def compare(ctx, st: State, win: dict) -> dict:
    """The final fields of the sampled solves against the reference run
    on the same initial fields: the widest gap over every cell."""
    if not st.sample:
        return {"final_field_max_abs": float("inf")}
    ref = spec.reference(ctx.cell)
    dev = ctx.device
    x = torch.stack([torch.from_numpy(st.ics[j]) for _, j, _ in st.sample]).to(dev)
    want = ref.run(ctx.cell.config, x, st.cfg.ntime)
    del x
    got = torch.stack([torch.from_numpy(np.asarray(T, dtype=np.float32))
                       for _, _, T in st.sample]).to(dev)
    err = (got - want).abs().max().item()
    return {"final_field_max_abs": err if np.isfinite(err) else float("inf")}
