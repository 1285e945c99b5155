"""A resident field stepped segment by segment: the sharded backend's
padded-carry state, built in set-up the way
``heat_tpu_torch.backends.sharded.solve`` builds it (``make_comm``,
``make_local_multistep``, ``_chunked_advance``, the seeded initial field
as each shard's block), and driven by ``backends.common.drive`` one
segment at a time with no fetch (the deployment dumps no solution).

Segments are whole fused blocks of ``kf`` steps that continue one solve of
the configuration's ``ntime`` steps; a solve's last segment ends at its
last step (with the remainder block), and the next segment starts a new
solve from the initial field kept in set-up. The window's first segment
and its last are ``check_blocks`` long: the reference checks the first
from the initial field it makes itself, and the last from the program's
own state before it. The last is the one rank 0 starts once another
normal segment would end past ``--seconds``; a traced run goes on until
its profiled stretch is whole.

Mix keys: ``program`` (``HeatConfig`` options: backend, comm, exchange,
mesh_shape), ``ranks`` (processes of the world, one card each),
``segment_blocks``, ``check_blocks``, ``profile`` (the window's units
``skip`` to ``skip + units`` profiled in a traced run).

A unit of the window is one segment: its wall is the host clock around
its ``drive`` call, which ends with every rank synchronised.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cellbench.harness import ic, program, spec, world
from cellbench.harness.trace import Profiled


class State:
    pass


def setup(ctx) -> State:
    from heat_tpu_torch.backends.common import drive
    from heat_tpu_torch.backends.sharded import (SHARD_OPS, ShardField,
                                                 _chunked_advance,
                                                 fuse_depth_sharded,
                                                 make_comm,
                                                 make_local_multistep,
                                                 resolve_local_kernel)
    from heat_tpu_torch.parallel.halo import halo_pad
    from heat_tpu_torch.parallel.mesh import validate_divisible
    from heat_tpu_torch.utils import torch_dtype

    cell = ctx.cell
    st = State()
    cfg = st.cfg = program.heat_config(cell.config, cell.mix, ctx.dtype)
    comm = st.comm = make_comm(cfg, ctx.device)
    mesh = comm.mesh
    validate_divisible(cfg.n, mesh)
    kf = st.kf = fuse_depth_sharded(cfg, mesh.shape)
    padded = [cfg.n // s + 2 * kf for s in mesh.shape]
    kernel = resolve_local_kernel(cfg, comm, padded)
    padded_multi = make_local_multistep(cfg, comm, kernel)
    st.advance, st.warm = _chunked_advance(
        lambda shards, k: padded_multi(shards, kf, k), kf)
    st.blocks = [mesh.block(r, cfg.n) for r in comm.ranks]
    dt = torch_dtype(cfg.dtype)
    st.ic_owned = [ic.field(cell.config["ic"], ctx.seed, 0, cfg.n, cfg.ndim,
                            block=b, device=d).to(dt)
                   for b, d in zip(st.blocks, comm.devices)]
    st.fresh = lambda: ShardField(
        [halo_pad(o, cfg.bc_value, kf) for o in st.ic_owned], comm, cfg.n, kf)

    def segment(F, k: int):
        res = drive(cfg.with_(ntime=k), F, st.advance, st.warm,
                    ops=SHARD_OPS, fetch=False)
        return res.T_dev, res.timing.solve_s

    st.segment = segment
    # one segment with a full block and the solve's remainder block: the
    # kernel library, both pass depths, the exchange's communicators
    segment(st.fresh(), kf + cfg.ntime % kf)
    return st


def window(ctx, st: State) -> dict:
    cfg, kf = st.cfg, st.kf
    seg_steps = int(ctx.cell.mix["segment_blocks"]) * kf
    chk_steps = int(ctx.cell.mix["check_blocks"]) * kf
    owned = cfg.points // world.size()
    prof = Profiled(ctx, lambda: program.counters(st.comm))
    units = []
    c0 = program.counters(st.comm)

    def run(F, k):
        ts = time.perf_counter()
        F, solve_s = st.segment(F, k)
        units.append({"kind": "segment", "k": k, "points": cfg.points,
                      "wall": time.perf_counter() - ts, "solve_s": solve_s})
        return F

    F = st.fresh()
    step = 0
    world.barrier()
    t0 = time.perf_counter()
    k = min(chk_steps, cfg.ntime)
    F = run(F, k)
    step += k
    st.first = ([o.clone(memory_format=torch.contiguous_format)
                 for o in F.owned()], k)
    normal_wall = units[-1]["wall"] * seg_steps / k
    index = 1   # the window's units: the first check segment is 0
    while True:
        final = None
        if world.rank() == 0:
            final = int(time.perf_counter() - t0 + normal_wall >= ctx.seconds
                        and not prof.pending)
        final = world.broadcast_int(final)
        if step >= cfg.ntime:
            F = st.fresh()
            step = 0
        k = min(chk_steps if final else seg_steps, cfg.ntime - step)
        if final:
            st.last = ([o.clone(memory_format=torch.contiguous_format)
                        for o in F.owned()], k)
        prof.before(index)
        F = run(F, k)
        step += k
        prof.after(index, k * owned)
        index += 1
        if final:
            break
        if k == seg_steps:
            normal_wall = units[-1]["wall"]
    seconds = time.perf_counter() - t0
    prof.close(index)
    st.final = F
    return {"units": units, "seconds": seconds, "attempted": len(units),
            "failed": 0,
            "counters": program.delta(program.counters(st.comm), c0),
            "stretch": prof.info(owned)}


def _whole(st: State, blocks_owned):
    """The whole field from this process's owned blocks: on rank 0 of a
    world (gathered), or in this process; None on other ranks."""
    n = st.cfg.n
    if world.size() > 1:
        return world.gather_blocks(blocks_owned[0], st.blocks[0], n)
    head = blocks_owned[0].device
    out = torch.empty((n,) * blocks_owned[0].dim(), dtype=blocks_owned[0].dtype,
                      device=head)
    for b, o in zip(st.blocks, blocks_owned):
        out[b] = o.to(head)
    return out


def _max_abs(got, want) -> float:
    err = (got.float() - want).abs().max().item()
    return err if np.isfinite(err) else float("inf")


def compare(ctx, st: State, win: dict) -> dict:
    """The first segment from the initial field, and the last from the
    program's state before it, each against the reference over the whole
    field: the widest gap over every cell."""
    if ctx.device.type == "cuda":
        # the allocator's cache back to the card: the gather's buffers and
        # the communicators allocate outside it
        torch.cuda.empty_cache()
    first = _whole(st, st.first[0])
    last_in = _whole(st, st.last[0])
    final = _whole(st, [o.contiguous() for o in st.final.owned()])
    del st.first[0][:], st.last[0][:], st.final, st.ic_owned
    if world.rank() != 0:
        return {}
    if first.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = spec.reference(ctx.cell)
    cfg = st.cfg
    x = ic.field(ctx.cell.config["ic"], ctx.seed, 0, cfg.n, cfg.ndim,
                 device=first.device)
    out = {"first_segment_max_abs": _max_abs(first, ref.run(ctx.cell.config,
                                                            x, st.first[1]))}
    del x, first
    out["last_segment_max_abs"] = _max_abs(
        final, ref.run(ctx.cell.config, last_in.float(), st.last[1]))
    return out
