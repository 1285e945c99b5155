"""Shared device-side solve loop: chunked with heartbeat,
checkpointing, numerics checks and timing.

The reference's hot loop is a host loop launching one kernel per step
(fortran/cuda_kernel/heat.F90:30-34). Here the host calls ``advance(T, k)``
once per *chunk* of steps — the steps between two host-visible events
(heartbeat, checkpoint) — and each backend's ``advance`` queues that chunk's
launches without waiting for the device. The cuda backend swaps two field
buffers between passes (replacing the per-step ``T_old_d = T_d`` device
copy at fortran/cuda_kernel/heat.F90:32).

Counterpart of ``heat_tpu.backends.common``. Before the timed region, the
warm-up builds the kernel library and runs each pass depth of each chunk
size once on a copy, so no build or first-launch cost lands in ``solve_s``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import HeatConfig
from ..runtime import async_io, checkpoint, debug, faults
from ..runtime import trace as trace_mod
from ..runtime.logging import master_print
from ..runtime.timing import Timing, sync, two_point_rate
from ..utils import torch_dtype
from . import SolveResult
from . import pinned

# --on-nan rollback: how many times the same flagged step may be retried
# before the blow-up is declared deterministic (a genuine CFL violation
# reproduces identically; a soft-error/injected NaN does not).
_MAX_ROLLBACKS_PER_STEP = 2


def host_fetch(x) -> np.ndarray:
    """A host copy of a tensor (numpy), bf16 widened to f32 exactly. Always
    a copy: the drive loop's buffers are reused after the fetch."""
    if not isinstance(x, torch.Tensor):
        # heat-tpu: allow[hot-path-purity] the drive loop's D2H seam itself
        return np.array(x)
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.float()
    # heat-tpu: allow[hot-path-purity] the drive loop's D2H seam itself
    return t.numpy()


# the host dtypes a field is uploaded from
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.float16): torch.float16}


def _transfer(pool: pinned.PinnedPool, path: str, copy: Callable):
    """``copy()`` inside the span of ``path``, one of ``pinned.PATHS``,
    counted in ``pool``'s tally."""
    span = trace_mod.TRANSFER_PATHS[path]
    tracer = trace_mod.get_tracer()
    t0 = tracer.begin(span)
    out = copy()
    tracer.end(span, t0)
    pool.count(path)
    return out


def fetch_field(x, pool: Optional[pinned.PinnedPool] = None):
    """``drive``'s fetch: ``(host copy, pinned)``. A whole field of at
    least ``pinned.MIN_BYTES`` on the pool's device is copied by DMA into
    a buffer lent by ``pool`` (default ``pinned.POOL``) and returned as
    the array over that buffer, which goes back to the pool when the
    caller's last reference to the array or a view of it goes; bf16 is
    widened on the device, exactly, as ``host_fetch`` widens it on the
    host. Anything else, or a pool that declines, takes ``host_fetch``."""
    pool = pinned.POOL if pool is None else pool
    if isinstance(x, torch.Tensor) and x.device.type == pool.device_type:
        dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        out = (pool.lend("fetch", x.shape, dtype)
               if x.numel() * dtype.itemsize >= pinned.MIN_BYTES else None)
        if out is not None:
            # blocks until the DMA is done
            _transfer(pool, "fetch.pinned",
                      lambda: torch.from_numpy(out).copy_(x.detach().to(dtype)))
            return out, True
    return _transfer(pool, "fetch.pageable", lambda: host_fetch(x)), False


def upload_field(arr: np.ndarray, device,
                 pool: Optional[pinned.PinnedPool] = None):
    """``(tensor on device, pinned)``: a copy of ``arr`` in its own dtype,
    never aliasing it. An array of at least ``pinned.MIN_BYTES`` bound for
    the pool's device is copied (by PyTorch's threaded copy) into a
    staging buffer lent by ``pool`` (default ``pinned.POOL``), and from
    there by one DMA, which the copy waits for, so the staging buffer is
    free again when this returns. Anything else, or a pool that declines,
    takes ``torch.tensor``'s pageable copy."""
    pool = pinned.POOL if pool is None else pool
    dev = torch.device("cpu" if device is None else device)
    dtype = _TORCH_DTYPES.get(arr.dtype)
    stage = (pool.lend("upload", arr.shape, dtype)
             if dev.type == pool.device_type and dtype is not None
             and arr.nbytes >= pinned.MIN_BYTES else None)
    if stage is None:
        return _transfer(pool, "upload.pageable",
                         lambda: torch.tensor(arr, device=dev)), False

    def staged():
        if arr.flags.c_contiguous and arr.flags.writeable:
            torch.from_numpy(stage).copy_(torch.from_numpy(arr))
        else:
            np.copyto(stage, arr)
        T = torch.empty(arr.shape, dtype=dtype, device=dev)
        return T.copy_(torch.from_numpy(stage))

    return _transfer(pool, "upload.pinned", staged), True


@dataclasses.dataclass(frozen=True)
class FieldOps:
    """How ``drive`` handles its state. The default is one tensor; the
    sharded backend's state is its shards (``backends.sharded.ShardField``).

    ``sync`` blocks until the state's device work is done (and, across
    processes, until every rank got there) before a clock read;
    ``finite_flag`` is an all-finite flag ``raise_if_flagged`` reads;
    ``gather`` is the whole owned field as one tensor, on any device, or
    None on a rank that does not hold it; ``shard_blocks`` is None where a
    checkpoint is the gathered field, else this rank's owned blocks as
    ``(global start offsets, host tensor)``, saved as its shard file (a
    world of several ranks, the reference's branch for a field that is not
    fully addressable)."""

    sync: Callable[[Any], Any] = sync
    finite_flag: Callable[[Any], Any] = debug.finite_flag
    gather: Callable[[Any], Any] = lambda T: T
    shard_blocks: Callable[[Any], Any] = lambda T: None


TENSOR = FieldOps()


def event_interval(cfg: HeatConfig) -> int:
    """Steps per ``advance`` call: gcd of the host-visible event intervals."""
    ivals = [v for v in (cfg.heartbeat_every, cfg.checkpoint_every) if v > 0]
    if not ivals:
        return max(cfg.ntime, 1)
    g = ivals[0]
    for v in ivals[1:]:
        g = math.gcd(g, v)
    return g


def chunk_sizes(cfg: HeatConfig, remaining: int) -> list[int]:
    """Every step count the drive loop will call ``advance`` with (at most
    two: the steady chunk and a final remainder)."""
    if remaining <= 0:
        return []
    k0 = min(event_interval(cfg), remaining)
    sizes = {k0}
    if remaining % k0:
        sizes.add(remaining % k0)
    return sorted(sizes)


def drive(
    cfg: HeatConfig,
    T_dev: torch.Tensor,
    advance: Callable[[torch.Tensor, int], torch.Tensor],
    warm: Callable[[torch.Tensor, int], None],
    start_step: int = 0,
    kernel: Optional[str] = None,
    ops: FieldOps = TENSOR,
    fetch: bool = True,
    warm_exec: bool = False,
    two_point_repeats: int = 0,
) -> SolveResult:
    """Run ``advance(T, k)`` to ``cfg.ntime``.

    ``warm(T, k)`` runs, on a throwaway copy, each distinct launch that
    ``advance(T, k)`` would make, once: it builds the kernel library and
    takes first-launch costs before the clock starts. So every solve does
    what the reference's ``warm_exec=True`` asks for (one execution of each
    compiled program before the clock); ``warm_exec`` is accepted for
    parity and changes nothing.

    Benchmark mode, as in the reference: ``fetch=False`` skips the final
    device-to-host copy (the result's ``T`` is None), and
    ``two_point_repeats > 0`` also measures the overhead-corrected
    two-point rate (``timing.two_point_rate``) of one chunk on a CLONE of
    the final state, so the solve's result is untouched; it costs one more
    field and 1 + 3 * repeats more chunks.

    Host-visible events run through the asynchronous I/O pipeline by
    default (``cfg.async_io``): a checkpoint boundary costs one on-device
    clone and stepping resumes immediately, with the device-to-host copy and
    the atomic-rename write in a bounded-queue background writer — drained
    on every exit path, writer errors surfaced at the next boundary.
    ``--async-io off`` restores the inline sync -> fetch -> save stall.

    ``ops`` says how the state is synchronised, checked and fetched
    (``FieldOps``); the result's ``T`` is the gathered field on the host,
    None on a rank that does not hold it.
    """
    t_all0 = time.perf_counter()
    chunk = event_interval(cfg)
    remaining = cfg.ntime - start_step
    device = T_dev.device

    # request-scoped tracing (runtime/trace.py): the solo path records
    # into the process-global ring, so `run --trace` puts the upload, the
    # warm-up, the chunk launches, checkpoint snapshots, the writer's
    # D2H+publish spans and the fetch on one timeline, and a recording
    # torch.profiler gets each span's markers
    tracer = trace_mod.get_tracer()
    drv_track = tracer.thread_track("solve") if tracer.enabled else None

    compile_s = 0.0
    if remaining > 0:
        t_c0 = tracer.begin(trace_mod.WARM)
        sizes = chunk_sizes(cfg, remaining)
        for k in sizes:
            warm(T_dev.clone(), k)
            ops.sync(T_dev)
        compile_s = tracer.end(trace_mod.WARM, t_c0,
                               args={"sizes": sizes}) - t_c0

    t0 = tracer.begin(trace_mod.SOLVE)
    step = start_step
    async_on = cfg.use_async_io() and bool(cfg.checkpoint_every
                                           or cfg.check_numerics)
    writer = (async_io.SnapshotWriter(tracer=tracer)
              if async_on and cfg.checkpoint_every else None)
    # pending boundary flag from the async numerics leg:
    # (device scalar, step, snapshot-or-None, deferred-checkpoint?)
    pending_flag = None
    plan = faults.plan_for(cfg)  # None in every normal run
    # --on-nan rollback: one device snapshot of the newest boundary whose
    # finite flag PASSED; a flagged boundary restores it and re-steps.
    rollback = cfg.on_nan == "rollback" and cfg.check_numerics
    last_good = ((async_io.device_snapshot(T_dev), step) if rollback
                 else None)
    rollbacks_at: dict = {}

    def _persist(T, at_step: int, check: bool) -> None:
        """Write boundary ``at_step``: the gathered field, or this rank's
        shard file; with ``check``, a non-finite field never reaches disk."""
        blocks = ops.shard_blocks(T)
        if blocks is None:
            T_ck = ops.gather(T).detach().cpu()
            if check:
                debug.check_finite(T_ck, at_step, label="checkpoint snapshot")
            checkpoint.save(cfg, T_ck, at_step)
            return
        if check:
            for _, b in blocks:
                debug.check_finite(b, at_step, label="checkpoint snapshot")
        checkpoint.save_shards(cfg, blocks, at_step)

    def _submit_snapshot(T_snap, at_step: int) -> None:
        check = cfg.check_numerics
        if tracer.enabled:
            tracer.instant("checkpoint-snapshot", drv_track, cat="solve",
                           args={"step": at_step})

        # the device-to-host copy lands in the writer thread; the writer
        # re-validates the snapshot it is about to persist
        def job():
            _persist(T_snap, at_step, check)

        job._trace = (f"checkpoint @{at_step}", None)
        writer.submit(job)

    def _try_rollback(bad_step: int) -> bool:
        """Restore the last verified-finite boundary after a flagged one;
        False -> no rollback possible/allowed, the caller re-raises."""
        nonlocal T_dev, step
        if not rollback or last_good is None:
            return False
        n = rollbacks_at.get(bad_step, 0)
        if n >= _MAX_ROLLBACKS_PER_STEP:
            master_print(f"on-nan rollback: step {bad_step} flagged again "
                         f"after {n} rollbacks — deterministic blow-up, "
                         f"aborting")
            return False
        rollbacks_at[bad_step] = n + 1
        snap, good = last_good
        master_print(f"on-nan rollback: non-finite field at step {bad_step}; "
                     f"rolling back to verified boundary {good} "
                     f"(attempt {n + 1}/{_MAX_ROLLBACKS_PER_STEP})")
        # a copy: last_good must stay restorable for a second try
        T_dev = async_io.device_snapshot(snap)
        step = good
        return True

    def _settle_pending() -> bool:
        """Async mode: judge the boundary flag posted one chunk ago. True ->
        it flagged and we rolled back (caller continues stepping)."""
        nonlocal pending_flag, last_good
        flag, fstep, snap, is_ckpt = pending_flag
        pending_flag = None
        try:
            debug.raise_if_flagged(flag, fstep)
        except FloatingPointError:
            if _try_rollback(fstep):
                return True
            raise
        if rollback:
            last_good = (snap, fstep)
            if is_ckpt:
                _submit_snapshot(snap, fstep)
        return False

    try:
        with debug.maybe_profile(cfg.profile_dir, device):
            while True:
                while step < cfg.ntime:
                    k = min(chunk, cfg.ntime - step)
                    t_ch = tracer.begin(trace_mod.CHUNK)
                    T_dev = advance(T_dev, k)
                    step += k
                    # dispatch-side span of one launch group: the enqueue
                    # cost, not the device time (the loop never fences)
                    tracer.end(trace_mod.CHUNK, t_ch, args={"k": k},
                               name=f"chunk @{step}" if tracer.enabled
                               else None)
                    if plan is not None:
                        plan.maybe_crash(step)
                        T_dev = plan.maybe_nan(step, T_dev)
                    if cfg.check_numerics:
                        if async_on:
                            if (pending_flag is not None
                                    and _settle_pending()):
                                continue  # rolled back: re-step the chunk
                            pending_flag = (
                                ops.finite_flag(T_dev), step,
                                async_io.device_snapshot(T_dev)
                                if rollback else None,
                                rollback and writer is not None
                                and cfg.checkpoint_every
                                and step % cfg.checkpoint_every == 0)
                        else:
                            try:
                                debug.raise_if_flagged(
                                    ops.finite_flag(T_dev), step)
                            except FloatingPointError:
                                if _try_rollback(step):
                                    continue
                                raise
                            if rollback:
                                last_good = (async_io.device_snapshot(T_dev),
                                             step)
                    if cfg.heartbeat_every and step % cfg.heartbeat_every == 0:
                        master_print(" time_it:", step)  # fortran/serial/heat.f90:62
                    if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                        if writer is not None:
                            if not (rollback and async_on):
                                _submit_snapshot(
                                    async_io.device_snapshot(T_dev), step)
                            # else deferred to _settle_pending: persist only
                            # flag-verified snapshots
                        else:
                            ops.sync(T_dev)
                            _persist(T_dev, step, False)
                if pending_flag is None or not _settle_pending():
                    break
                # final boundary flagged and rolled back: resume stepping
            t_sync = tracer.begin(trace_mod.FINAL_SYNC)
            ops.sync(T_dev)
            tracer.end(trace_mod.FINAL_SYNC, t_sync)
    except BaseException:
        # drain-on-exception: every queued snapshot still lands on disk (a
        # blow-up's last good boundary is exactly the state a resume
        # needs); a writer error is logged but never masks the solve error
        if writer is not None:
            writer.drain(raise_errors=False)
        raise
    solve_s = tracer.end(trace_mod.SOLVE, t0,
                         args={"steps": remaining, "n": cfg.n,
                               "backend": cfg.backend}) - t0
    if writer is not None:
        # post-solve flush, deliberately OUTSIDE solve_s: the device has
        # finished stepping, so the remaining writes overlap nothing
        writer.drain()

    tp_rate = tp_fell_back = None
    if two_point_repeats and remaining > 0:
        k0 = min(chunk, remaining)
        # the clone (not T_dev) goes through the protocol; a state spread
        # over several devices is timed by the host clock around its sync
        tp = two_point_rate(lambda t: advance(t, k0), T_dev.clone(),
                            cfg.points * k0, repeats=two_point_repeats,
                            fence=None if ops is TENSOR else ops.sync)
        tp_rate, tp_fell_back = tp[0], tp.fell_back

    T_host = gsum = gsum_dtype = None
    if fetch or cfg.report_sum:
        t_f = tracer.begin(trace_mod.FETCH)
        whole = ops.gather(T_dev)
        fetched = {"bytes": 0}
        if whole is not None:
            if fetch:
                T_host, _ = fetch_field(whole)
                fetched["bytes"] = T_host.nbytes
            if cfg.report_sum:
                # the reference's commented-out global reduction
                # (mpi+cuda/heat.F90:266-273), accumulated in f64 (on the
                # host, or where the field lies without a fetch) so every
                # backend reports the same sum regardless of storage dtype
                gsum = (float(np.sum(np.asarray(T_host, np.float64)))
                        if T_host is not None
                        else float(torch.sum(whole, dtype=torch.float64)))
                gsum_dtype = "float64"
        tracer.end(trace_mod.FETCH, t_f, args=fetched)
    timing = Timing(total_s=time.perf_counter() - t_all0,
                    compile_s=compile_s, solve_s=solve_s, steps=remaining,
                    points=cfg.points,
                    points_per_s_two_point=tp_rate,
                    two_point_fell_back=tp_fell_back,
                    overlap_s=writer.hidden_s if writer is not None else None,
                    io_wait_s=writer.wait_s if writer is not None else None,
                    kernel=kernel)
    return SolveResult(cfg=cfg, T=T_host, timing=timing, gsum=gsum,
                       gsum_dtype=gsum_dtype, start_step=start_step,
                       T_dev=T_dev, device=str(device))


def resolve_initial_field(cfg: HeatConfig, T0: Optional[np.ndarray], device):
    """(T on ``device``, start_step): explicit T0 > checkpoint (both host
    arrays, copied over by ``upload_field``) > IC built directly on the
    device; inside the ``upload`` span."""
    tracer = trace_mod.get_tracer()
    t0 = tracer.begin(trace_mod.UPLOAD)
    T0_host, start_step = load_or_init(cfg, T0, default_ic=False)
    moved = {"bytes": 0}
    if T0_host is None:
        from ..grid import initial_condition_device

        T = initial_condition_device(cfg, device)
    else:
        # a copy: the drive loop later reuses this buffer, so it must not
        # alias the caller's array; converted on the device
        T, _ = upload_field(np.asarray(T0_host), device)
        moved["bytes"] = T0_host.nbytes
        T = T.to(torch_dtype(cfg.dtype))
    tracer.end(trace_mod.UPLOAD, t0, args=moved)
    return T, start_step


def _agree_resume_step(local_step: Optional[int]) -> Optional[int]:
    """The shard-checkpoint step every rank of the world resumes at: the
    MINIMUM of the ranks' newest valid steps (a crash between two ranks'
    saves leaves them holding different ones, and ranks that start at
    different steps desynchronise the exchanges). A rank with no shard file
    pulls every rank down to none (-1 on the wire): all start over
    together, never one from its initial condition against peers mid-run.
    An ``all_gather_object`` over the world's gloo group."""
    import torch.distributed as dist

    local = -1 if local_step is None else int(local_step)
    agreed = local
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        from ..parallel.dist import host_group

        steps = [None] * dist.get_world_size()
        dist.all_gather_object(steps, local, group=host_group())
        agreed = min(steps)
        if agreed != local:
            master_print(f"shard-checkpoint resume: local step {local} vs "
                         f"world-wide agreed step {agreed}")
    return None if agreed < 0 else agreed


def resume_from_shards(cfg: HeatConfig) -> Optional[tuple]:
    """``(blocks, step)`` of this rank's shard file at the step the world
    agrees on, each block ``(global start offsets, host array)``; None
    when there is none, or when a newer global checkpoint exists (shard
    files are preferred over an older global file only). Every rank of
    the world must call it: the agreement is a collective."""
    sstep = _agree_resume_step(checkpoint.latest_shards(cfg, max_step=cfg.ntime))
    if sstep is None:
        return None
    gstep = checkpoint.latest_step(cfg, max_step=cfg.ntime)
    if gstep is not None and sstep < gstep:
        return None
    blocks, step = checkpoint.load_shards(cfg, sstep)
    master_print(f"resumed from shard checkpoints at step {step}")
    return blocks, step


def load_or_init(cfg: HeatConfig, T0: Optional[np.ndarray], default_ic: bool = True):
    """Resolve the starting field: explicit T0 > latest checkpoint > IC.

    With ``default_ic=False`` the IC fallback returns ``(None, 0)`` instead
    of a host array — device backends then build the IC on the device.
    """
    from ..grid import initial_condition

    start_step = 0
    if T0 is None and cfg.checkpoint_every:
        ck = checkpoint.latest(cfg, max_step=cfg.ntime)
        if ck is not None:
            T0, start_step = checkpoint.load(ck, cfg)
            master_print(f"resumed from {ck} at step {start_step}")
    if T0 is None:
        if not default_ic:
            return None, 0
        T0 = initial_condition(cfg)
    return np.asarray(T0), start_step
