"""Admission queue + shape bucketing + dispatch-ahead continuous batching.

The core of ``heat_tpu.serve.scheduler`` (offline drain, packed lanes). The
serving contract:

- **Admission**: ``Engine.submit(cfg)`` validates a request against the
  bucket table and enqueues it. A request the engine cannot serve (side
  larger than the biggest bucket; periodic BC, which has no padded-lane
  form; ``until=steady``, which this port does not serve yet; a full
  queue) is *rejected as a record*, never as an engine error.
- **Bucketing**: requests are grouped by ``BucketKey`` (ndim, smallest
  bucket side that fits, dtype, BC). One group = one stacked lane array;
  lane counts round UP to power-of-two tiers (``engine.lane_tier``).
- **Continuous batching, dispatch-ahead**: the scheduler keeps
  ``dispatch_depth`` chunks in flight per group and inspects the boundary
  vector of the OLDEST one — copied to the host behind the newer chunks,
  so the boundary's wait and bookkeeping overlap device work instead of
  fencing it. Finished lanes take a one-lane device snapshot
  (``runtime/async_io.lane_snapshot``) and stepping resumes at once; the
  D2H wait and the result write happen in the ``SnapshotWriter`` thread.
  ``Engine.run`` round-robins chunk dispatch across all live bucket groups.
  ``dispatch_depth=0`` is the fully synchronous debugging fallback.
- **Determinism of the boundary**: the device decrements each lane's
  remaining count by one per step while positive, so the host mirrors the
  countdown and PREDICTS every chunk's post-chunk vector at dispatch time.
  The fetched vector must equal the prediction, enforced per boundary (a
  divergence means the masking contract broke). Lanes whose occupant was
  swapped in after a chunk was dispatched are guarded by a per-lane epoch.
- **Tail chunks**: when every live lane's remaining count has dropped far
  enough below the chunk, the group dispatches quarter-chunk tails instead
  of a mostly-masked full chunk.
- **Per-lane fault domains**: every boundary carries a per-lane finite bit
  (computed on the card, in the boundary copy already paid for). A flagged
  lane is **quarantined**: its record fails ``nonfinite``, the lane is
  freed, every other lane continues bit-identically. Requests may carry a
  ``deadline_ms``; an over-deadline lane is preempted at its next boundary
  and queued requests past their deadline are shed. ``max_queue`` /
  ``tenant_quota`` bound admission, and the boundary wait runs under a
  watchdog (``fetch_timeout_s``): a wedged device fails that group's
  requests cleanly instead of hanging.
- **Lane-kernel selection**: each bucket group resolves
  ``ServeConfig.lane_kernel`` through ``engine.resolve_lane_kernel`` — the
  hand-written lane kernels on the card (f32/bf16), the plain PyTorch lane
  step elsewhere; a requested-but-missing kernel (f64) degrades to torch
  as a structured ``lane_kernel_fallback`` record + counter.

Not in this port yet (ROADMAP): rollback mode, lane-tier growth, the
online loop, ``until=steady`` and the numerics observatory, the trace and
cost observatories, the solve cache, engine checkpoints, mega-lanes and
the serve fault kinds.

Records are mutated from the scheduler thread and the writer thread; one
engine-wide lock guards every record mutation and every record line.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np

from ..config import (DEFAULT_SLO_CLASS, DEFAULT_TENANT, LANE_KERNELS,
                      HeatConfig, validate_slo_fields, validate_until_fields)
from ..grid import initial_condition_device
from ..ops import cuda_lanes
from ..runtime import async_io, faults
from ..runtime.checkpoint import savez_compressed
from ..runtime.logging import json_record, master_print
from . import policy as policy_mod
from .engine import BucketKey, LaneEngine, lane_tier, resolve_lane_kernel, \
    wall_clock

# Statuses a record can never leave.
TERMINAL_STATUSES = ("ok", "rejected", "error", "nonfinite", "deadline")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine-level knobs (the per-request physics lives in HeatConfig)."""

    lanes: int = 4            # max concurrent requests per bucket group
                              # (waves round up to power-of-two tiers)
    chunk: int = 16           # steps per chunk (the swap granularity)
    buckets: tuple = (256, 512, 1024)  # grid-side buckets; a request is
                              # padded up to the smallest side that fits
    dispatch_depth: int = 2   # chunks kept in flight per group before the
                              # scheduler waits on a boundary; 0 = fully
                              # synchronous fallback for debugging
    out_dir: Optional[str] = None  # writeback directory (<id>.npz); None =
                              # results kept in memory on the records
    keep_fields: bool = False  # keep final fields on records even when
                              # writing files (tests / library callers)
    emit_records: bool = True  # print one JSON line per finished request
    on_nan: str = "fail"      # a lane whose finite bit drops: "fail"
                              # quarantines the request (the reference's
                              # "rollback" is not ported yet)
    deadline_ms: Optional[float] = None  # engine-default per-request wall
                              # budget from submit; a request's own
                              # deadline_ms overrides; None = no deadline
    max_queue: Optional[int] = None  # admission bound: submits beyond this
                              # many queued requests are shed with a
                              # structured "overloaded" rejection
    fetch_timeout_s: Optional[float] = 600.0  # boundary-fetch watchdog
                              # (None = off)
    policy: str = "fifo"      # admission ordering (serve/policy.py)
    tenant_weights: tuple = ()  # (("name", weight), ...) fair-share weights
    tenant_quota: Optional[int] = None  # per-tenant queued-request bound
    lane_kernel: str = "auto"  # chunk body per bucket (--serve-lane-kernel):
                              # "auto" = the lane kernels on a CUDA device
                              # wherever the bucket has one, torch
                              # elsewhere; "cuda"/"torch" force it

    def __post_init__(self):
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.dispatch_depth < 0:
            raise ValueError(f"dispatch_depth must be >= 0 (0 = sync "
                             f"fallback), got {self.dispatch_depth}")
        if not self.buckets or any(b < 3 for b in self.buckets):
            raise ValueError(f"buckets must be sides >= 3, got {self.buckets}")
        if self.on_nan != "fail":
            raise ValueError(f"on_nan must be 'fail' (rollback is not ported "
                             f"to heat_tpu_torch yet), got {self.on_nan!r}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0 (None = no "
                             f"deadline), got {self.deadline_ms}")
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0 (None/0 = "
                             f"unbounded), got {self.max_queue}")
        if self.fetch_timeout_s is not None and self.fetch_timeout_s <= 0:
            raise ValueError(f"fetch_timeout_s must be > 0 (None = no "
                             f"watchdog), got {self.fetch_timeout_s}")
        if self.policy not in policy_mod.POLICIES:
            raise ValueError(f"policy must be one of {policy_mod.POLICIES}, "
                             f"got {self.policy!r}")
        for name, weight in self.tenant_weights:
            validate_slo_fields(name, None)
            if not float(weight) > 0:
                raise ValueError(f"tenant weight must be > 0, got "
                                 f"{name}={weight}")
        if self.tenant_quota is not None and self.tenant_quota < 0:
            raise ValueError(f"tenant_quota must be >= 0 (None/0 = "
                             f"unbounded), got {self.tenant_quota}")
        if self.lane_kernel not in LANE_KERNELS:
            raise ValueError(f"lane_kernel must be one of {LANE_KERNELS}, "
                             f"got {self.lane_kernel!r}")


@dataclasses.dataclass
class Request:
    """One admitted solve request."""

    id: str
    cfg: HeatConfig
    submit_t: float
    key: BucketKey
    deadline_t: Optional[float] = None  # absolute wall deadline (engine
                                        # clock), from the request's
                                        # deadline_ms or the engine default
    tenant: str = DEFAULT_TENANT
    slo_class: str = DEFAULT_SLO_CLASS
    seq: int = 0                        # engine-wide submit counter: the
                                        # FIFO order and every policy's
                                        # deterministic tiebreak


def _bucket_for(cfg: HeatConfig, buckets) -> Optional[int]:
    """Smallest bucket side that fits the request, or None (overflow)."""
    for b in sorted(buckets):
        if cfg.n <= b:
            return b
    return None


def _write_result(out_dir, req_id: str, T: np.ndarray, cfg: HeatConfig,
                  steps: Optional[int] = None):
    """Atomic-publish one request's final field (temp name outside any
    discovery glob, then a rename). The npz is the reference's file: its
    keys, and a bfloat16 ``T`` (``V2`` bits) under the reference's
    ``'<V2'`` header."""
    from pathlib import Path

    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{req_id}.npz"
    tmp = d / (path.name + ".tmp")
    with open(tmp, "wb") as f:
        savez_compressed(f, T=np.asarray(T),
                         step=cfg.ntime if steps is None else int(steps),
                         n=cfg.n, ndim=cfg.ndim, dtype=cfg.dtype)
    tmp.rename(path)
    return path


class _GroupRunner:
    """Dispatch-ahead continuous batching for ONE bucket group.

    Owns the group's ``LaneEngine``, occupancy, the host-side countdown
    mirror (``dev_rem`` — exact, because the device decrements remaining by
    one per step while positive), and the in-flight deque of
    ``(seq, boundary-handle, predicted-vector, t_dispatch, k)``. ``Engine.run``
    drives many runners round-robin; each tick dispatches until
    ``dispatch_depth`` chunks are queued, then takes at most one boundary.
    """

    def __init__(self, outer: "Engine", key: BucketKey, q,
                 writer: "async_io.SnapshotWriter"):
        self.outer = outer
        self.key = key
        self.q = q
        self.writer = writer
        scfg = outer.scfg
        self.chunk = scfg.chunk
        self.depth = max(1, scfg.dispatch_depth)
        self.lanes = lane_tier(min(len(q), scfg.lanes), scfg.lanes)
        self.kernel, reason = resolve_lane_kernel(scfg.lane_kernel, key,
                                                  outer.device)
        self.eng = LaneEngine(key, self.lanes, scfg.chunk, kernel=self.kernel,
                              device=outer.device)
        outer.compile_s += self.eng.compile_s
        if reason is not None:
            outer._note_lane_fallback(key, self.lanes, reason)
        # the kernel launches each chunk costs, counted on the host from k
        # (the wrappers count what they launch): lanes2d/lanes3d by name
        self._kernel_name = (cuda_lanes._KERNELS[key.ndim]
                             if self.kernel == "cuda"
                             and outer.device.type == "cuda" else None)
        self.occupant: List[Optional[Request]] = [None] * self.lanes
        # first dispatch seq whose chunk covers the lane's CURRENT occupant:
        # an older in-flight chunk shows the previous occupant's state and
        # must not finish — or flag — the new one
        self.epoch = [0] * self.lanes
        self.dev_rem = np.zeros(self.lanes, dtype=np.int64)
        self.seq = 0                        # next dispatch's sequence id
        self.inflight: collections.deque = collections.deque()
        self.idle_from: Optional[float] = None  # group device queue empty
                                                # since (boundary gaps only)
        self._fill()

    # --- admission into lanes --------------------------------------------
    def _fill(self) -> None:
        """Swap queued requests into every free lane (continuous batching).
        The initial field is built on the engine's device and loaded behind
        the chunks in flight. Queued requests already past their deadline
        are shed here."""
        outer = self.outer
        for lane in range(self.lanes):
            while self.occupant[lane] is None and self.q:
                with outer._lock:
                    req = self.q.pop()
                    if req is None:
                        break
                    outer._queued_by_tenant[req.tenant] -= 1
                    outer.admission_trace.append(req.id)
                now = wall_clock()
                if outer._deadline_cut(req, now):
                    outer._fail_request(
                        req, "deadline",
                        f"deadline: exceeded its "
                        f"{1e3 * (req.deadline_t - req.submit_t):.0f} ms "
                        f"budget while still queued (never admitted)")
                    outer.deadline_misses += 1
                    continue
                rec = outer._by_id[req.id]
                with outer._lock:
                    rec["lane"] = lane
                    rec["queue_wait_s"] = round(now - req.submit_t, 6)
                    rec["status"] = "running"
                    rec["_start_t"] = now
                T0 = initial_condition_device(req.cfg, outer.device)
                self.eng.load_lane(lane, T0, float(req.cfg.r), req.cfg.ntime,
                                   req.cfg.bc_value)
                self.dev_rem[lane] = req.cfg.ntime
                self.occupant[lane] = req
                self.epoch[lane] = self.seq

    def _live_remaining(self) -> List[int]:
        return [int(self.dev_rem[i]) for i, o in enumerate(self.occupant)
                if o is not None and self.dev_rem[i] > 0]

    # --- dispatch side ----------------------------------------------------
    def _dispatch(self, k: int):
        """Enqueue one k-step chunk; returns its boundary handle."""
        handle = self.eng.dispatch_chunk(k)
        outer = self.outer
        outer.chunks_dispatched += 1
        if self._kernel_name is not None:
            outer.lane_chunks[self._kernel_name] += 1
            outer.lane_passes[(self._kernel_name, self.key.n,
                               self.key.dtype)] += len(
                cuda_lanes.passes(self.key.ndim, k))
        return handle

    def dispatch_fill(self) -> None:
        """Queue chunks until ``dispatch_depth`` are in flight or no lane has
        steps left to run. Pure host->device enqueue: no fetch, no fence."""
        while len(self.inflight) < self.depth:
            live = self._live_remaining()
            if not live:
                break
            k = self.chunk
            tail = self.eng.tail
            if tail is not None and max(live) <= self.chunk - tail:
                # every live lane finishes inside the chunk, with enough
                # headroom that ceil(rem/tail) tails compute strictly fewer
                # masked steps than one full chunk
                k = tail
                self.outer.tail_chunks += 1
            t_disp = wall_clock()
            handle = self._dispatch(k)
            if self.idle_from is not None:
                self.outer.device_idle_s += t_disp - self.idle_from
                self.idle_from = None
            np.maximum(self.dev_rem - k, 0, out=self.dev_rem)
            self.inflight.append(
                (self.seq, handle, self.dev_rem.astype(np.int32), t_disp, k))
            self.seq += 1

    # --- boundary side ----------------------------------------------------
    def _fetch(self, handle) -> np.ndarray:
        """One watchdog-bounded boundary fetch with wall accounting."""
        outer = self.outer
        t0 = wall_clock()
        try:
            return self.eng.fetch_remaining(
                handle, timeout_s=outer.scfg.fetch_timeout_s)
        finally:
            outer.boundary_wait_s += wall_clock() - t0
            outer.boundary_waits += 1

    def _judge_lanes(self, seq: int, rem, finite, sync: bool) -> None:
        """Apply one fetched boundary's verdicts to every lane it is
        authoritative for (epoch guard). Order per lane: health first (a
        non-finite result is never delivered), then completion, then
        deadline."""
        outer = self.outer
        now = wall_clock()
        for lane in range(self.lanes):
            req = self.occupant[lane]
            if req is None or seq < self.epoch[lane]:
                continue
            if finite is not None and not finite[lane]:
                self._quarantine(lane, req, int(rem[lane]))
            elif rem[lane] == 0:
                finish = outer._finish_sync if sync else outer._finish_async
                finish(self.eng, lane, req, self.writer)
                self.occupant[lane] = None
            elif outer._deadline_cut(req, now):
                done = req.cfg.ntime - int(rem[lane])
                outer._fail_request(
                    req, "deadline",
                    f"deadline: exceeded its "
                    f"{1e3 * (req.deadline_t - req.submit_t):.0f} ms budget "
                    f"with ~{done} of {req.cfg.ntime} steps done; lane "
                    f"{lane} preempted at the chunk boundary",
                    lane=lane, steps_done=done)
                outer.deadline_misses += 1
                # the lane keeps counting down on the card (masked garbage
                # until refilled) so the host mirror stays exact
                self.occupant[lane] = None

    def _quarantine(self, lane: int, req: Request, rem_at: int) -> None:
        """One lane's finite bit dropped: fail the request ``nonfinite`` and
        free the lane; every other lane is untouched (the select keeps a
        NaN in its own lane). The lane's NaN field idles masked, its
        countdown still mirrored by ``dev_rem``, until a new request's load
        overwrites the whole lane buffer."""
        outer = self.outer
        done = req.cfg.ntime - rem_at
        outer._fail_request(
            req, "nonfinite",
            f"nonfinite: non-finite field detected at ~step {done} of "
            f"{req.cfg.ntime} (lane {lane}) — check the CFL bound "
            f"sigma <= 1/(2*ndim) for this request", lane=lane,
            steps_done=done)
        outer.lanes_quarantined += 1
        self.occupant[lane] = None

    def process_boundary(self) -> None:
        """Take one chunk boundary: fetch the OLDEST in-flight boundary
        vector (the newer chunks keep computing behind the copy), check it
        against the host's prediction, judge every lane, refill."""
        if self.inflight:
            seq, handle, predicted, _, _ = self.inflight.popleft()
            b = self._fetch(handle)
            if not self.inflight:
                self.idle_from = wall_clock()
            rem, finite = b[0], b[1]
            if not np.array_equal(rem, predicted):
                raise RuntimeError(
                    f"serve dispatch-ahead desync for bucket {self.key}: "
                    f"device remaining {rem.tolist()} != host-predicted "
                    f"{predicted.tolist()} at chunk {seq} — the lane "
                    f"masking contract broke; results cannot be trusted")
            self._judge_lanes(seq, rem, finite, sync=False)
        else:
            # nothing in flight and nothing left to step: occupants whose
            # countdown is already settled at zero (ntime=0 admits) retire
            self._judge_lanes(self.seq, self.dev_rem, None, sync=False)
        self._fill()

    def has_work(self) -> bool:
        return (bool(self.inflight) or bool(self.q)
                or any(o is not None for o in self.occupant))

    # --- synchronous fallback (--dispatch-depth off) ----------------------
    def sync_round(self) -> None:
        """One fenced boundary: dispatch a chunk, wait for its boundary at
        once, judge every lane on the scheduler thread, refill."""
        outer = self.outer
        finite = None
        if self._live_remaining():
            t0 = wall_clock()
            if self.idle_from is not None:
                outer.device_idle_s += t0 - self.idle_from
            b = self._fetch(self._dispatch(self.chunk))
            rem, finite = b[0], b[1]
            self.idle_from = wall_clock()
            np.maximum(self.dev_rem - self.chunk, 0, out=self.dev_rem)
        else:
            rem = self.dev_rem
        self._judge_lanes(self.seq, rem, finite, sync=True)
        self.seq += 1
        self._fill()

    def run_sync(self) -> None:
        """Fetch every boundary as its chunk is dispatched and extract
        finished lanes on the scheduler thread: no pipelining, no tails,
        the same per-lane fault domains."""
        while self.has_work():
            self.sync_round()


class Engine:
    """Request-driven batched execution engine (library API).

    >>> eng = Engine(ServeConfig(lanes=4, chunk=8, buckets=(64,)))
    >>> rid = eng.submit(HeatConfig(n=32, ntime=100))
    >>> records = eng.results()   # drains the queue, returns all records

    ``device`` is where the lanes live: the card by default (raises when
    there is none), ``"cpu"`` when asked for. ``submit`` only enqueues;
    ``run``/``results`` executes every admitted request to completion and
    returns the records in submit order.
    """

    def __init__(self, scfg: Optional[ServeConfig] = None, device=None):
        from ..backends import resolve_device

        self.scfg = scfg if scfg is not None else ServeConfig()
        self.device = resolve_device(device)
        self._queues: Dict[BucketKey, object] = {}  # policy queues
        self._records: List[dict] = []
        self._by_id: Dict[str, dict] = {}
        self._seq = 0
        # one engine-wide lock: records are mutated and emitted from both
        # the scheduler thread and the SnapshotWriter thread
        self._lock = threading.Lock()
        self._queued_by_tenant: collections.Counter = collections.Counter()
        self.admission_trace: List[str] = []
        self.compile_s = 0.0       # loading the lane kernels' libraries
        self.chunks_dispatched = 0
        self.tail_chunks = 0
        self.lane_passes = collections.Counter()  # kernel launches the
                        # dispatched chunks cost, by (kernel, bucket, dtype)
        self.lane_chunks = collections.Counter()  # those chunks, by kernel
        self.boundary_waits = 0
        self.boundary_wait_s = 0.0   # host wall blocked on boundary fetches
        self.device_idle_s = 0.0     # est. device idle: per-group gaps with
                                     # nothing in flight at a boundary
        self.lane_kernel_fallbacks = 0
        self._lane_fb_seen: set = set()
        self.lanes_quarantined = 0   # requests failed nonfinite
        self.deadline_misses = 0     # requests preempted/shed past deadline
        self.shed = 0                # submits rejected by the queue bounds
        self.watchdog_fired = 0      # boundary-fetch watchdog timeouts

    # --- admission --------------------------------------------------------
    def submit(self, cfg: HeatConfig, request_id: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               slo_class: Optional[str] = None,
               until: Optional[str] = None,
               tol: Optional[float] = None) -> str:
        """Admit one request; returns its id. Unservable requests become
        status='rejected' records instead of raising. ``deadline_ms`` bounds
        the request's wall time from submission (overriding the engine
        default); ``tenant``/``slo_class`` drive the fair-share and EDF
        policies; malformed values raise."""
        tenant, slo_class = validate_slo_fields(tenant, slo_class)
        until, tol = validate_until_fields(until, tol)
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        deadline_ms = (deadline_ms if deadline_ms is not None
                       else self.scfg.deadline_ms)
        with self._lock:
            seq = self._seq
            rid = request_id or f"req-{seq:04d}"
            self._seq += 1
            if rid in self._by_id:
                raise ValueError(f"duplicate request id {rid!r}")
            rec = {"id": rid, "n": cfg.n, "ndim": cfg.ndim,
                   "ntime": cfg.ntime, "dtype": cfg.dtype, "bc": cfg.bc,
                   "tenant": tenant, "class": slo_class, "status": "queued",
                   "placement": None, "bucket": None, "lane": None,
                   "queue_wait_s": None, "solve_s": None,
                   "steps_per_s": None, "error": None,
                   "deadline_ms": deadline_ms, "until": until,
                   "steps_done": None, "exit": None,
                   "_submit_t": wall_clock()}
            self._records.append(rec)
            self._by_id[rid] = rec
        if cfg.bc == "periodic":
            self._reject(rec, "unsupported-bc: periodic has no padded-lane "
                              "form (wraparound would wrap at the bucket "
                              "edge, not the request edge)")
            return rid
        if until == "steady":
            self._reject(rec, "unsupported-until: until=steady is not "
                              "served by heat_tpu_torch yet (fixed-step "
                              "requests only)")
            return rid
        b = _bucket_for(cfg, self.scfg.buckets)
        if b is None:
            self._reject(rec, f"bucket-overflow: request side {cfg.n} "
                              f"exceeds the biggest bucket "
                              f"{max(self.scfg.buckets)}")
            return rid
        key = BucketKey(ndim=cfg.ndim, n=b, dtype=cfg.dtype, bc=cfg.bc)
        shed_reason = None
        with self._lock:
            queued = sum(len(q) for q in self._queues.values())
            if self.scfg.max_queue and queued >= self.scfg.max_queue:
                self.shed += 1
                shed_reason = (f"overloaded: admission queue full "
                               f"({queued} queued >= --max-queue "
                               f"{self.scfg.max_queue}); resubmit later")
            elif (self.scfg.tenant_quota
                  and self._queued_by_tenant[tenant]
                  >= self.scfg.tenant_quota):
                self.shed += 1
                shed_reason = (f"overloaded: tenant {tenant!r} holds "
                               f"{self._queued_by_tenant[tenant]} queued "
                               f"request(s) >= its --tenant-quota "
                               f"{self.scfg.tenant_quota}; resubmit later")
            else:
                rec["bucket"] = b
                rec["placement"] = "packed"
                q = self._queues.get(key)
                if q is None:
                    q = self._queues[key] = policy_mod.make_queue(
                        self.scfg.policy, self.scfg.tenant_weights)
                submit_t = rec["_submit_t"]
                q.push(Request(
                    id=rid, cfg=cfg, submit_t=submit_t, key=key,
                    deadline_t=(submit_t + deadline_ms / 1e3
                                if deadline_ms is not None else None),
                    tenant=tenant, slo_class=slo_class, seq=seq))
                self._queued_by_tenant[tenant] += 1
        if shed_reason is not None:
            self._reject(rec, shed_reason)
        return rid

    def _reject(self, rec: dict, reason: str) -> None:
        with self._lock:
            rec["status"] = "rejected"
            rec["error"] = reason
        self._emit(rec)

    def _fail_request(self, req: Request, status: str, reason: str,
                      lane: Optional[int] = None,
                      steps_done: int = 0) -> None:
        """Fail ONE request with a structured status (nonfinite / deadline /
        error): the record carries the reason, the engine keeps serving
        everyone else."""
        rec = self._by_id[req.id]
        now = wall_clock()
        with self._lock:
            start = rec.pop("_start_t", None)
            if start is not None:
                rec["solve_s"] = round(now - start, 6)
            if rec["queue_wait_s"] is None:
                rec["queue_wait_s"] = round(now - req.submit_t, 6)
            if lane is not None:
                rec["lane"] = lane
            rec["status"] = status
            rec["error"] = reason
            rec["steps_done"] = int(steps_done)
        self._emit(rec)

    def _note_lane_fallback(self, key: BucketKey, lanes: int,
                            reason: str) -> None:
        """One (bucket, tier) wanted the lane kernel and got the torch lane
        step instead: degrade LOUDLY — a human line, a structured
        ``lane_kernel_fallback`` record and the summary counter — but never
        an error. Deduped per (bucket, tier)."""
        bucket = f"{key.ndim}d/n{key.n}/{key.dtype}/{key.bc}"
        with self._lock:
            if (key, lanes) in self._lane_fb_seen:
                return
            self._lane_fb_seen.add((key, lanes))
            self.lane_kernel_fallbacks += 1
        master_print(
            f"serve lane-kernel: bucket {bucket} tier {lanes} fell back "
            f"to the torch lane step ({reason})")
        json_record("lane_kernel_fallback", bucket=bucket, lanes=lanes,
                    requested=self.scfg.lane_kernel, reason=reason)

    def _fail_group(self, runner: _GroupRunner, exc: BaseException) -> None:
        """The boundary-fetch watchdog fired for one bucket group: its device
        state is unreadable, so every in-flight occupant and every queued
        request of THIS group fails with a structured record — and the
        other groups keep draining."""
        self.watchdog_fired += 1
        master_print(f"serve fetch watchdog: bucket {runner.key} boundary "
                     f"fetch hung ({exc}); failing the group's "
                     f"{sum(o is not None for o in runner.occupant)} "
                     f"in-flight and {len(runner.q)} queued request(s)")
        for lane, req in enumerate(runner.occupant):
            if req is not None:
                self._fail_request(
                    req, "error",
                    f"fetch-watchdog: {exc} — lane {lane}'s group state "
                    f"is unreadable; request failed cleanly", lane=lane,
                    steps_done=max(0, req.cfg.ntime
                                   - int(runner.dev_rem[lane])))
                runner.occupant[lane] = None
        while True:
            with self._lock:
                req = runner.q.pop()
                if req is not None:
                    self._queued_by_tenant[req.tenant] -= 1
            if req is None:
                break
            self._fail_request(
                req, "error",
                f"fetch-watchdog: {exc} — request was still queued when "
                f"its bucket group's boundary fetch hung")
        runner.inflight.clear()

    @staticmethod
    def _public(rec: dict) -> dict:
        """A record as callers see it: no field payload, no internal
        ``_``-prefixed bookkeeping."""
        return {k: v for k, v in rec.items()
                if k != "T" and not k.startswith("_")}

    def _emit(self, rec: dict) -> None:
        """Emit one terminal request record as a JSON line (when enabled).
        Called from the scheduler thread and the writer thread; the lock
        keeps lines from interleaving."""
        with self._lock:
            if self.scfg.emit_records:
                json_record("serve_request", **self._public(rec))

    def _deadline_cut(self, req: Request, now: float) -> bool:
        return req.deadline_t is not None and now > req.deadline_t

    # --- execution --------------------------------------------------------
    def run(self) -> List[dict]:
        """Drain every queued request through dispatch-ahead continuous
        batching; returns all records (submit order)."""
        writer = async_io.SnapshotWriter()
        try:
            runners = [_GroupRunner(self, key, q, writer)
                       for key, q in list(self._queues.items()) if q]
            if self.scfg.dispatch_depth == 0:
                # synchronous debugging fallback: groups drain one at a
                # time with a fence at every boundary
                for r in runners:
                    try:
                        r.run_sync()
                    except async_io.BoundedFetchTimeout as e:
                        self._fail_group(r, e)
            else:
                live = [r for r in runners if r.has_work()]
                while live:
                    # prime every group's device queue before anyone waits:
                    # one group's boundary wait then hides under the other
                    # groups' queued chunks
                    for r in live:
                        r.dispatch_fill()
                    nxt = []
                    for r in live:
                        try:
                            r.process_boundary()
                            r.dispatch_fill()
                        except async_io.BoundedFetchTimeout as e:
                            self._fail_group(r, e)
                            continue
                        if r.has_work():
                            nxt.append(r)
                    live = nxt
        except BaseException:
            # every writeback already queued still lands (or fails per
            # request), but a writer error must not mask this one
            writer.drain(raise_errors=False)
            raise
        writer.drain()
        return list(self._records)

    def results(self) -> List[dict]:
        """``run`` + records (the common library call)."""
        if any(self._queues.values()):
            self.run()
        return list(self._records)

    # --- lane retirement --------------------------------------------------
    def _finish_timing(self, req: Request) -> dict:
        rec = self._by_id[req.id]
        now = wall_clock()
        with self._lock:
            lane_s = now - rec.pop("_start_t", now)
            rec["solve_s"] = round(lane_s, 6)
            rec["steps_per_s"] = (round(req.cfg.ntime / lane_s, 3)
                                  if lane_s > 0 else None)
            rec["steps_done"] = req.cfg.ntime
            rec["exit"] = "steps"
        return rec

    def _writeback_job(self, rec: dict, req: Request,
                       writer: "async_io.SnapshotWriter", get_field) -> None:
        """Build + submit the writer-thread job for one finished request.
        ``get_field()`` produces the host field — under dispatch-ahead it
        waits for the snapshot's copy *in the writer thread*."""
        cfg, scfg = req.cfg, self.scfg
        attempts = {"n": 0}

        def job():
            # Transient sink errors re-raise so the SnapshotWriter's bounded
            # retry gets its shot; a final failure is recorded on THIS
            # request and swallowed (it must not kill the other lanes).
            attempts["n"] += 1
            try:
                T = get_field()
                plan = faults.plan_for(cfg)
                if plan is not None:
                    plan.sink_fault(cfg.ntime)
                path = (str(_write_result(scfg.out_dir, req.id, T, cfg))
                        if scfg.out_dir else None)
                with self._lock:
                    if scfg.keep_fields or not scfg.out_dir:
                        rec["T"] = T
                    if path is not None:
                        rec["path"] = path
                    rec["status"] = "ok"
            except BaseException as e:  # noqa: BLE001 — per-request record
                if async_io.is_transient(e) and attempts["n"] <= writer.retries:
                    raise
                with self._lock:
                    rec["status"] = "error"
                    rec["error"] = f"{type(e).__name__}: {e}"
            self._emit(rec)

        writer.submit(job)

    def _finish_async(self, eng: LaneEngine, lane: int, req: Request,
                      writer) -> None:
        """Dispatch-ahead retirement: a one-lane snapshot enqueued behind
        the chunks in flight (the scheduler thread never waits); the D2H
        wait and the writeback run in the writer thread."""
        rec = self._finish_timing(req)
        snap = eng.snapshot_lane(lane, req.cfg.n)
        self._writeback_job(rec, req, writer, lambda: eng.extract(snap))

    def _finish_sync(self, eng: LaneEngine, lane: int, req: Request,
                     writer) -> None:
        """Sync-fallback retirement: fetch the lane on the scheduler thread,
        write back in the writer."""
        rec = self._finish_timing(req)
        T = eng.extract_lane(lane, req.cfg.n)
        self._writeback_job(rec, req, writer, lambda: T)

    # --- reporting --------------------------------------------------------
    def summary(self) -> dict:
        """The reference's summary keys for what this port serves. Of the
        rest: ``rollbacks`` and ``lane_grows`` are 0 (rollback mode and
        lane-tier growth are not ported), ``mega_lanes`` 0 (no mega-lane
        tier), ``numerics`` and ``prof`` False (those observatories are not
        ported) and ``cache`` None (no solve cache); ``step_compiles`` and
        ``tail_compiles`` are 0 (nothing is compiled per bucket: the lane
        kernels are built once per checkout, ``compile_s`` is the time to
        load them). The observatories' own keys are left out (ROADMAP).
        The port adds ``lane_passes``, the lane kernel launches that the
        dispatched chunks cost by kernel, ``lane_passes_by_bucket``, the
        same by ``"<kernel> <bucket side> <dtype>"``, and ``lane_chunks``,
        those chunks by kernel."""
        with self._lock:
            by_status = collections.Counter(r["status"] for r in self._records)
            by_placement = collections.Counter(
                r["placement"] for r in self._records if r.get("placement"))
            n = len(self._records)
            queued = sum(len(q) for q in self._queues.values())
        by_kernel = collections.Counter()
        for (name, _, _), count in self.lane_passes.items():
            by_kernel[name] += count
        return {"requests": n, **dict(by_status),
                "device": str(self.device),
                "numerics": False, "prof": False,
                "policy": self.scfg.policy,
                "lane_kernel": self.scfg.lane_kernel,
                "lane_kernel_fallbacks": self.lane_kernel_fallbacks,
                "lane_passes": dict(by_kernel),
                "lane_passes_by_bucket": {
                    f"{name} {n} {dtype}": count for (name, n, dtype), count
                    in sorted(self.lane_passes.items())},
                "lane_chunks": dict(self.lane_chunks),
                "placement": dict(by_placement),
                "mega_lanes": 0,
                "queued_now": queued,
                "lane_grows": 0,
                "step_compiles": 0,
                "tail_compiles": 0,
                "compile_s": round(self.compile_s, 3),
                "dispatch_depth": self.scfg.dispatch_depth,
                "chunks_dispatched": self.chunks_dispatched,
                "tail_chunks": self.tail_chunks,
                "boundary_waits": self.boundary_waits,
                "boundary_wait_s": round(self.boundary_wait_s, 6),
                "device_idle_s": round(self.device_idle_s, 6),
                "lanes_quarantined": self.lanes_quarantined,
                "rollbacks": 0,
                "deadline_misses": self.deadline_misses,
                "cache": None,
                "shed": self.shed,
                "watchdog_fired": self.watchdog_fired}
