"""Admission queue + shape bucketing + dispatch-ahead continuous batching.

The core of ``heat_tpu.serve.scheduler`` (offline drain, packed lanes). The
serving contract:

- **Admission**: ``Engine.submit(cfg)`` validates a request against the
  bucket table and enqueues it. A request the engine cannot serve (side
  larger than the biggest bucket; periodic BC, which has no padded-lane
  form; a full queue) is *rejected as a record*, never as an engine
  error. An ``until=steady`` request carries a closed-form eigenmode
  prediction of its retirement step from admission
  (``runtime/convergence.predict_admission_steps``), which ranks it in the
  EDF and fair-share queues.
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
  freed, every other lane continues bit-identically.
  ``--serve-on-nan rollback`` instead keeps every dispatched chunk's
  post-chunk stack as a restorable boundary snapshot (a keep-input lane
  engine: no copy on the dispatch path, ``engine.py``); a lane judged
  finite at a boundary promotes that snapshot's row to its last good
  state, and a flagged lane is restored and re-stepped alone — transient
  poison heals bit-identically, a deterministic blow-up re-flags and is
  quarantined after ``_MAX_LANE_ROLLBACKS`` restores. Requests may carry a
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
- **Numerics and semantic scheduling**: the lane kernels fuse four
  per-lane stats (residual, min, max, heat) into every boundary vector;
  the numerics observatory (``runtime/numerics.py``, on by default) reads
  them from the copy already fetched — no extra device pass or transfer —
  and returns its verdicts: a ``steady_state`` record once per converged
  request, and ``numerics_violation`` records (maximum principle, heat
  jump) that ``--numerics-guard quarantine`` turns into the quarantine
  exit. An ``until=steady`` request retires at its dispatch frontier once
  its residual EWMA passes its tolerance: the delivered field carries
  exactly the steps dispatched, byte-equal to a fixed-step run cut there.
- **Online serving**: ``Engine.start()`` runs the same dispatch-ahead
  round-robin in a scheduler thread while ``submit`` feeds it
  (``poll``/``wait``/``cancel``/listeners; ``begin_drain``/``shutdown``),
  and a group whose queue outgrows its lane tier grows it at an
  empty-pipeline boundary, its occupants transplanted byte for byte
  (``_GroupRunner.maybe_grow``).
- **Fault injection** (``runtime/faults.py``): the engine's ``inject`` spec
  and each request's own take the serve kinds ``lane-nan``, ``perturb``,
  ``fetch-hang`` (inside the watched boundary fetch) and ``engine-kill``.

Not in this port yet (ROADMAP): the trace and cost observatories (flight
dumps, ``predicted_wall_s``, which stays None as in the reference with
``--prof off``), the solve cache, engine checkpoints and handoff drain,
``serve --listen`` and mega-lanes.

Records are mutated from the scheduler thread and the writer thread; one
engine-wide lock guards every record mutation and every record line, and
backs the condition that the online loop and ``wait`` callers sleep on.
The numerics observatory has a lock of its own and never takes this one.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..config import (DEFAULT_SLO_CLASS, DEFAULT_TENANT, LANE_KERNELS,
                      HeatConfig, validate_slo_fields, validate_until_fields)
from ..grid import ic_envelope, initial_condition_device
from ..ops import cuda_lanes
from ..runtime import async_io, faults
from ..runtime import convergence as conv_mod
from ..runtime import numerics as numerics_mod
from ..runtime.checkpoint import savez_compressed
from ..runtime.logging import json_record, master_print
from . import policy as policy_mod
from .engine import (BucketKey, LaneEngine, lane_tier, resolve_lane_kernel,
                     unpack_boundary, wall_clock)

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
                              # quarantines the request; "rollback"
                              # restores the lane's last verified-finite
                              # boundary snapshot and re-steps only that
                              # lane (bounded retries — deterministic
                              # blow-ups still quarantine)
    deadline_ms: Optional[float] = None  # engine-default per-request wall
                              # budget from submit; a request's own
                              # deadline_ms overrides; None = no deadline
    max_queue: Optional[int] = None  # admission bound: submits beyond this
                              # many queued requests are shed with a
                              # structured "overloaded" rejection
    fetch_timeout_s: Optional[float] = 600.0  # boundary-fetch watchdog
                              # (None = off)
    inject: str = ""          # engine-scoped fault spec (runtime/faults.py
                              # grammar incl. the serve kinds lane-nan /
                              # perturb / fetch-hang / engine-kill);
                              # per-request specs ride each request's own
                              # "inject" key
    policy: str = "fifo"      # admission ordering (serve/policy.py)
    tenant_weights: tuple = ()  # (("name", weight), ...) fair-share weights
    tenant_quota: Optional[int] = None  # per-tenant queued-request bound
    lane_kernel: str = "auto"  # chunk body per bucket (--serve-lane-kernel):
                              # "auto" = the lane kernels on a CUDA device
                              # wherever the bucket has one, torch
                              # elsewhere; "cuda"/"torch" force it
    numerics: bool = True     # the numerics observatory (runtime/
                              # numerics.py): per-lane solution-quality
                              # detectors fed from the stats rows every
                              # chunk fuses into its boundary vector. off =
                              # host-side ingestion off only — the chunks
                              # are the same, so results are byte-equal
                              # on vs off
    steady_tol: float = 1e-12  # steady-state detector (--steady-tol): a
                              # lane whose final-mini-step residual EWMA
                              # sits below this while steps remain emits
                              # ONE steady_state record; an until=steady
                              # request (its own "tol" overrides this)
                              # also retires there, exit=steady
    numerics_guard: str = "warn"  # violation routing (--numerics-guard):
                              # "warn" = structured numerics_violation
                              # record only; "quarantine" = also fail the
                              # request nonfinite and free its lane

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
        if self.on_nan not in ("fail", "rollback"):
            raise ValueError(f"on_nan must be 'fail' or 'rollback', "
                             f"got {self.on_nan!r}")
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
        if not self.steady_tol > 0:
            raise ValueError(f"steady_tol must be > 0, got "
                             f"{self.steady_tol}")
        if self.numerics_guard not in ("warn", "quarantine"):
            raise ValueError(f"numerics_guard must be 'warn' or "
                             f"'quarantine', got {self.numerics_guard!r}")
        if self.inject:
            # fail at construction, not at a boundary mid-drain
            faults.parse_spec(self.inject)


# --serve-on-nan rollback: restores a flagged lane at most this many times
# per request before declaring the blow-up deterministic.
_MAX_LANE_ROLLBACKS = 2


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
    until: str = "steps"                # "steps" runs all ntime steps;
                                        # "steady" retires at the first
                                        # boundary whose residual EWMA
                                        # passes tolerance
    tol: Optional[float] = None         # per-request steady tolerance
                                        # (None = the engine's steady_tol)
    predicted_steps: Optional[int] = None  # closed-form eigenmode ETA to
                                        # steady, minted at submit: the
                                        # EDF predicted-finish rank


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
    ``'<V2'`` header. ``steps`` is the step count the field carries —
    below ``cfg.ntime`` for a steady early exit."""
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
    ``(seq, boundary-handle, predicted-vector, snapshot, t_dispatch, k)``.
    ``Engine.run`` drives many runners round-robin; each tick dispatches
    until ``dispatch_depth`` chunks are queued, then takes at most one
    boundary.
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
        self.rollback = scfg.on_nan == "rollback"
        self.lanes = lane_tier(min(len(q), scfg.lanes), scfg.lanes)
        self.kernel, self._kernel_fb = resolve_lane_kernel(
            scfg.lane_kernel, key, outer.device)
        self.eng = self._engine(self.lanes)
        # the kernel launches each chunk costs, counted on the host from k
        # (the wrappers count what they launch): lanes2d/lanes3d by name
        self._kernel_name = (cuda_lanes._KERNELS[key.ndim]
                             if self.kernel == "cuda"
                             and outer.device.type == "cuda" else None)
        self.seq = 0                        # next dispatch's sequence id
        self._reset_lanes(self.lanes)
        self.inflight: collections.deque = collections.deque()
        self.idle_from: Optional[float] = None  # group device queue empty
                                                # since (boundary gaps only)
        self.allow_growth = False   # the online loop opts in: offline run()
                                    # sizes runners from the full queue
        self._fill()

    def _engine(self, lanes: int) -> LaneEngine:
        """A lane engine at tier ``lanes``. Rollback mode builds it
        keep-input, so every post-chunk stack stays a restorable boundary
        snapshot with no copy on the dispatch path. A kernel fallback is
        recorded per (bucket, tier)."""
        outer = self.outer
        eng = LaneEngine(self.key, lanes, outer.scfg.chunk, kernel=self.kernel,
                         device=outer.device, keep_input=self.rollback)
        outer.compile_s += eng.compile_s
        if self._kernel_fb is not None:
            outer._note_lane_fallback(self.key, lanes, self._kernel_fb)
        return eng

    def _reset_lanes(self, lanes: int) -> None:
        """Fresh per-lane state for a tier of ``lanes`` lanes."""
        self.occupant: List[Optional[Request]] = [None] * lanes
        # first dispatch seq whose chunk covers the lane's CURRENT occupant:
        # an older in-flight chunk shows the previous occupant's (or the
        # pre-rollback) state and must not finish — or flag — the new one
        self.epoch = [self.seq] * lanes
        self.dev_rem = np.zeros(lanes, dtype=np.int64)
        # per-lane fault-domain state, (re)set at each admission: pending
        # lane-nan thresholds and (step, eps) perturb events, rollback
        # retries left, and the last verified-finite boundary (stack
        # snapshot, steps left)
        self.nan_pending: List[List[int]] = [[] for _ in range(lanes)]
        self.perturb_pending: List[List[tuple]] = [[] for _ in range(lanes)]
        self.rb_left = [0] * lanes
        self.last_good: List[Optional[tuple]] = [None] * lanes
        # remaining-at-detection of a lane whose until=steady occupant
        # passed tolerance this boundary; the judge pass of the same
        # process_boundary retires it at its dispatch frontier
        self.steady_exit: List[Optional[int]] = [None] * lanes

    # --- admission into lanes --------------------------------------------
    def _fill(self) -> None:
        """Swap queued requests into every free lane (continuous batching).
        The initial field is built on the engine's device and loaded behind
        the chunks in flight. Queued requests already past their deadline
        (or cancelled) are shed here."""
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
                cut = outer._deadline_cut(req, now)
                if cut is not None:
                    outer._fail_request(
                        req, "deadline",
                        "deadline: cancelled (deadline-preemption) while "
                        "still queued (never admitted)"
                        if cut == "cancelled" else
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
                self._load_ic(lane, req)
                self.occupant[lane] = req
                self.nan_pending[lane] = outer._lane_faults(
                    req, "lane_nan_steps")
                self.perturb_pending[lane] = outer._lane_faults(
                    req, "perturb_events")
                if self.nan_pending[lane] or self.perturb_pending[lane]:
                    outer._has_lane_faults = True  # gates _maybe_poison
                self.rb_left[lane] = _MAX_LANE_ROLLBACKS
                self.steady_exit[lane] = None   # never inherit a prior
                                                # occupant's verdict
                if outer.numerics is not None:
                    # arm the detectors: the analytic IC/BC envelope (no
                    # device work), the request's steady tolerance and the
                    # closed-form eigenmode rate seeding the ETA fuser
                    lo, hi = ic_envelope(req.cfg)
                    outer.numerics.admit(
                        req.id, lo, hi, req.cfg.dtype, steady_tol=req.tol,
                        log_rate=conv_mod.closed_form_log_rate(req.cfg))

    def _load_ic(self, lane: int, req: Request) -> None:
        """(Re)start ``req`` in ``lane`` from its initial condition: the
        field built on the card, the full countdown, and a new epoch (the
        chunks in flight show the lane's previous state)."""
        T0 = initial_condition_device(req.cfg, self.outer.device)
        self.eng.load_lane(lane, T0, float(req.cfg.r), req.cfg.ntime,
                           req.cfg.bc_value)
        self.dev_rem[lane] = req.cfg.ntime
        self.epoch[lane] = self.seq
        self.last_good[lane] = None

    def _live_remaining(self) -> List[int]:
        return [int(self.dev_rem[i]) for i, o in enumerate(self.occupant)
                if o is not None and self.dev_rem[i] > 0]

    def _effective_remaining(self) -> List[int]:
        """Per-live-lane remaining WORK for tail sizing: the countdown
        mirror, tightened for ``until=steady`` occupants by the fused
        eigenmode/observed ETA (the numerics observatory). Prediction only
        moves the full-chunk -> tail switch earlier and never changes
        results: a mispredicted lane keeps taking tails until it exits."""
        numerics = self.outer.numerics
        out = []
        for i, req in enumerate(self.occupant):
            rem = int(self.dev_rem[i])
            if req is None or rem <= 0:
                continue
            if req.until == "steady" and numerics is not None:
                eta = numerics.eta_steps(req.id)
                if eta is not None:
                    rem = min(rem, max(int(eta), 1))
            out.append(rem)
        return out

    # --- dispatch side ----------------------------------------------------
    def _maybe_poison(self) -> None:
        """lane-nan / perturb chaos: fault any occupied lane whose
        completed-step count (by the countdown mirror, i.e. after every
        chunk already dispatched) has reached a pending threshold. Only
        called with an active fault plan."""
        for lane, req in enumerate(self.occupant):
            if req is None or not (self.nan_pending[lane]
                                   or self.perturb_pending[lane]):
                continue
            done = req.cfg.ntime - int(self.dev_rem[lane])
            while self.nan_pending[lane] and done >= self.nan_pending[lane][0]:
                self.nan_pending[lane].pop(0)   # fire-once per request
                self.eng.poison_lane(lane, req.cfg.n)
            while (self.perturb_pending[lane]
                   and done >= self.perturb_pending[lane][0][0]):
                _, eps = self.perturb_pending[lane].pop(0)  # fire-once
                self.eng.perturb_lane(lane, req.cfg.n, eps)

    def _dispatch(self, k: int):
        """Enqueue one k-step chunk; returns its boundary handle."""
        handle = self.eng.dispatch_chunk(k)
        outer = self.outer
        if self._kernel_name is not None:
            outer.lane_chunks[self._kernel_name] += 1
            outer.lane_passes[(self._kernel_name, self.key.n,
                               self.key.dtype)] += len(
                cuda_lanes.passes(self.key.ndim, k))
        return handle

    def dispatch_fill(self) -> None:
        """Queue chunks until ``dispatch_depth`` are in flight or no lane has
        steps left to run. Pure host->device enqueue: no fetch, no fence."""
        poison = self.outer._has_lane_faults
        while len(self.inflight) < self.depth:
            if self.allow_growth and self._growth_wanted():
                # stop feeding the pipeline: once the in-flight chunks
                # drain, maybe_grow rebuilds the group at the wider tier
                break
            if not self._live_remaining():
                break
            if poison:
                self._maybe_poison()
            k = self.chunk
            tail = self.eng.tail
            if (tail is not None
                    and max(self._effective_remaining()) <= self.chunk - tail):
                # every live lane finishes (or is PREDICTED to steady-exit)
                # inside the chunk, with enough headroom that ceil(rem/tail)
                # tails compute strictly fewer masked steps than one chunk
                k = tail
                self.outer.tail_chunks += 1
            t_disp = wall_clock()
            handle = self._dispatch(k)
            if self.idle_from is not None:
                self.outer.device_idle_s += t_disp - self.idle_from
                self.idle_from = None
            np.maximum(self.dev_rem - k, 0, out=self.dev_rem)
            # rollback mode keeps every in-flight boundary restorable: the
            # snapshot is promoted to a lane's last_good only once that
            # boundary's finite bit comes back clean
            snap = self.eng.snapshot_stack() if self.rollback else None
            self.inflight.append(
                (self.seq, handle, self.dev_rem.astype(np.int32), snap,
                 t_disp, k))
            self.seq += 1
            self.outer.chunks_dispatched += 1

    # --- boundary side ----------------------------------------------------
    def _fetch(self, handle) -> np.ndarray:
        """One watchdog-bounded boundary fetch with wall accounting."""
        outer = self.outer
        t0 = wall_clock()
        try:
            return self.eng.fetch_remaining(
                handle, timeout_s=outer.scfg.fetch_timeout_s,
                plan=outer._plan, fetch_index=outer._fetch_seq)
        finally:
            outer._fetch_seq += 1
            outer.boundary_wait_s += wall_clock() - t0
            outer.boundary_waits += 1

    def _judge_lanes(self, seq: int, rem, finite, snap, sync: bool) -> None:
        """Apply one fetched boundary's verdicts to every lane it is
        authoritative for (epoch guard). Order per lane: health first (a
        non-finite result is never delivered), then completion (or a
        steady exit), then deadline, then last-good promotion."""
        outer = self.outer
        now = wall_clock()
        for lane in range(self.lanes):
            req = self.occupant[lane]
            if req is None or seq < self.epoch[lane]:
                continue
            if finite is not None and not finite[lane]:
                self._handle_nonfinite(lane, req, int(rem[lane]))
            elif rem[lane] == 0 or self.steady_exit[lane] is not None:
                steady_at = self.steady_exit[lane]
                self.steady_exit[lane] = None
                steps_done = req.cfg.ntime
                exit_mode = "steps"
                if steady_at is not None:
                    # the steady exit retires at the dispatch FRONTIER: the
                    # chunks in flight keep running (the countdown mirror
                    # is untouched, so the desync check stays exact) and
                    # the retirement snapshot is enqueued behind them, so
                    # the field carries exactly ntime - dev_rem steps —
                    # byte-equal to a fixed-step run cut there. At depth 0
                    # the frontier IS the detection boundary.
                    steps_done = req.cfg.ntime - int(self.dev_rem[lane])
                    if steps_done < req.cfg.ntime:
                        exit_mode = "steady"
                        outer.steady_exits += 1
                        with outer._lock:
                            outer.steps_saved_total += (req.cfg.ntime
                                                        - steps_done)
                finish = outer._finish_sync if sync else outer._finish_async
                finish(self.eng, lane, req, self.writer,
                       steps_done=steps_done, exit_mode=exit_mode)
                self.occupant[lane] = None
            elif (cut := outer._deadline_cut(req, now)) is not None:
                done = req.cfg.ntime - int(rem[lane])
                outer._fail_request(
                    req, "deadline",
                    (f"deadline: cancelled (deadline-preemption) with "
                     f"~{done} of {req.cfg.ntime} steps done; lane "
                     f"{lane} preempted at the chunk boundary"
                     if cut == "cancelled" else
                     f"deadline: exceeded its "
                     f"{1e3 * (req.deadline_t - req.submit_t):.0f} ms "
                     f"budget with ~{done} of {req.cfg.ntime} steps done; "
                     f"lane {lane} preempted at the chunk boundary"),
                    lane=lane, steps_done=done)
                outer.deadline_misses += 1
                # the lane keeps counting down on the card (masked garbage
                # until refilled) so the host mirror stays exact
                self.occupant[lane] = None
            elif self.rollback and snap is not None:
                self.last_good[lane] = (snap, int(rem[lane]))

    def _handle_nonfinite(self, lane: int, req: Request, rem_at: int) -> None:
        """One lane's finite bit dropped: restore-and-re-step it alone
        (rollback mode, budget permitting) or quarantine the request.
        Either way every other lane is untouched (the select keeps a NaN in
        its own lane)."""
        outer = self.outer
        done = req.cfg.ntime - rem_at
        if self.rollback and self.rb_left[lane] > 0:
            self.rb_left[lane] -= 1
            outer.rollbacks += 1
            attempt = (f"attempt {_MAX_LANE_ROLLBACKS - self.rb_left[lane]}/"
                       f"{_MAX_LANE_ROLLBACKS}")
            if self.last_good[lane] is not None:
                good_snap, steps_left = self.last_good[lane]
                master_print(
                    f"serve on-nan rollback: request {req.id} (lane {lane}) "
                    f"non-finite at ~step {done}; restoring the last "
                    f"verified boundary ({steps_left} steps left, "
                    f"{attempt})")
                self.eng.restore_lane(lane, good_snap[lane],
                                      float(req.cfg.r), req.cfg.n,
                                      steps_left)
                self.dev_rem[lane] = steps_left
                # boundaries already in flight show the pre-restore (still
                # poisoned) lane: the epoch bump makes them non-authoritative
                self.epoch[lane] = self.seq
                self.last_good[lane] = None
            else:
                # no verified boundary yet: re-admit from the (determin-
                # istic) initial condition — the first-chunk transient
                master_print(
                    f"serve on-nan rollback: request {req.id} (lane {lane}) "
                    f"non-finite at ~step {done}; re-stepping from the "
                    f"initial condition ({attempt})")
                self._load_ic(lane, req)
        else:
            exhausted = self.rollback and self.rb_left[lane] == 0
            tried = (f" after {_MAX_LANE_ROLLBACKS} rollbacks "
                     f"(deterministic blow-up)" if exhausted else "")
            outer._fail_request(
                req, "nonfinite",
                f"nonfinite: non-finite field detected at ~step {done} of "
                f"{req.cfg.ntime} (lane {lane}){tried} — check the CFL "
                f"bound sigma <= 1/(2*ndim) for this request", lane=lane,
                steps_done=done)
            outer.lanes_quarantined += 1
            # free the lane; its NaN field idles masked (its countdown
            # still mirrored by dev_rem) until a new request's load
            # overwrites the whole lane buffer
            self._free(lane)

    def _free(self, lane: int) -> None:
        self.occupant[lane] = None
        self.nan_pending[lane] = []
        self.perturb_pending[lane] = []
        self.last_good[lane] = None

    def _ingest_numerics(self, seq: int, b: np.ndarray) -> None:
        """Feed one fetched boundary's fused stats rows (rows 2-5,
        ``engine.unpack_boundary``) to the numerics observatory and apply
        its verdicts. Runs BEFORE ``_judge_lanes`` under the same epoch
        guard, so a quarantine verdict frees the lane before the health and
        completion pass sees it."""
        outer = self.outer
        # Python floats/ints once per boundary, not per element
        resid, tmin, tmax, heat = unpack_boundary(b).tolist()
        rem = b[0].tolist()
        for lane in range(self.lanes):
            req = self.occupant[lane]
            if req is None or seq < self.epoch[lane]:
                continue
            events = outer.numerics.observe(req.id, resid[lane], tmin[lane],
                                            tmax[lane], heat[lane], rem[lane])
            for ev in events:
                outer._note_numerics_event(self, lane, req, rem[lane], ev)

    def _quarantine_numerics(self, lane: int, req: Request, rem_at: int,
                             why: str) -> None:
        """``--numerics-guard quarantine``: a violated lane takes the
        quarantine exit — ``nonfinite`` failure, lane freed, co-scheduled
        lanes byte-identical to a clean run."""
        outer = self.outer
        done = req.cfg.ntime - rem_at
        outer._fail_request(
            req, "nonfinite",
            f"numerics: {why} violation at ~step {done} of "
            f"{req.cfg.ntime} (lane {lane}) — the field is finite but "
            f"un-physical; check r against the CFL bound "
            f"sigma <= 1/(2*ndim), dtype drift, or an injected perturb "
            f"fault (TROUBLESHOOTING.md)", lane=lane, steps_done=done)
        outer.lanes_quarantined += 1
        self._free(lane)

    def _boundary(self, seq: int, b: np.ndarray, snap, sync: bool) -> None:
        """One fetched boundary's numerics and verdicts."""
        outer = self.outer
        if outer.numerics is not None:
            self._ingest_numerics(seq, b)
        self._judge_lanes(seq, b[0], b[1], snap, sync=sync)
        outer._note_boundary()

    def process_boundary(self) -> None:
        """Take one chunk boundary: fetch the OLDEST in-flight boundary
        vector (the newer chunks keep computing behind the copy), check it
        against the host's prediction, judge every lane, refill."""
        if self.inflight:
            seq, handle, predicted, snap, _, _ = self.inflight.popleft()
            b = self._fetch(handle)
            if not self.inflight:
                self.idle_from = wall_clock()
            rem = b[0]
            if not np.array_equal(rem, predicted):
                raise RuntimeError(
                    f"serve dispatch-ahead desync for bucket {self.key}: "
                    f"device remaining {rem.tolist()} != host-predicted "
                    f"{predicted.tolist()} at chunk {seq} — the lane "
                    f"masking contract broke; results cannot be trusted")
            self._boundary(seq, b, snap, sync=False)
        else:
            # nothing in flight and nothing left to step: occupants whose
            # countdown is already settled at zero (ntime=0 admits) retire
            self._judge_lanes(self.seq, self.dev_rem, None, None, sync=False)
        self._fill()

    def has_work(self) -> bool:
        return (bool(self.inflight) or bool(self.q)
                or any(o is not None for o in self.occupant))

    # --- online lane-tier growth ------------------------------------------
    def _wanted_tier(self) -> int:
        cap = self.outer.scfg.lanes
        occupied = sum(o is not None for o in self.occupant)
        return lane_tier(max(1, min(occupied + len(self.q), cap)), cap)

    def _growth_wanted(self) -> bool:
        return (self.lanes < self.outer.scfg.lanes
                and self._wanted_tier() > self.lanes)

    def maybe_grow(self) -> None:
        """Streaming admission can outgrow the lane tier this runner was
        born with (the first online request builds a tier-1 group; a burst
        then queues behind one lane). At an empty-pipeline boundary — no
        chunk in flight, so the live stack IS the last judged state —
        rebuild the group at the demanded tier and transplant every
        occupant byte for byte: its field cropped out on the card and
        reloaded into the wider stack with the same remaining count.
        Tiers are powers of two capped at ``--lanes``, so a group grows at
        most log2(lanes) times. Offline ``run()`` sizes runners from the
        full queue up front, so this never fires there."""
        if self.inflight or not self.allow_growth or not self._growth_wanted():
            return
        want = self._wanted_tier()
        old_eng, old_occ = self.eng, self.occupant
        old_rem, old_nan, old_rb = self.dev_rem, self.nan_pending, self.rb_left
        old_pert, old_steady = self.perturb_pending, self.steady_exit
        self.lanes = want
        self.eng = self._engine(want)
        self._reset_lanes(want)
        nd = self.key.ndim
        for lane, req in enumerate(old_occ):
            if req is None:
                continue
            n = req.cfg.n
            T = old_eng._fields[(lane,) + (slice(1, 1 + n),) * nd]
            self.eng.load_lane(lane, T, float(req.cfg.r), int(old_rem[lane]),
                               req.cfg.bc_value)
            self.occupant[lane] = req
            self.dev_rem[lane] = old_rem[lane]
            self.nan_pending[lane] = old_nan[lane]
            self.perturb_pending[lane] = old_pert[lane]
            self.rb_left[lane] = old_rb[lane]
            self.steady_exit[lane] = old_steady[lane]
            # the old tier's stack snapshots have the old lane count: drop
            # them; a post-growth rollback re-steps from the IC instead
        self.outer.lane_grows += 1
        self._fill()

    # --- synchronous fallback (--dispatch-depth off) ----------------------
    def sync_round(self) -> None:
        """One fenced boundary: dispatch a chunk, wait for its boundary at
        once, judge every lane on the scheduler thread, refill. ``run_sync``
        loops it to drain; the online loop calls it round-robin across
        groups so depth-0 engines still stream admissions."""
        outer = self.outer
        if self._live_remaining():
            if outer._has_lane_faults:
                self._maybe_poison()
            t0 = wall_clock()
            if self.idle_from is not None:
                outer.device_idle_s += t0 - self.idle_from
            b = self._fetch(self._dispatch(self.chunk))
            outer.chunks_dispatched += 1   # counted once fetched, as the
                                           # reference counts a fenced chunk
            self.idle_from = wall_clock()
            np.maximum(self.dev_rem - self.chunk, 0, out=self.dev_rem)
            # the live stack IS the fetched boundary's state here, so the
            # rollback snapshot is taken after the fetch
            snap = self.eng.snapshot_stack() if self.rollback else None
            self._boundary(self.seq, b, snap, sync=True)
        else:
            self._judge_lanes(self.seq, self.dev_rem, None, None, sync=True)
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
    returns the records in submit order. ``start`` serves online instead:
    a scheduler thread admits each submit at the next chunk boundary
    (``poll``/``wait``/``cancel``, ``shutdown`` to drain).
    """

    def __init__(self, scfg: Optional[ServeConfig] = None, device=None):
        from ..backends import resolve_device

        self.scfg = scfg if scfg is not None else ServeConfig()
        self.device = resolve_device(device)
        # the numerics observatory: its lock is its own and is only taken
        # after (or without) the engine lock, never before it
        self.numerics = (numerics_mod.NumericsObservatory(
            steady_tol=self.scfg.steady_tol) if self.scfg.numerics else None)
        self._queues: Dict[BucketKey, object] = {}  # policy queues
        self._records: List[dict] = []
        self._by_id: Dict[str, dict] = {}
        self._seq = 0
        # one engine-wide lock: records are mutated and emitted from both
        # the scheduler thread and the SnapshotWriter thread, and submit
        # pushes while the online scheduler thread pops; the condition the
        # online loop and wait() callers sleep on shares it
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._listeners: List[Callable[[dict], None]] = []
        # online mode: a background scheduler thread drains continuously
        self._thread: Optional[threading.Thread] = None
        self._draining = False
        self.loop_error: Optional[BaseException] = None
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
        self.lane_grows = 0          # online lane-tier growth events
        self.lanes_quarantined = 0   # requests failed nonfinite
        self.rollbacks = 0           # per-lane restore-and-re-step events
        self.deadline_misses = 0     # requests preempted/shed past deadline
        self._cancel_reqs: set = set()  # deadline-preemption by id (cancel)
        self.steady_exits = 0        # until=steady early retirements
        self.steps_saved_total = 0   # the steps those did not run
        self.shed = 0                # submits rejected by the queue bounds
        self.watchdog_fired = 0      # boundary-fetch watchdog timeouts
        self.boundaries_total = 0    # processed chunk boundaries (the
                                     # engine-kill@N address)
        # engine-scoped fault plan (scfg.inject / HEAT_TPU_FAULTS); None on
        # every normal run — the hot loop then does no fault work at all
        self._plan = faults.plan_for(self.scfg)
        self._has_lane_faults = False  # flips on when a faulted request is
                                       # admitted (gates _maybe_poison)
        self._fetch_seq = 0            # boundary-fetch counter (fetch-hang
                                       # @N addressing)

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
        policies; ``until="steady"`` retires the lane once its residual
        EWMA passes ``tol`` (default the engine's ``steady_tol``), with
        ``ntime`` as the hard cap; malformed values raise. Thread-safe: the
        online scheduler thread is woken per submit."""
        tenant, slo_class = validate_slo_fields(tenant, slo_class)
        until, tol = validate_until_fields(until, tol)
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        deadline_ms = (deadline_ms if deadline_ms is not None
                       else self.scfg.deadline_ms)
        # an until=steady request gets a closed-form eigenmode ETA at
        # admission: the EDF predicted-finish rank and the fair-share work
        predicted = None
        if until == "steady":
            eff_tol = tol if tol is not None else self.scfg.steady_tol
            predicted = conv_mod.predict_admission_steps(cfg, eff_tol)
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
                   "predicted_steps": predicted, "predicted_wall_s": None,
                   "_submit_t": wall_clock()}
            self._records.append(rec)
            self._by_id[rid] = rec
        if cfg.bc == "periodic":
            self._reject(rec, "unsupported-bc: periodic has no padded-lane "
                              "form (wraparound would wrap at the bucket "
                              "edge, not the request edge)")
            return rid
        b = _bucket_for(cfg, self.scfg.buckets)
        if b is None:
            self._reject(rec, f"bucket-overflow: request side {cfg.n} "
                              f"exceeds the biggest bucket "
                              f"{max(self.scfg.buckets)}")
            return rid
        key = BucketKey(ndim=cfg.ndim, n=b, dtype=cfg.dtype, bc=cfg.bc)
        shed_reason = None
        with self._cond:
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
                    tenant=tenant, slo_class=slo_class, seq=seq,
                    until=until, tol=tol, predicted_steps=predicted))
                self._queued_by_tenant[tenant] += 1
                self._cond.notify_all()   # wake the online scheduler
        if shed_reason is not None:
            self._reject(rec, shed_reason)
        return rid

    def _lane_faults(self, req: Request, which: str) -> list:
        """One admitted request's lane-nan steps (``which`` =
        ``"lane_nan_steps"``) or perturb ``(step, eps)`` events
        (``"perturb_events"``): the union over its own plan and the
        engine's (the two can be the SAME cached plan object — deduped by
        identity so a shared spec does not fire twice)."""
        plans = {id(p): p for p in (faults.plan_for(req.cfg), self._plan)
                 if p is not None}
        found: set = set()
        for p in plans.values():
            found.update(getattr(p, which)(req.id))
        return sorted(found)

    def _note_numerics_event(self, runner: _GroupRunner, lane: int,
                             req: Request, rem_at: int, ev: dict) -> None:
        """One numerics-observatory verdict becomes policy here: a
        structured record and — for violations under ``--numerics-guard
        quarantine`` — the runner's quarantine exit. Called from the
        scheduler thread without the engine lock held."""
        done = req.cfg.ntime - rem_at
        if ev["kind"] == "steady":
            json_record("steady_state", id=req.id, lane=lane,
                        steps_done=done, remaining=rem_at,
                        resid=ev["resid"], resid_ewma=ev["resid_ewma"],
                        steady_tol=ev["steady_tol"])
            if req.until == "steady":
                # ACT on the detector: flag the lane for frontier
                # retirement; the judge pass of this same boundary consumes
                # the flag, and _fill backfills the freed lane after it
                runner.steady_exit[lane] = rem_at
            return
        why = ev["why"]
        master_print(
            f"serve numerics: request {req.id} (lane {lane}) violated "
            f"the {why} detector at ~step {done} of {req.cfg.ntime} "
            f"(guard: {self.scfg.numerics_guard}) — see "
            f"TROUBLESHOOTING.md")
        json_record("numerics_violation", id=req.id, lane=lane, why=why,
                    steps_done=done, guard=self.scfg.numerics_guard,
                    tmin=ev.get("tmin"), tmax=ev.get("tmax"),
                    lo=ev.get("lo"), hi=ev.get("hi"), tol=ev.get("tol"),
                    heat=ev.get("heat"), heat_prev=ev.get("heat_prev"),
                    dheat=ev.get("dheat"),
                    dheat_ewma=ev.get("dheat_ewma"))
        if self.scfg.numerics_guard == "quarantine":
            runner._quarantine_numerics(lane, req, rem_at, why)

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
            self._cancel_reqs.discard(req.id)
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
        if self.numerics is not None:
            self.numerics.forget(req.id)   # terminal: drop detector state
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
        other groups keep draining. (The online loop reuses it as the
        fail-everything exit when the loop itself dies; only a real
        watchdog timeout bumps the watchdog counter.)"""
        if isinstance(exc, async_io.BoundedFetchTimeout):
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
        """Emit one terminal request record: a JSON line (when enabled), a
        condition broadcast for ``wait()`` callers, and every registered
        listener. Called from the scheduler thread and the writer thread;
        the lock keeps lines from interleaving."""
        with self._cond:
            snap = self._public(rec)
            listeners = list(self._listeners)
            if self.scfg.emit_records:
                json_record("serve_request", **snap)
            self._cond.notify_all()
        # listeners run OUTSIDE the lock: they may call poll()/summary()
        for fn in listeners:
            try:
                fn(snap)
            except Exception:  # noqa: BLE001 — a broken listener must not
                pass           # fail the request it is being told about

    # --- deadline preemption by id (cancel) --------------------------------
    def cancel(self, request_id: str) -> bool:
        """Deadline-preemption by request id. An unknown or already-terminal
        id answers False; otherwise the id is marked and the next
        chunk-boundary judge preempts it with status ``deadline`` (a queued
        request is shed at pop). Cooperative, never mid-chunk."""
        with self._lock:
            rec = self._by_id.get(request_id)
            if rec is None or rec["status"] in TERMINAL_STATUSES:
                return False
            self._cancel_reqs.add(request_id)
            self._cond.notify_all()
        return True

    def _deadline_cut(self, req: Request, now: float) -> Optional[str]:
        """``"expired" | "cancelled" | None`` — the one deadline verdict
        every chunk-boundary judge asks. The unlocked emptiness test keeps
        the no-cancellation path free of lock traffic; the membership read
        is re-taken under the lock."""
        if req.deadline_t is not None and now > req.deadline_t:
            return "expired"
        if not self._cancel_reqs:
            return None
        with self._lock:
            if req.id in self._cancel_reqs:
                return "cancelled"
        return None

    # --- incremental consumption (poll / wait / listeners) ----------------
    def poll(self, request_id: str) -> Optional[dict]:
        """Snapshot one request's record now (``None``: unknown id); never
        blocks, never drains."""
        with self._lock:
            rec = self._by_id.get(request_id)
            return None if rec is None else self._public(rec)

    def wait(self, request_id: str, timeout: Optional[float] = None
             ) -> Optional[dict]:
        """Block until a request's record is terminal; returns the record
        snapshot, or ``None`` on timeout. Raises KeyError for an unknown
        id."""
        deadline = (wall_clock() + timeout) if timeout is not None else None
        with self._cond:
            while True:
                rec = self._by_id.get(request_id)
                if rec is None:
                    raise KeyError(f"unknown request id {request_id!r}")
                if rec["status"] in TERMINAL_STATUSES:
                    return self._public(rec)
                remaining = (None if deadline is None
                             else deadline - wall_clock())
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining if remaining is not None else 0.5)

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """Register a results-ready callback: ``fn(record_snapshot)`` fires
        once per request at its terminal transition. May be called from the
        scheduler or writer thread; keep it quick."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _note_boundary(self) -> None:
        """One processed chunk boundary (every runner, scheduler thread):
        the engine-wide count that ``engine-kill@N`` addresses."""
        with self._lock:
            self.boundaries_total += 1
            n = self.boundaries_total
        if self._plan is not None:
            self._plan.maybe_engine_kill(n)

    # --- execution --------------------------------------------------------
    def run(self) -> List[dict]:
        """Drain every queued request through dispatch-ahead continuous
        batching; returns all records (submit order)."""
        if self.online:
            raise RuntimeError(
                "Engine.run()/results() cannot be called while the online "
                "scheduler thread is serving — use poll()/wait() for "
                "records, shutdown() to drain")
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

    # --- online mode ------------------------------------------------------
    @property
    def online(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def draining(self) -> bool:
        return self._draining

    def start(self) -> "Engine":
        """Start the online scheduler thread: from here on ``submit()``
        feeds lanes *while they run* — a request arriving between chunk
        boundaries is admitted at the next one. Idempotent while
        running."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._draining = False
            self.loop_error = None
            self._thread = threading.Thread(
                target=self._serve_loop, daemon=True,
                name="heat-serve-scheduler")
            self._thread.start()
        return self

    def begin_drain(self) -> None:
        """The online loop finishes every lane already admitted AND every
        request already queued, then exits. Idempotent."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def shutdown(self, timeout: Optional[float] = None) -> bool:
        """``begin_drain`` + join the scheduler thread. Returns True once
        the loop has exited (False: still draining after ``timeout``).
        Safe to call repeatedly and without ``start()``."""
        self.begin_drain()
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        if t.is_alive():
            return False
        with self._lock:
            self._thread = None
        return True

    def _serve_loop(self) -> None:
        """The online scheduler: the same dispatch-ahead round-robin as
        ``run()``, but runners persist for the engine's lifetime, a bucket
        group appears as its first request arrives, an idle group grows
        its lane tier when a burst outruns it, and an empty engine parks on
        the condition until a submit (or drain) wakes it. Exits when
        draining AND idle; the writer drains on every exit path."""
        writer = async_io.SnapshotWriter()
        runners: Dict[BucketKey, _GroupRunner] = {}
        try:
            while True:
                with self._lock:
                    keys = [k for k, q in self._queues.items() if q]
                for key in keys:
                    r = runners.get(key)
                    if r is None:
                        r = runners[key] = _GroupRunner(
                            self, key, self._queues[key], writer)
                        r.allow_growth = True
                    else:
                        r.maybe_grow()
                        r._fill()
                live = [r for r in runners.values() if r.has_work()]
                if not live:
                    with self._cond:
                        if (self._draining
                                and not any(self._queues.values())):
                            break
                        # parked: a submit()/begin_drain() notify wakes us;
                        # the timeout only bounds lost-wakeup worst cases
                        self._cond.wait(0.05)
                    continue
                if self.scfg.dispatch_depth == 0:
                    for r in live:
                        try:
                            r.sync_round()
                        except async_io.BoundedFetchTimeout as e:
                            self._fail_group(r, e)
                else:
                    for r in live:
                        r.dispatch_fill()
                    for r in live:
                        try:
                            r.process_boundary()
                            r.dispatch_fill()
                        except async_io.BoundedFetchTimeout as e:
                            self._fail_group(r, e)
        except BaseException as e:  # noqa: BLE001 — surfaced via loop_error
            # a crash in the daemon thread has nowhere to propagate: record
            # it and fail every in-flight and queued request cleanly
            with self._lock:
                self.loop_error = e
            master_print(f"serve scheduler loop failed: "
                         f"{type(e).__name__}: {e}")
            for r in runners.values():
                self._fail_group(r, e)
        finally:
            writer.drain(raise_errors=False)
            with self._cond:
                self._cond.notify_all()  # unblock wait() callers

    # --- lane retirement --------------------------------------------------
    def _finish_timing(self, req: Request, steps_done: Optional[int] = None,
                       exit_mode: str = "steps") -> dict:
        steps = int(req.cfg.ntime if steps_done is None else steps_done)
        rec = self._by_id[req.id]
        now = wall_clock()
        with self._lock:
            lane_s = now - rec.pop("_start_t", now)
            rec["solve_s"] = round(lane_s, 6)
            rec["steps_per_s"] = (round(steps / lane_s, 3)
                                  if lane_s > 0 else None)
            rec["steps_done"] = steps
            rec["exit"] = exit_mode
        if self.numerics is not None:
            self.numerics.forget(req.id)   # terminal: drop detector state
        return rec

    def _writeback_job(self, rec: dict, req: Request,
                       writer: "async_io.SnapshotWriter", get_field) -> None:
        """Build + submit the writer-thread job for one finished request.
        ``get_field()`` produces the host field — under dispatch-ahead it
        waits for the snapshot's copy *in the writer thread*."""
        cfg, scfg = req.cfg, self.scfg
        attempts = {"n": 0}
        # stamped by _finish_timing before the job runs: ntime, or the
        # steady exit's frontier
        steps_done = rec.get("steps_done")

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
                path = (str(_write_result(scfg.out_dir, req.id, T, cfg,
                                          steps=steps_done))
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
                      writer, steps_done: Optional[int] = None,
                      exit_mode: str = "steps") -> None:
        """Dispatch-ahead retirement: a one-lane snapshot enqueued behind
        the chunks in flight (the scheduler thread never waits); the D2H
        wait and the writeback run in the writer thread."""
        rec = self._finish_timing(req, steps_done=steps_done,
                                  exit_mode=exit_mode)
        snap = eng.snapshot_lane(lane, req.cfg.n)
        self._writeback_job(rec, req, writer, lambda: eng.extract(snap))

    def _finish_sync(self, eng: LaneEngine, lane: int, req: Request,
                     writer, steps_done: Optional[int] = None,
                     exit_mode: str = "steps") -> None:
        """Sync-fallback retirement: fetch the lane on the scheduler thread,
        write back in the writer."""
        rec = self._finish_timing(req, steps_done=steps_done,
                                  exit_mode=exit_mode)
        T = eng.extract_lane(lane, req.cfg.n)
        self._writeback_job(rec, req, writer, lambda: T)

    # --- reporting --------------------------------------------------------
    def summary(self) -> dict:
        """The reference's summary keys for what this port serves. Of the
        rest: ``mega_lanes`` 0 (no mega-lane tier), ``prof`` False (the cost
        observatory is not ported) and ``cache`` None (no solve cache);
        ``step_compiles`` and ``tail_compiles`` are 0 (nothing is compiled
        per bucket: the lane kernels are built once per checkout,
        ``compile_s`` is the time to load them). The cost observatory's own
        keys are left out (ROADMAP). The port adds ``lane_passes``, the
        lane kernel launches that the dispatched chunks cost by kernel,
        ``lane_passes_by_bucket``, the same by ``"<kernel> <bucket side>
        <dtype>"``, and ``lane_chunks``, those chunks by kernel."""
        with self._lock:
            by_status = collections.Counter(r["status"] for r in self._records)
            by_placement = collections.Counter(
                r["placement"] for r in self._records if r.get("placement"))
            n = len(self._records)
            queued = sum(len(q) for q in self._queues.values())
        # the observatory's snapshot AFTER the engine lock is released
        ns = self.numerics.snapshot() if self.numerics is not None else None
        by_kernel = collections.Counter()
        for (name, _, _), count in self.lane_passes.items():
            by_kernel[name] += count
        return {"requests": n, **dict(by_status),
                "device": str(self.device),
                "numerics": self.scfg.numerics,
                "numerics_guard": self.scfg.numerics_guard,
                "steady_lanes": ns["steady_total"] if ns else 0,
                "numerics_violations": ns["violation_total"] if ns else 0,
                "prof": False,
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
                "lane_grows": self.lane_grows,
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
                "rollbacks": self.rollbacks,
                "deadline_misses": self.deadline_misses,
                "steady_exits": self.steady_exits,
                "steps_saved": self.steps_saved_total,
                "cache": None,
                "shed": self.shed,
                "watchdog_fired": self.watchdog_fired}
