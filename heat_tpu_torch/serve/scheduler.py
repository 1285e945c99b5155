"""Admission queue + shape bucketing + dispatch-ahead continuous batching.

The core of ``heat_tpu.serve.scheduler``: packed lanes and mega-lanes. The
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
- **Two-tier placement**: a request whose side overflows every bucket is
  admitted, where ``mega_lanes`` allows and its side shards evenly, to the
  engine-wide mega queue and runs as a **mega-lane**: one request over
  every shard of the device mesh (``mega_device_count()`` shards, a
  ``LocalComm``) through the sharded padded-carry advance
  (``MegaLaneRunner`` + ``engine.MegaLaneEngine``), under the packed
  lanes' dispatch-ahead contract (boundary handle, dispatch depth,
  countdown mirror, finite bit, deadline / quarantine / rollback /
  watchdog: one mega-lane is a fault domain of one mesh). The run loops
  round-robin mega slots with the bucket groups. ``mega_lanes`` auto is 1
  on a host with several cards and 0 on one card or the CPU, where an
  overflow stays a rejection carrying a ``hint``; every record, cost-model
  row, usage stamp and ``/metrics`` count carries ``placement``.
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
  ``fetch-hang`` (inside the watched boundary fetch), ``engine-kill``,
  ``ckpt-manifest-corrupt`` and the solve cache's ``cache-corrupt`` /
  ``cache-stale``.
- **Observatories**: every request mints a trace id at submit, and every
  layer appends spans to the engine's bounded event ring
  (``runtime/trace.py``: lane occupancy, chunks in flight, boundary
  fetches, device-idle gaps, writer jobs), dumped on watchdog, quarantine
  after rollbacks, a numerics violation or a scheduler crash, or exported
  at drain (``trace``). The cost observatory (``runtime/prof.py``) learns
  seconds per lane-step per bucket from the boundary timestamps, samples
  the device's memory, stamps every terminal record with its ``usage``
  and aggregates the stamps per tenant.
- **Engine checkpoints** (``engine_ckpt_interval``): every N processed
  boundaries the runners stop feeding the pipeline, and at the first
  empty-pipeline cut the engine writes one field per occupied lane and a
  manifest of occupancy, queue and usage (``runtime/checkpoint.py``),
  the manifest last; ``begin_drain(handoff=True)`` checkpoints at the
  next cut without finishing lanes, and ``serve/resume.py`` continues
  the work in a new process, byte for byte.
- **Solve cache** (``cache``): a repeated request is replayed from the
  content-addressed store (``serve/solvecache.py``) without a lane; a
  request whose trajectory prefix is stored is seeded from it, and the
  lane kernels step only the delta.

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
                      SLO_TARGETS, HeatConfig, validate_slo_fields,
                      validate_until_fields)
from ..grid import ic_envelope, initial_condition_device
from ..ops import cuda_lanes
from ..runtime import async_io, faults
from ..runtime import checkpoint as ckpt_mod
from ..runtime import convergence as conv_mod
from ..runtime import numerics as numerics_mod
from ..runtime import prof as prof_mod
from ..runtime import trace as trace_mod
from ..runtime.checkpoint import savez_compressed
from ..runtime.logging import json_record, master_print
from . import policy as policy_mod
from . import solvecache as solvecache_mod
from .engine import (BucketKey, LaneEngine, MegaLaneEngine, fetch_boundary,
                     lane_tier, resolve_lane_kernel, unpack_boundary,
                     wall_clock)

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
                              # record + flight dump only; "quarantine" =
                              # also fail the request nonfinite and free
                              # its lane
    trace: Optional[str] = None  # export the event ring as Chrome
                              # trace-event JSON here at drain; None =
                              # flight recorder only (ring kept in memory,
                              # dumped on faults)
    trace_buffer: int = trace_mod.DEFAULT_BUFFER  # event-ring capacity
                              # (runtime/trace.py); 0 disables recording
                              # entirely, the flight recorder included
    flight_dir: Optional[str] = None  # flight-recorder dump directory
                              # (flightrec-<ts>.trace.json); None = out_dir;
                              # with neither set the dump is skipped
    prof: bool = True         # the cost observatory (runtime/prof.py):
                              # chunk-cost model, per-tenant usage ledger,
                              # memory watermarks, SLO burn monitor. off =
                              # aggregation, model and sampling off (the
                              # records keep their usage stamps)
    slo_targets: tuple = ()   # (("class", target), ...) per-class SLO
                              # target overrides (defaults SLO_TARGETS)
    slo_burn_threshold: float = prof_mod.SLO_BURN_THRESHOLD
                              # slo_alert once a class's fast AND slow
                              # windows burn budget above this multiple
    slo_fast_window_s: float = prof_mod.SLO_FAST_WINDOW_S
    slo_slow_window_s: float = prof_mod.SLO_SLOW_WINDOW_S
    mem_poll_every: int = prof_mod.MEM_POLL_EVERY_DEFAULT
                              # chunk boundaries between device-memory
                              # samples (leak sentinel); 0 = never
    engine_ckpt_interval: int = 0  # checkpoint the whole engine (lane
                              # fields + occupancy/queue/usage manifest)
                              # every N processed chunk boundaries, and
                              # always at drain; 0 = off
    engine_ckpt_dir: Optional[str] = None  # manifest + lane-field
                              # directory; None = <out_dir>/engine-ckpt,
                              # or ./engine-ckpt with no out_dir
    cache: bool = False       # the solve cache (serve/solvecache.py):
                              # full hits replayed without a lane, prefix
                              # hits seeded into one; every ok result and
                              # checkpoint-boundary lane field published
                              # into it. Off touches no directory
    cache_dir: Optional[str] = None  # entry directory; None =
                              # <out_dir>/solve-cache, or ./solve-cache
    cache_max_bytes: int = 0  # LRU-evict the oldest entries once the
                              # entries exceed this (0 = unbounded)
    mega_lanes: Optional[int] = None  # the second placement tier: how many
                              # mega-lanes (one bucket-overflow request
                              # over every shard of the device mesh) may
                              # run at once. None = auto: 1 where
                              # mega_device_count() > 1, else 0, where an
                              # overflow stays a rejection; 0 restores the
                              # rejection

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
        if self.mega_lanes is not None and self.mega_lanes < 0:
            raise ValueError(f"mega_lanes must be >= 0 (None = auto: 1 on "
                             f"a multi-device mesh, 0 single-device), got "
                             f"{self.mega_lanes}")
        if not self.steady_tol > 0:
            raise ValueError(f"steady_tol must be > 0, got "
                             f"{self.steady_tol}")
        if self.numerics_guard not in ("warn", "quarantine"):
            raise ValueError(f"numerics_guard must be 'warn' or "
                             f"'quarantine', got {self.numerics_guard!r}")
        if self.trace_buffer < 0:
            raise ValueError(f"trace_buffer must be >= 0 (0 disables "
                             f"recording), got {self.trace_buffer}")
        if self.trace and self.trace_buffer == 0:
            raise ValueError("trace export needs trace_buffer > 0 (the "
                             "export is the event ring's contents)")
        for cls, target in self.slo_targets:
            validate_slo_fields(None, cls)
            if not 0.0 < float(target) < 1.0:
                raise ValueError(f"SLO target must be in (0, 1), got "
                                 f"{cls}={target}")
        if self.slo_burn_threshold <= 0:
            raise ValueError(f"slo_burn_threshold must be > 0, got "
                             f"{self.slo_burn_threshold}")
        if self.slo_fast_window_s <= 0 or self.slo_slow_window_s <= 0:
            raise ValueError("SLO burn windows must be > 0 seconds, got "
                             f"{self.slo_fast_window_s}/"
                             f"{self.slo_slow_window_s}")
        if self.mem_poll_every < 0:
            raise ValueError(f"mem_poll_every must be >= 0 (0 = never "
                             f"sample), got {self.mem_poll_every}")
        if self.engine_ckpt_interval < 0:
            raise ValueError(f"engine_ckpt_interval must be >= 0 (0 = "
                             f"off), got {self.engine_ckpt_interval}")
        if self.cache_max_bytes < 0:
            raise ValueError(f"cache_max_bytes must be >= 0 (0 = "
                             f"unbounded), got {self.cache_max_bytes}")
        if self.inject:
            # fail at construction, not at a boundary mid-drain
            faults.parse_spec(self.inject)


# --serve-on-nan rollback: restores a flagged lane at most this many times
# per request before declaring the blow-up deterministic.
_MAX_LANE_ROLLBACKS = 2


def mega_device_count(device) -> int:
    """Shards a mega-lane spans on this host: one per card for an engine
    on the card, 1 on the CPU. The seam the auto ``mega_lanes`` and the
    overflow rejection's text resolve through (tests patch it to fake a
    mesh)."""
    import torch

    return torch.cuda.device_count() if device.type == "cuda" else 1


@dataclasses.dataclass
class Request:
    """One admitted solve request."""

    id: str
    cfg: HeatConfig
    submit_t: float
    key: Optional[BucketKey] = None   # None for a mega-placed request (its
                                      # "bucket" is the device mesh)
    placement: str = "packed"         # "packed" (bucket lanes) | "mega"
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
    trace_id: str = ""                  # request-scoped trace/flow id
                                        # (runtime/trace.py), minted at
                                        # submit and echoed in the record
    restore: Optional[dict] = None      # resume payload (serve/resume.py,
                                        # or a solve-cache prefix): the
                                        # host field ("T"), "remaining",
                                        # the cumulative "chunks" meter and
                                        # the saved "numerics" state; the
                                        # admitting _fill consumes it


def _bucket_for(cfg: HeatConfig, buckets) -> Optional[int]:
    """Smallest bucket side that fits the request, or None (overflow)."""
    for b in sorted(buckets):
        if cfg.n <= b:
            return b
    return None


# threads that write one engine-checkpoint generation's lane fields
_CKPT_WRITERS = 8


def _run_concurrently(jobs: List[Callable[[], None]], tracer) -> None:
    """Run ``jobs`` on up to ``_CKPT_WRITERS`` threads and return once all
    have finished; each job is one span on its thread's ``writer`` track,
    named by its ``_trace`` label (a job records its own failures)."""
    from concurrent.futures import ThreadPoolExecutor

    def run(job):
        t0 = wall_clock()
        try:
            job()
        finally:
            if tracer.enabled:
                tracer.complete(job._trace[0], tracer.thread_track("writer"),
                                t0, cat="io")

    if len(jobs) <= 1:
        for job in jobs:
            run(job)
        return
    with ThreadPoolExecutor(min(_CKPT_WRITERS, len(jobs)),
                            thread_name_prefix="heat-snapshot-writer-ckpt"
                            ) as pool:
        list(pool.map(run, jobs))


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


class _Runner:
    """What a bucket group (``_GroupRunner``) and a mega-lane slot
    (``MegaLaneRunner``) share: the dispatch-ahead loop over the in-flight
    deque of ``(seq, boundary-handle, predicted-vector, snapshot,
    t_dispatch, k)``, the host countdown mirror (``dev_rem``) checked
    against every fetch, the watched boundary fetch, the verdicts per lane
    (health, completion or a steady exit, deadline, last-good), rollback
    and quarantine, numerics ingestion, the synchronous fallback, and the
    trace, device-idle and cost-model bookkeeping. A subclass names its
    lanes in messages (``_where``), picks each chunk's k, and dispatches,
    snapshots, rolls back, retires and frees its lanes."""

    placement = "packed"
    _kind = ""                  # "mega " in the mega tier's messages

    def _init_loop(self, outer: "Engine", q,
                   writer: "async_io.SnapshotWriter") -> None:
        self.outer = outer
        self.q = q
        self.writer = writer
        scfg = outer.scfg
        self.chunk = scfg.chunk
        self.depth = max(1, scfg.dispatch_depth)
        self.rollback = scfg.on_nan == "rollback"
        self.seq = 0                        # next dispatch's sequence id
        self.inflight: collections.deque = collections.deque()
        self.idle_from: Optional[float] = None  # device queue empty since
                                                # (boundary gaps only)
        self.allow_growth = False   # the online loop opts in: offline run()
                                    # sizes runners from the full queue
        # cost-observatory feed (runtime/prof.py): last_fetch_t makes the
        # boundary service-time estimator exact under pipelining
        # (prof.CostModel)
        self.last_fetch_t: Optional[float] = None
        self.tracer = outer.tracer

    def _reset_lanes(self, lanes: int) -> None:
        """Fresh per-lane state for ``lanes`` lanes."""
        self.occupant: List[Optional[Request]] = [None] * lanes
        # first dispatch seq whose chunk covers the lane's CURRENT occupant:
        # an older in-flight chunk shows the previous occupant's (or the
        # pre-rollback) state and must not finish — or flag — the new one
        self.epoch = [self.seq] * lanes
        self.dev_rem = np.zeros(lanes, dtype=np.int64)
        # per-lane fault-domain state, (re)set at each admission: pending
        # lane-nan thresholds and (step, eps) perturb events, rollback
        # retries left, and the last verified-finite boundary (snapshot,
        # steps left)
        self.nan_pending: List[List[int]] = [[] for _ in range(lanes)]
        self.perturb_pending: List[List[tuple]] = [[] for _ in range(lanes)]
        self.rb_left = [0] * lanes
        self.last_good: List[Optional[tuple]] = [None] * lanes
        # remaining-at-detection of a lane whose until=steady occupant
        # passed tolerance this boundary; the judge pass of the same
        # process_boundary retires it at its dispatch frontier
        self.steady_exit: List[Optional[int]] = [None] * lanes
        # per-lane chunk meters back the usage stamps (one vectorized add
        # per dispatch)
        self.lane_chunks = np.zeros(lanes, dtype=np.int64)

    def _admit(self, lane: int, req: Request, rst: Optional[dict]) -> None:
        """The fault-domain and numerics state of ``req``, admitted into
        ``lane`` (from its IC, or from a resume payload ``rst``)."""
        outer = self.outer
        self.lane_chunks[lane] = int((rst or {}).get("chunks", 0))
        self.occupant[lane] = req
        self.nan_pending[lane] = outer._lane_faults(req, "lane_nan_steps")
        self.perturb_pending[lane] = outer._lane_faults(req, "perturb_events")
        if self.nan_pending[lane] or self.perturb_pending[lane]:
            outer._has_lane_faults = True  # gates _maybe_poison
        self.rb_left[lane] = _MAX_LANE_ROLLBACKS
        self.steady_exit[lane] = None   # never inherit a prior occupant's
                                        # verdict
        if outer.numerics is not None:
            # arm the detectors: the analytic IC/BC envelope (no device
            # work), the request's steady tolerance and the closed-form
            # eigenmode rate seeding the ETA fuser
            lo, hi = ic_envelope(req.cfg)
            outer.numerics.admit(
                req.id, lo, hi, req.cfg.dtype, steady_tol=req.tol,
                log_rate=conv_mod.closed_form_log_rate(req.cfg))
            if rst and rst.get("numerics"):
                # resume continuity: EWMAs, fired latches and the ETA
                # fuser pick up where the checkpointed incarnation left them
                outer.numerics.reseed(req.id, rst["numerics"])

    def _live_remaining(self) -> List[int]:
        return [int(self.dev_rem[i]) for i, o in enumerate(self.occupant)
                if o is not None and self.dev_rem[i] > 0]

    def has_work(self) -> bool:
        return (bool(self.inflight) or bool(self.q)
                or any(o is not None for o in self.occupant))

    def maybe_grow(self) -> None:
        """Only a bucket group grows (``_GroupRunner.maybe_grow``)."""

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
                self._poison(lane, req)
            while (self.perturb_pending[lane]
                   and done >= self.perturb_pending[lane][0][0]):
                _, eps = self.perturb_pending[lane].pop(0)  # fire-once
                self._perturb(lane, req, eps)

    def _close_idle(self, t: float) -> None:
        """A dispatch at ``t`` ends the device-idle gap since the last
        boundary emptied the pipeline."""
        if self.idle_from is not None:
            self.outer.device_idle_s += t - self.idle_from
            if self.tracer.enabled:
                # the idle gap, attributed to this runner's dispatch row
                self.tracer.complete("device-idle", self.group_track,
                                     self.idle_from, t, cat="idle")
            self.idle_from = None

    def dispatch_fill(self) -> None:
        """Queue chunks until ``dispatch_depth`` are in flight or no lane has
        steps left to run. Pure host->device enqueue: no fetch, no fence."""
        if self.outer._ckpt_pause:
            # checkpoint bubble: stop feeding the pipeline so the chunks in
            # flight drain to the empty cut (Engine._ckpt_tick)
            return
        while len(self.inflight) < self.depth:
            k = self._next_k()
            if k is None:
                break
            t_disp = wall_clock()
            handle = self._dispatch(k)
            self._close_idle(t_disp)
            # usage metering: every lane still counting down takes part in
            # this chunk (freed lanes' meters reset at the next admission)
            self.lane_chunks += self.dev_rem > 0
            np.maximum(self.dev_rem - k, 0, out=self.dev_rem)
            # rollback mode keeps every in-flight boundary restorable: the
            # snapshot is promoted to a lane's last_good only once that
            # boundary's finite bit comes back clean
            snap = self._snapshot() if self.rollback else None
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
            return self._fetch_boundary(
                handle, timeout_s=outer.scfg.fetch_timeout_s,
                plan=outer._plan, fetch_index=outer._fetch_seq)
        finally:
            outer._fetch_seq += 1
            t1 = wall_clock()
            outer.boundary_wait_s += t1 - t0
            outer.boundary_waits += 1
            if self.tracer.enabled:
                # boundary_wait_s, attributed: each fetch's blocked wall is
                # one span on the scheduler thread's row
                self.tracer.complete("boundary-fetch",
                                     self.tracer.thread_track("scheduler"),
                                     t0, t1, cat="boundary",
                                     args={"bucket": self.track_name})

    def _observe(self, depth: int, k: int, wall_s: float, t: float) -> None:
        """Cost-model feed: one chunk's boundary service time, then the
        cadenced memory sample."""
        outer = self.outer
        outer.prof.observe_chunk(self.cost_label, self.lanes, depth, k,
                                 wall_s, kernel=self.kernel,
                                 placement=self.placement)
        warn = outer.prof.maybe_sample_memory(t)
        if warn is not None:
            outer._mem_warn(warn)

    def _trace_occupancy(self, lane: int, req: Request, status: str) -> None:
        """Close the lane's occupancy span (admission -> this verdict) on
        its track. Runs before the finish/fail path pops ``_start_t``."""
        tr = self.tracer
        if not tr.enabled:
            return
        t0 = self.outer._by_id[req.id].get("_start_t")
        if t0 is None:
            return
        args = {"status": status, "n": req.cfg.n, "ntime": req.cfg.ntime}
        if self.placement != "packed":
            args["placement"] = self.placement
        tr.complete(req.id, self.lane_tracks[lane], t0, cat="lane",
                    trace_id=req.trace_id, args=args)
        tr.flow("t", self.lane_tracks[lane], req.trace_id)

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
                steps_done, exit_mode = self._exit(lane, req)
                self._trace_occupancy(lane, req, "retired")
                self._retire(lane, req, sync, steps_done, exit_mode)
                self._free(lane)
            elif (cut := outer._deadline_cut(req, now)) is not None:
                done = req.cfg.ntime - int(rem[lane])
                where = self._where(lane)
                self._trace_occupancy(lane, req, "deadline")
                outer._fail_request(
                    req, "deadline",
                    (f"deadline: cancelled (deadline-preemption) with "
                     f"~{done} of {req.cfg.ntime} steps done; {where} "
                     f"preempted at the chunk boundary"
                     if cut == "cancelled" else
                     f"deadline: exceeded its "
                     f"{1e3 * (req.deadline_t - req.submit_t):.0f} ms "
                     f"budget with ~{done} of {req.cfg.ntime} steps done; "
                     f"{where} preempted at the chunk boundary"),
                    lane=lane, steps_done=done,
                    chunks=int(self.lane_chunks[lane]))
                outer.deadline_misses += 1
                self._free(lane)
            elif self.rollback and snap is not None:
                self.last_good[lane] = (snap, int(rem[lane]))

    def _exit(self, lane: int, req: Request) -> tuple:
        """``(steps_done, exit_mode)`` of a retiring lane. A steady exit
        retires at the dispatch FRONTIER: the chunks in flight keep running
        (the countdown mirror is untouched, so the desync check stays
        exact) and the retirement snapshot is enqueued behind them, so the
        field carries exactly ntime - dev_rem steps — byte-equal to a
        fixed-step run cut there. At depth 0 the frontier IS the detection
        boundary."""
        outer = self.outer
        steady_at = self.steady_exit[lane]
        self.steady_exit[lane] = None
        if steady_at is None:
            return req.cfg.ntime, "steps"
        steps_done = req.cfg.ntime - int(self.dev_rem[lane])
        if steps_done >= req.cfg.ntime:
            return req.cfg.ntime, "steps"
        outer.steady_exits += 1
        with outer._lock:
            outer.steps_saved_total += req.cfg.ntime - steps_done
        if self.tracer.enabled:
            self.tracer.instant(
                "steady-exit", self.lane_tracks[lane], trace_id=req.trace_id,
                args={"id": req.id, "at_step": steps_done,
                      "requested": req.cfg.ntime,
                      "saved": req.cfg.ntime - steps_done,
                      "predicted_at_step": req.predicted_steps})
        return steps_done, "steady"

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
            if self.tracer.enabled:
                self.tracer.instant("rollback", self.lane_tracks[lane],
                                    trace_id=req.trace_id,
                                    args={"id": req.id, "at_step": done})
            tries = _MAX_LANE_ROLLBACKS - self.rb_left[lane]
            self._rollback(lane, req, done,
                           f"attempt {tries}/{_MAX_LANE_ROLLBACKS}")
            return
        exhausted = self.rollback and self.rb_left[lane] == 0
        tried = (f" after {_MAX_LANE_ROLLBACKS} rollbacks "
                 f"(deterministic blow-up)" if exhausted else "")
        if self.tracer.enabled:
            self.tracer.instant("quarantine", self.lane_tracks[lane],
                                trace_id=req.trace_id,
                                args={"id": req.id, "at_step": done})
        self._trace_occupancy(lane, req, "nonfinite")
        outer._fail_request(
            req, "nonfinite",
            f"nonfinite: non-finite field detected at ~step {done} of "
            f"{req.cfg.ntime} ({self._where(lane)}){tried} — check the CFL "
            f"bound sigma <= 1/(2*ndim) for this request", lane=lane,
            steps_done=done, chunks=int(self.lane_chunks[lane]))
        outer.lanes_quarantined += 1
        if exhausted:
            # flight-recorder trigger: the ring holds the lane's whole
            # restore/re-flag history
            outer._flight_dump(f"quarantine after {_MAX_LANE_ROLLBACKS} "
                               f"rollbacks ({self._kind}request {req.id})")
        # free the lane; a packed lane's NaN field idles masked (its
        # countdown still mirrored by dev_rem) until a new request's load
        # overwrites the whole lane buffer
        self._free(lane)

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
        tr = self.tracer
        for lane in range(self.lanes):
            req = self.occupant[lane]
            if req is None or seq < self.epoch[lane]:
                continue
            if tr.enabled:
                # counter track: the lane's residual/heat series
                tr.counter(self._numerics_counter(lane), self.group_track,
                           {"resid": resid[lane], "heat": heat[lane]})
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
        if self.tracer.enabled:
            self.tracer.instant("quarantine", self.lane_tracks[lane],
                                trace_id=req.trace_id,
                                args={"id": req.id, "at_step": done,
                                      "why": why})
        self._trace_occupancy(lane, req, "nonfinite")
        outer._fail_request(
            req, "nonfinite",
            f"numerics: {why} violation at ~step {done} of "
            f"{req.cfg.ntime} ({self._where(lane)}) — the field is finite "
            f"but un-physical; check r against the CFL bound "
            f"sigma <= 1/(2*ndim), dtype drift, or an injected perturb "
            f"fault (TROUBLESHOOTING.md)", lane=lane, steps_done=done,
            chunks=int(self.lane_chunks[lane]))
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
            seq, handle, predicted, snap, t_disp, k = self.inflight.popleft()
            b = self._fetch(handle)
            t_done = wall_clock()
            if self.tracer.enabled:
                # chunk-in-flight span: dispatch enqueue -> boundary
                # fetched (the newer chunks compute behind it)
                name, args = self._chunk_span(seq, k, fenced=False)
                self.tracer.complete(name, self.group_track, t_disp, t_done,
                                     cat="chunk", args=args)
            if self.outer.prof.enabled:
                base = (t_disp if self.last_fetch_t is None
                        else max(self.last_fetch_t, t_disp))
                self._observe(self.depth, k, t_done - base, t_done)
                self.last_fetch_t = t_done
            if not self.inflight:
                self.idle_from = t_done
            rem = b[0]
            if not np.array_equal(rem, predicted):
                subject, contract = self._desync_names()
                raise RuntimeError(
                    f"serve dispatch-ahead desync for {subject}: device "
                    f"remaining {rem.tolist()} != host-predicted "
                    f"{predicted.tolist()} at chunk {seq} — the {contract} "
                    f"contract broke; results cannot be trusted")
            self._boundary(seq, b, snap, sync=False)
        else:
            # nothing in flight and nothing left to step: occupants whose
            # countdown is already settled at zero (ntime=0 admits) retire
            self._judge_lanes(self.seq, self.dev_rem, None, None, sync=False)
        self._fill()

    # --- synchronous fallback (--dispatch-depth off) ----------------------
    def sync_round(self) -> None:
        """One fenced boundary: dispatch a chunk, wait for its boundary at
        once, judge every lane on the scheduler thread, refill. ``run_sync``
        loops it to drain; the online loop calls it round-robin across
        runners so depth-0 engines still stream admissions."""
        outer = self.outer
        if self._live_remaining():
            if outer._has_lane_faults:
                self._maybe_poison()
            k = self._fenced_k()
            t0 = wall_clock()
            self._close_idle(t0)
            b = self._fetch(self._dispatch(k))
            outer.chunks_dispatched += 1   # counted once fetched, as the
                                           # reference counts a fenced chunk
            self.idle_from = wall_clock()
            if self.tracer.enabled:
                name, args = self._chunk_span(self.seq, k, fenced=True)
                self.tracer.complete(name, self.group_track, t0,
                                     self.idle_from, cat="chunk", args=args)
            if outer.prof.enabled:
                # fenced boundary: the dispatch->fetch wall IS the chunk's
                # service time (cost-model depth 0)
                self._observe(0, k, self.idle_from - t0, self.idle_from)
            self.lane_chunks += self.dev_rem > 0
            np.maximum(self.dev_rem - k, 0, out=self.dev_rem)
            # the live state IS the fetched boundary's here, so the
            # rollback snapshot is taken after the fetch
            snap = self._snapshot() if self.rollback else None
            self._boundary(self.seq, b, snap, sync=True)
        else:
            self._judge_lanes(self.seq, self.dev_rem, None, None, sync=True)
        self.seq += 1
        self._fill()

    def run_sync(self) -> None:
        """Fetch every boundary as its chunk is dispatched and retire
        finished lanes on the scheduler thread: no pipelining, no tails,
        the same per-lane fault domains."""
        while self.has_work():
            self.sync_round()
            # every fenced round is an empty-pipeline cut: take an armed
            # engine checkpoint here
            self.outer._ckpt_tick()


class _GroupRunner(_Runner):
    """Dispatch-ahead continuous batching for ONE bucket group.

    Owns the group's ``LaneEngine``, occupancy, the host-side countdown
    mirror (``dev_rem`` — exact, because the device decrements remaining by
    one per step while positive), and the in-flight deque (``_Runner``).
    ``Engine.run`` drives many runners round-robin; each tick dispatches
    until ``dispatch_depth`` chunks are queued, then takes at most one
    boundary.
    """

    def __init__(self, outer: "Engine", key: BucketKey, q,
                 writer: "async_io.SnapshotWriter"):
        self._init_loop(outer, q, writer)
        self.key = key
        scfg = outer.scfg
        self.lanes = lane_tier(min(len(q), scfg.lanes), scfg.lanes)
        self.kernel, self._kernel_fb = resolve_lane_kernel(
            scfg.lane_kernel, key, outer.device)
        self.eng = self._engine(self.lanes)
        # the kernel launches each chunk costs, counted on the host from k
        # (the wrappers count what they launch): lanes2d/lanes3d by name
        self._kernel_name = (cuda_lanes._KERNELS[key.ndim]
                             if self.kernel == "cuda"
                             and outer.device.type == "cuda" else None)
        self._reset_lanes(self.lanes)
        # the cost model's key names the bucket geometry
        self.cost_label = f"{key.ndim}d/n{key.n}/{key.dtype}/{key.bc}"
        # trace tracks (runtime/trace.py): one process row per bucket
        # group, one thread row per lane (the occupancy timeline) plus a
        # dispatch row for chunk-in-flight / device-idle spans, registered
        # once so the per-event path is append-only
        self.track_name = (f"lanes {key.ndim}d n{key.n} "
                           f"{key.dtype} {key.bc}")
        self.group_track = self.tracer.track(self.track_name, "dispatch")
        self.lane_tracks = [self.tracer.track(self.track_name, f"lane {i}")
                            for i in range(self.lanes)]
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

    # --- what names and moves a lane -------------------------------------
    def _where(self, lane: int) -> str:
        return f"lane {lane}"

    def _numerics_counter(self, lane: int) -> str:
        return f"numerics lane {lane}"

    def _desync_names(self) -> tuple:
        return f"bucket {self.key}", "lane masking"

    def _chunk_span(self, seq: int, k: int, fenced: bool) -> tuple:
        return (f"chunk {seq} ({k} steps{', fenced' if fenced else ''})",
                {"seq": seq, "k": k})

    def _fetch_boundary(self, handle, **kw) -> np.ndarray:
        return self.eng.fetch_remaining(handle, **kw)

    def _poison(self, lane: int, req: Request) -> None:
        self.eng.poison_lane(lane, req.cfg.n)

    def _perturb(self, lane: int, req: Request, eps: float) -> None:
        self.eng.perturb_lane(lane, req.cfg.n, eps)

    def _snapshot(self):
        return self.eng.snapshot_stack()

    def _free(self, lane: int) -> None:
        self.occupant[lane] = None
        self.nan_pending[lane] = []
        self.perturb_pending[lane] = []
        self.last_good[lane] = None

    # --- admission into lanes --------------------------------------------
    def _fill(self) -> None:
        """Swap queued requests into every free lane (continuous batching).
        The initial field is built on the engine's device and loaded behind
        the chunks in flight. Queued requests already past their deadline
        (or cancelled) are shed here."""
        outer = self.outer
        if outer._ckpt_pause:
            # checkpoint bubble: no admissions while the pipeline drains
            # toward the consistent cut — queued requests belong to the
            # manifest, not to a lane
            return
        for lane in range(self.lanes):
            if self.occupant[lane] is None:
                req = outer._next_admission(self, lane)
                if req is None:
                    continue
                # an engine-state resume or a cache prefix re-seeds the
                # lane from its stored field (the maybe_grow transplant
                # contract: the lanes round to storage every step, so the
                # continuation is byte-equal to an uninterrupted run) and
                # its chunk meter continues; else it restarts at 0
                rst, req.restore = req.restore, None
                self._load_ic(lane, req, rst)
                self._admit(lane, req, rst)

    def _load_ic(self, lane: int, req: Request,
                 rst: Optional[dict] = None) -> None:
        """(Re)start ``req`` in ``lane`` from its initial condition (the
        field built on the card, the full countdown), or from a resume
        payload ``rst`` (its host field and remaining count), with a new
        epoch (the chunks in flight show the lane's previous state)."""
        if rst:
            T0, steps = rst["T"], int(rst["remaining"])
        else:
            T0 = initial_condition_device(req.cfg, self.outer.device)
            steps = req.cfg.ntime
        self.eng.load_lane(lane, T0, float(req.cfg.r), steps,
                           req.cfg.bc_value)
        self.dev_rem[lane] = steps
        self.epoch[lane] = self.seq
        self.last_good[lane] = None

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

    def _next_k(self) -> Optional[int]:
        """The next chunk's steps, or None to stop feeding the pipeline:
        the full chunk, or the lane engine's tail once every live lane
        finishes inside a chunk."""
        if self.allow_growth and self._growth_wanted():
            # stop feeding the pipeline: once the in-flight chunks drain,
            # maybe_grow rebuilds the group at the wider tier
            return None
        if not self._live_remaining():
            return None
        if self.outer._has_lane_faults:
            self._maybe_poison()
        tail = self.eng.tail
        if (tail is not None
                and max(self._effective_remaining()) <= self.chunk - tail):
            # every live lane finishes (or is PREDICTED to steady-exit)
            # inside the chunk, with enough headroom that ceil(rem/tail)
            # tails compute strictly fewer masked steps than one chunk
            self.outer.tail_chunks += 1
            return tail
        return self.chunk

    def _fenced_k(self) -> int:
        return self.chunk

    # --- verdicts ---------------------------------------------------------
    def _retire(self, lane: int, req: Request, sync: bool, steps_done: int,
                exit_mode: str) -> None:
        outer = self.outer
        finish = outer._finish_sync if sync else outer._finish_async
        finish(self.eng, lane, req, self.writer,
               chunks=int(self.lane_chunks[lane]), steps_done=steps_done,
               exit_mode=exit_mode)

    def _rollback(self, lane: int, req: Request, done: int,
                  attempt: str) -> None:
        if self.last_good[lane] is not None:
            good_snap, steps_left = self.last_good[lane]
            master_print(
                f"serve on-nan rollback: request {req.id} (lane {lane}) "
                f"non-finite at ~step {done}; restoring the last "
                f"verified boundary ({steps_left} steps left, "
                f"{attempt})")
            self.eng.restore_lane(lane, good_snap[lane], float(req.cfg.r),
                                  req.cfg.n, steps_left)
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
        old_chunks = self.lane_chunks
        if self.tracer.enabled:
            self.tracer.instant("lane-tier-grow", self.group_track,
                                args={"from": self.lanes, "to": want})
        self.lanes = want
        self.eng = self._engine(want)
        self._reset_lanes(want)
        self.lane_tracks = [self.tracer.track(self.track_name, f"lane {i}")
                            for i in range(want)]
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
            self.lane_chunks[lane] = old_chunks[lane]
            self.nan_pending[lane] = old_nan[lane]
            self.perturb_pending[lane] = old_pert[lane]
            self.rb_left[lane] = old_rb[lane]
            self.steady_exit[lane] = old_steady[lane]
            # the old tier's stack snapshots have the old lane count: drop
            # them; a post-growth rollback re-steps from the IC instead
        self.outer.lane_grows += 1
        self._fill()


class MegaLaneRunner(_Runner):
    """Dispatch-ahead serving for ONE mega-lane slot: a bucket group whose
    "bucket" is the whole device mesh and whose lane count is one.
    Requests that overflow every bucket queue in the engine-wide mega
    queue (``Engine.submit``) and run through ``MegaLaneEngine`` under the
    packed runners' contract (``_Runner``): a boundary handle per chunk,
    ``dispatch_depth`` chunks in flight, the host countdown mirror checked
    against every fetch, the owned cells' finite bit and stats on the
    boundary copy, and the deadline / quarantine / rollback / watchdog
    verdicts of a fault domain one mesh wide. What differs: the host picks
    each chunk's k (the sharded advance has no per-step countdown mask),
    snapshots and rollbacks hold the whole mesh state, and a retirement
    crops the owned field. ``Engine.run`` round-robins it with the bucket
    groups.

    One slot serves one request at a time; ``mega_lanes`` slots share the
    mega queue. A wedged mega fetch (watchdog) fails the mega tier's
    in-flight and queued requests (``Engine._fail_group``): one mesh, one
    fault domain."""

    placement = "mega"
    _kind = "mega "

    def __init__(self, outer: "Engine", slot: int, q,
                 writer: "async_io.SnapshotWriter"):
        self._init_loop(outer, q, writer)
        self.slot = slot
        self.lanes = 1
        self.kernel = "sharded"
        self.key = ("mega", slot)
        self._reset_lanes(1)
        self.eng: Optional[MegaLaneEngine] = None   # per occupant
        self.cost_label = "mega"       # refined per occupant
        self.track_name = f"mega lane {slot}"
        self.group_track = self.tracer.track(self.track_name, "dispatch")
        self.lane_tracks = [self.tracer.track(self.track_name, "mesh")]
        self._fill()

    # --- what names and moves the lane -----------------------------------
    def _where(self, lane: int) -> str:
        return "mega lane"

    def _numerics_counter(self, lane: int) -> str:
        return "numerics mega"

    def _desync_names(self) -> tuple:
        return f"mega lane {self.slot}", "mega countdown"

    def _chunk_span(self, seq: int, k: int, fenced: bool) -> tuple:
        """The chunk span carries the halo geometry (ghost width, and the
        exchanges of a pipelined chunk)."""
        kf = self.eng.kf if self.eng is not None else 0
        if fenced:
            return (f"mega chunk {seq} ({k} steps, fenced)",
                    {"seq": seq, "k": k, "halo_width": kf})
        return (f"mega chunk {seq} ({k} steps)",
                {"seq": seq, "k": k, "halo_width": kf,
                 "exchanges": -(-(k - 1) // kf) + 1 if kf else 0})

    def _fetch_boundary(self, handle, **kw) -> np.ndarray:
        return fetch_boundary(handle, **kw)

    def _poison(self, lane: int, req: Request) -> None:
        self.eng.poison_center()

    def _perturb(self, lane: int, req: Request, eps: float) -> None:
        self.eng.perturb_center(eps)

    def _snapshot(self):
        return self.eng.snapshot_state()

    def _free(self, lane: int) -> None:
        """Free the slot and the carried shards after a terminal verdict;
        stale boundaries in flight are judged by seq/epoch and dropped."""
        self.occupant[0] = None
        self.eng = None
        self.dev_rem[0] = 0
        self.nan_pending[0] = []
        self.perturb_pending[0] = []
        self.last_good[0] = None
        self.steady_exit[0] = None
        self.epoch[0] = self.seq

    # --- admission --------------------------------------------------------
    def _fill(self) -> None:
        """Admit the next queued mega request into this slot: build its
        ``MegaLaneEngine`` (the machinery warm from the engine-wide cache)
        on the scheduler thread. Queued requests past their deadline are
        shed here, and a build failure fails that one request — never the
        scheduler loop."""
        outer = self.outer
        if outer._ckpt_pause:
            # checkpoint bubble: queued mega requests ride the manifest
            return
        while self.occupant[0] is None:
            req = outer._next_admission(self, 0)
            if req is None:
                break
            try:
                self.eng = MegaLaneEngine(
                    req.cfg, mega_device_count(outer.device), self.chunk,
                    device=outer.device, cache=outer._mega_cache,
                    on_compile=outer._note_mega_compile)
            except Exception as e:  # noqa: BLE001 — per-request record
                outer._fail_request(
                    req, "error",
                    f"mega-lane build failed: {type(e).__name__}: {e}",
                    lane=0)
                continue
            self.cost_label = (f"{req.cfg.ndim}d/n{req.cfg.n}/"
                               f"{req.cfg.dtype}/{req.cfg.bc}")
            rst, req.restore = req.restore, None
            if rst:
                # engine-state resume or a cache prefix: the stored owned
                # field at a chunk boundary, continued byte for byte
                self.eng.load(rst["T"], int(rst["remaining"]))
                self.dev_rem[0] = int(rst["remaining"])
            else:
                self.dev_rem[0] = req.cfg.ntime
            self.epoch[0] = self.seq
            self.last_good[0] = None
            self._admit(0, req, rst)

    # --- dispatch side ----------------------------------------------------
    def _dispatch(self, k: int):
        """Enqueue one k-step mega chunk; returns its boundary handle."""
        handle = self.eng.dispatch_chunk(k)
        self.outer.mega_chunks += 1
        return handle

    def _next_k(self) -> Optional[int]:
        """The last chunk shrinks to the exact remaining count."""
        rem = int(self.dev_rem[0])
        if self.occupant[0] is None or rem <= 0:
            return None
        if self.outer._has_lane_faults:
            self._maybe_poison()
        return min(self.chunk, rem)

    def _fenced_k(self) -> int:
        return min(self.chunk, int(self.dev_rem[0]))

    # --- verdicts ---------------------------------------------------------
    def _retire(self, lane: int, req: Request, sync: bool, steps_done: int,
                exit_mode: str) -> None:
        """Completion: the owned field cropped on the card behind the
        chunks in flight, its host copy and the result write in the writer
        thread (the closure holds the cropped field only)."""
        outer = self.outer
        rec = outer._finish_timing(req, chunks=int(self.lane_chunks[0]),
                                   steps_done=steps_done,
                                   exit_mode=exit_mode)
        snap = self.eng.final_snapshot()
        if sync:
            T = MegaLaneEngine.extract(snap)
            outer._writeback_job(rec, req, self.writer, lambda: T)
        else:
            outer._writeback_job(rec, req, self.writer,
                                 lambda: MegaLaneEngine.extract(snap))

    def _rollback(self, lane: int, req: Request, done: int,
                  attempt: str) -> None:
        """Restore and re-step the whole mesh state; the packed groups are
        untouched."""
        if self.last_good[0] is not None:
            good_snap, steps_left = self.last_good[0]
            master_print(
                f"serve on-nan rollback: mega request {req.id} "
                f"non-finite at ~step {done}; restoring the last "
                f"verified boundary ({steps_left} steps left, "
                f"{attempt})")
            self.eng.restore(good_snap, steps_left)
            self.dev_rem[0] = steps_left
        else:
            master_print(
                f"serve on-nan rollback: mega request {req.id} "
                f"non-finite at ~step {done}; re-stepping from the "
                f"initial condition ({attempt})")
            self.eng.reload()
            self.dev_rem[0] = req.cfg.ntime
        self.epoch[0] = self.seq
        self.last_good[0] = None


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

        self.scfg = scfg = scfg if scfg is not None else ServeConfig()
        self.device = resolve_device(device)
        # request-scoped tracing + always-on flight recorder
        # (runtime/trace.py): trace ids are minted even with
        # trace_buffer=0, so the record schema never flickers
        self.tracer = trace_mod.Tracer(capacity=scfg.trace_buffer)
        # the cost observatory (runtime/prof.py) and the numerics
        # observatory: their locks are their own and are only taken after
        # (or without) the engine lock, never before it, so the gateway's
        # scrape threads can never deadlock the hot path
        targets = dict(SLO_TARGETS)
        targets.update((c, float(t)) for c, t in scfg.slo_targets)
        self.prof = prof_mod.Observatory(
            enabled=scfg.prof, slo_targets=targets,
            mem_poll_every=scfg.mem_poll_every,
            slo_fast_window_s=scfg.slo_fast_window_s,
            slo_slow_window_s=scfg.slo_slow_window_s,
            slo_burn_threshold=scfg.slo_burn_threshold,
            device=self.device)
        self.numerics = (numerics_mod.NumericsObservatory(
            steady_tol=scfg.steady_tol) if scfg.numerics else None)
        self._queues: Dict[BucketKey, object] = {}  # policy queues
        # the second placement tier: the engine-wide mega queue (same
        # policy as the bucket queues, built at the first mega admission),
        # the mega machinery cache shared by every occupant, and the
        # resolved slot budget
        self._mega_queue = None
        self._mega_cache: dict = {}
        self._mega_lanes_resolved: Optional[int] = None
        self.mega_compiles = 0       # mega machinery builds
        self.mega_chunks = 0         # mega chunks dispatched
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
        # per-class end-to-end latency and queue-depth-at-submit histograms
        # (the gateway's /metrics)
        self.lat_hist: Dict[str, policy_mod.Histogram] = {}
        self.depth_hist = policy_mod.Histogram(policy_mod.DEPTH_BUCKETS)
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
                                     # checkpoint cadence clock and the
                                     # engine-kill@N address)
        # engine-state checkpointing: crossing the interval arms
        # _ckpt_pause (runners stop feeding the pipeline) and the driving
        # loop takes the manifest at the first empty-pipeline cut
        # (_ckpt_tick). Mutated on the scheduler thread under the engine
        # lock; /drainz?handoff=1 flips _ckpt_pause/_handoff under it too
        self.serve_resumed_total = 0  # requests re-admitted by --resume
        self._engine_ckpt_gen = 0     # last PUBLISHED manifest generation
        self._engine_ckpt_next = 0    # next generation to write (0 = scan
                                      # the directory first)
        self._last_ckpt_boundary = 0  # cadence clock at the last publish
        self._ckpt_pause = False      # armed: drain to the empty cut
        self._handoff = False         # drain-to-checkpoint requested
        self._active_runners = ()     # the driving loop's live runners and
        self._active_writer = None    # its writer (scheduler thread only)
        # engine-scoped fault plan (scfg.inject / HEAT_TPU_FAULTS); None on
        # every normal run — the hot loop then does no fault work at all
        self._plan = faults.plan_for(self.scfg)
        # the solve cache: consulted at submit, fed by the writer thread's
        # result publishes and the engine checkpoints' lane fields; None
        # with --cache off (every call site skips on one test)
        self.solvecache = None
        if scfg.cache:
            from pathlib import Path

            cache_dir = scfg.cache_dir or (
                str(Path(scfg.out_dir) / "solve-cache") if scfg.out_dir
                else "solve-cache")
            self.solvecache = solvecache_mod.SolveCache(
                cache_dir, max_bytes=scfg.cache_max_bytes, plan=self._plan)
        # the gateway's canary prober (serve/probe.py), attached by the
        # CLI before any thread starts; /metrics and /statusz read it
        self.prober = None
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
               tol: Optional[float] = None,
               _restore: Optional[dict] = None) -> str:
        """Admit one request; returns its id. Unservable requests become
        status='rejected' records instead of raising. ``deadline_ms`` bounds
        the request's wall time from submission (overriding the engine
        default); ``tenant``/``slo_class`` drive the fair-share and EDF
        policies; ``until="steady"`` retires the lane once its residual
        EWMA passes ``tol`` (default the engine's ``steady_tol``), with
        ``ntime`` as the hard cap; malformed values raise.

        ``_restore`` (serve/resume.py only) re-admits a request recovered
        from an engine checkpoint: ``{}`` for one that was queued, or the
        checkpointed field/remaining/usage partials of one mid-solve,
        which the admitting lane fill continues byte for byte.

        Thread-safe: the gateway's handler threads call this while the
        online scheduler thread drains; the scheduler is woken per
        submit."""
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
            trace_id = self.tracer.mint_trace_id()
            rec = {"id": rid, "n": cfg.n, "ndim": cfg.ndim,
                   "ntime": cfg.ntime, "dtype": cfg.dtype, "bc": cfg.bc,
                   "tenant": tenant, "class": slo_class, "status": "queued",
                   "placement": None, "bucket": None, "lane": None,
                   "queue_wait_s": None, "solve_s": None,
                   "steps_per_s": None, "error": None,
                   "deadline_ms": deadline_ms, "trace_id": trace_id,
                   "until": until, "steps_done": None, "exit": None,
                   "predicted_steps": predicted, "predicted_wall_s": None,
                   "resumed": _restore is not None, "cached": False,
                   "_submit_t": wall_clock()}
            if _restore is not None:
                # usage partials from the checkpointed incarnation: the
                # terminal stamp folds them in (the step count spans both
                # incarnations by construction)
                self.serve_resumed_total += 1
                rec["_resumed_lane_s"] = float(_restore.get("lane_s")
                                               or 0.0)
            self._records.append(rec)
            self._by_id[rid] = rec
        if self.tracer.enabled:
            # flow start: the submitting thread anchors the request's
            # cross-thread arrow
            self.tracer.flow("s", self.tracer.thread_track(), trace_id,
                             ts=rec["_submit_t"])
        if cfg.bc == "periodic":
            self._reject(rec, "unsupported-bc: periodic has no padded-lane "
                              "form (wraparound would wrap at the bucket "
                              "edge, not the request edge)")
            return rid
        b = _bucket_for(cfg, self.scfg.buckets)
        key = None
        placement = "packed"
        if b is None:
            # two-tier placement: a bucket overflow goes to the mega queue
            # (one request over the whole device mesh) wherever mega-lanes
            # are on and its side shards evenly, else it is rejected
            reason, hint = self._mega_overflow_reason(cfg)
            if reason is not None:
                self._reject(rec, reason, hint=hint)
                return rid
            placement = "mega"
        else:
            key = BucketKey(ndim=cfg.ndim, n=b, dtype=cfg.dtype, bc=cfg.bc)
        if predicted is not None and self.prof.enabled:
            rec["predicted_wall_s"] = self._forecast_wall(cfg, b, predicted)
        # solve-cache consult at the admission door, after every rejection
        # gate: only fixed-step requests consume the cache (a steady exit
        # step is not knowable from the key); checkpoint re-admissions
        # carry their own field
        prefix_restore = None
        if (self.solvecache is not None and _restore is None
                and until == "steps"):
            hit = self.solvecache.lookup(cfg)
            if hit is not None and hit["kind"] == "full":
                if self._cache_replay(rec, cfg, b, placement, hit):
                    return rid
            elif hit is not None:
                prefix_restore = self._cache_prefix(rec, cfg, hit)
        shed_reason = None
        with self._cond:
            queued = (sum(len(q) for q in self._queues.values())
                      + (len(self._mega_queue) if self._mega_queue else 0))
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
                rec["placement"] = placement
                if placement == "mega":
                    q = self._mega_queue
                    if q is None:
                        q = self._mega_queue = policy_mod.make_queue(
                            self.scfg.policy, self.scfg.tenant_weights)
                else:
                    q = self._queues.get(key)
                    if q is None:
                        q = self._queues[key] = policy_mod.make_queue(
                            self.scfg.policy, self.scfg.tenant_weights)
                submit_t = rec["_submit_t"]
                req = Request(
                    id=rid, cfg=cfg, submit_t=submit_t, key=key,
                    placement=placement,
                    deadline_t=(submit_t + deadline_ms / 1e3
                                if deadline_ms is not None else None),
                    tenant=tenant, slo_class=slo_class, seq=seq,
                    until=until, tol=tol, predicted_steps=predicted,
                    trace_id=trace_id,
                    restore=(_restore if _restore else prefix_restore))
                q.push(req)
                if self.tracer.enabled:
                    policy_mod.note_enqueue(self.tracer, self.scfg.policy,
                                            req)
                self._queued_by_tenant[tenant] += 1
                self.depth_hist.observe(float(queued + 1))
                self._cond.notify_all()   # wake the online scheduler
        if shed_reason is not None:
            self._reject(rec, shed_reason)
        return rid

    def _cache_replay(self, rec: dict, cfg: HeatConfig,
                      bucket: Optional[int], placement: str,
                      hit: dict) -> bool:
        """Full cache hit at the admission door: replay the stored npz
        through the normal record/listener path without occupying a lane —
        no lane kernel launches, and an out-dir publish is a byte copy of
        the cached file. Billed as cached: zero lane_s/steps, the whole
        ``ntime`` credited as steps_saved. False when the entry vanished
        mid-replay (an eviction race): the caller proceeds as a miss."""
        scfg = self.scfg
        path: Optional[str] = None
        T = None
        try:
            nbytes = int(hit["nbytes"])
            if scfg.out_dir:
                p = self.solvecache.replay(hit["path"], scfg.out_dir,
                                           rec["id"])
                path = str(p)
                nbytes = p.stat().st_size
            if scfg.keep_fields or not scfg.out_dir:
                T, _ = solvecache_mod.SolveCache.load(hit["path"])
        except Exception as e:  # noqa: BLE001 — entry evicted under us
            master_print(f"solve cache: replay of {hit['path']} failed "
                         f"({type(e).__name__}: {e}) — recomputing")
            return False
        now = wall_clock()
        with self._lock:
            rec["bucket"] = bucket
            rec["placement"] = placement
            rec["status"] = "ok"
            rec["cached"] = True
            rec["exit"] = "cached"
            rec["queue_wait_s"] = round(now - rec["_submit_t"], 6)
            rec["solve_s"] = 0.0
            rec["steps_per_s"] = None
            rec["steps_done"] = int(cfg.ntime)
            if path is not None:
                rec["path"] = path
            if T is not None:
                rec["T"] = T
            rec["usage"] = {"lane_s": 0.0, "steps": 0, "chunks": 0,
                            "bytes_written": int(nbytes),
                            "steps_saved": int(cfg.ntime),
                            "cached": True}
            self.steps_saved_total += int(cfg.ntime)
        if self.tracer.enabled:
            self.tracer.instant("cache-hit", self.tracer.thread_track(),
                                trace_id=rec["trace_id"],
                                args={"id": rec["id"],
                                      "step": int(hit["step"])})
        self._emit(rec)
        return True

    def _cache_prefix(self, rec: dict, cfg: HeatConfig,
                      hit: dict) -> Optional[dict]:
        """Prefix hit: seed the admitting lane fill from the cached field
        at ``hit['step']`` so the lane kernels step only the delta. The
        payload has the resume shape ``_fill`` consumes;
        ``_cache_prefix_steps`` on the record makes the terminal stamp
        bill only the stepped delta. None when the entry vanished: the
        request runs from its initial condition."""
        try:
            T, step = solvecache_mod.SolveCache.load(hit["path"])
        except Exception as e:  # noqa: BLE001 — entry evicted under us
            master_print(f"solve cache: prefix read of {hit['path']} "
                         f"failed ({type(e).__name__}: {e}) — "
                         f"recomputing from the IC")
            return None
        remaining = int(cfg.ntime) - int(step)
        if remaining <= 0:
            return None
        with self._lock:
            rec["_cache_prefix_steps"] = int(step)
        if self.tracer.enabled:
            self.tracer.instant("cache-prefix",
                                self.tracer.thread_track(),
                                trace_id=rec["trace_id"],
                                args={"id": rec["id"], "step": int(step),
                                      "delta": remaining})
        return {"T": T, "remaining": remaining, "chunks": 0}

    def _forecast_wall(self, cfg: HeatConfig, b: Optional[int],
                       steps: int) -> Optional[float]:
        """Cost-model wall forecast for an ``until=steady`` admission, on
        its PREDICTED steps (runtime/prof.py): None until the model has
        observed this geometry; the tier is assumed saturated at
        ``--lanes``; a mega request (``b`` None) is its own lane."""
        d = self.scfg.dispatch_depth
        depth = max(1, d) if d > 0 else 0
        if b is None:
            est = self.prof.cost.estimate_request_s(
                f"{cfg.ndim}d/n{cfg.n}/{cfg.dtype}/{cfg.bc}", 1, depth,
                steps, kernel="sharded", placement="mega")
            return None if est is None else round(est, 6)
        bucket = f"{cfg.ndim}d/n{b}/{cfg.dtype}/{cfg.bc}"
        for kernel in ("cuda", "torch"):
            est = self.prof.cost.estimate_request_s(
                bucket, self.scfg.lanes, depth, steps, kernel=kernel)
            if est is not None:
                return round(est, 6)
        return None

    def _next_admission(self, runner, lane: int) -> Optional[Request]:
        """Pop ``runner``'s queue for ``lane`` (either runner kind): queued
        requests already past their deadline (or cancelled) are shed; the
        first admissible one's record turns ``running`` and it is returned.
        None once the queue has nothing to admit."""
        tr = runner.tracer
        while runner.q:
            with self._lock:
                req = runner.q.pop()
                if req is None:
                    return None
                self._queued_by_tenant[req.tenant] -= 1
                self.admission_trace.append(req.id)
            now = wall_clock()
            if tr.enabled:
                # queue-wait span (pop side): the request's wait under this
                # policy, id-paired per tenant track
                policy_mod.note_pop(tr, self.scfg.policy, req, now)
            cut = self._deadline_cut(req, now)
            if cut is not None:
                if tr.enabled:
                    tr.instant("deadline-shed", runner.group_track,
                               trace_id=req.trace_id,
                               args={"id": req.id}, ts=now)
                self._fail_request(
                    req, "deadline",
                    "deadline: cancelled (deadline-preemption) while "
                    "still queued (never admitted)"
                    if cut == "cancelled" else
                    f"deadline: exceeded its "
                    f"{1e3 * (req.deadline_t - req.submit_t):.0f} ms "
                    f"budget while still queued (never admitted)")
                self.deadline_misses += 1
                continue
            if tr.enabled:
                tr.flow("t", runner.lane_tracks[lane], req.trace_id, ts=now)
            rec = self._by_id[req.id]
            with self._lock:
                rec["lane"] = lane
                rec["queue_wait_s"] = round(now - req.submit_t, 6)
                rec["status"] = "running"
                rec["_start_t"] = now
            return req
        return None

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

    def _note_numerics_event(self, runner: _Runner, lane: int,
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
                        steady_tol=ev["steady_tol"],
                        trace_id=req.trace_id)
            if self.tracer.enabled:
                self.tracer.instant("steady-state",
                                    runner.lane_tracks[lane],
                                    trace_id=req.trace_id,
                                    args={"id": req.id, "at_step": done})
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
                    dheat_ewma=ev.get("dheat_ewma"),
                    trace_id=req.trace_id)
        if self.tracer.enabled:
            self.tracer.instant("numerics-violation",
                                runner.lane_tracks[lane],
                                trace_id=req.trace_id,
                                args={"id": req.id, "why": why,
                                      "at_step": done})
        # flight-recorder trigger: the ring holds the lane's chunk and
        # residual history up to the escape
        self._flight_dump(f"numerics violation ({why}) on request "
                          f"{req.id}")
        if self.scfg.numerics_guard == "quarantine":
            runner._quarantine_numerics(lane, req, rem_at, why)

    # --- mega-lane placement ----------------------------------------------
    @property
    def mega_lanes(self) -> int:
        """The resolved mega-lane slot budget: the configured value, or
        auto (1 where ``mega_device_count`` is above 1, else 0), resolved
        once, at the first overflow admission, summary or scrape."""
        if self._mega_lanes_resolved is None:
            self._mega_lanes_resolved = (
                self.scfg.mega_lanes if self.scfg.mega_lanes is not None
                else (1 if mega_device_count(self.device) > 1 else 0))
        return self._mega_lanes_resolved

    def _mega_shape(self, ndim: int) -> tuple:
        """The mesh shape a mega-lane of this rank would span."""
        from ..parallel.mesh import auto_mesh_shape

        return auto_mesh_shape(mega_device_count(self.device), ndim)

    def _mega_overflow_reason(self, cfg: HeatConfig):
        """``(reason, hint)`` when a bucket-overflow request can NOT run as
        a mega-lane — the rejection with the mesh that could have served
        it and, where one knob would serve it, a machine-readable hint;
        ``(None, None)`` when it can."""
        biggest = max(self.scfg.buckets)
        base = (f"bucket-overflow: request side {cfg.n} exceeds the "
                f"biggest bucket {biggest}")
        ndev = mega_device_count(self.device)
        if self.mega_lanes <= 0:
            shape = "x".join(map(str, self._mega_shape(cfg.ndim)))
            why = ("auto enables mega-lanes only on multi-device hosts"
                   if ndev <= 1 and self.scfg.mega_lanes is None
                   else "--mega-lanes 0")
            return (base + f"; mega-lane placement is off ({why}) though "
                    f"this host's {ndev}-device {shape} mesh could serve "
                    f"it", "enable --mega-lanes")
        shape = self._mega_shape(cfg.ndim)
        bad = [int(s) for s in shape if cfg.n % int(s)]
        if bad:
            return (base + f"; side {cfg.n} does not divide evenly over "
                    f"the {'x'.join(map(str, shape))} device mesh "
                    f"(mega-lane shard constraint) — resubmit at a side "
                    f"divisible by {max(int(s) for s in shape)}", None)
        return None, None

    def _note_mega_compile(self, seconds: float) -> None:
        """One mega machinery build (the packed tier builds nothing per
        bucket): counted apart from the lanes, and a span on the trace."""
        self.mega_compiles += 1
        self.compile_s += seconds
        if self.tracer.enabled:
            t1 = wall_clock()
            self.tracer.complete("mega machinery",
                                 self.tracer.thread_track("compiler"),
                                 t1 - seconds, t1, cat="compile",
                                 args={"seconds": round(seconds, 4)})

    def _reject(self, rec: dict, reason: str,
                hint: Optional[str] = None) -> None:
        with self._lock:
            rec["status"] = "rejected"
            rec["error"] = reason
            if hint is not None:
                # the knob that would have served it, machine-readable
                rec["hint"] = hint
            rec["usage"] = prof_mod.empty_usage()   # schema-stable stamp
        self._emit(rec)

    def _fail_request(self, req: Request, status: str, reason: str,
                      lane: Optional[int] = None, steps_done: int = 0,
                      chunks: int = 0) -> None:
        """Fail ONE request with a structured status (nonfinite / deadline /
        error): the record carries the reason, the engine keeps serving
        everyone else. ``steps_done``/``chunks`` are the usage stamp: the
        work the failed request did consume."""
        rec = self._by_id[req.id]
        now = wall_clock()
        with self._lock:
            self._cancel_reqs.discard(req.id)
            start = rec.pop("_start_t", None)
            base = rec.pop("_resumed_lane_s", 0.0)
            if start is not None:
                rec["solve_s"] = round(now - start + base, 6)
            elif base:
                rec["solve_s"] = round(base, 6)
            if rec["queue_wait_s"] is None:
                rec["queue_wait_s"] = round(now - req.submit_t, 6)
            if lane is not None:
                rec["lane"] = lane
            rec["status"] = status
            rec["error"] = reason
            rec["steps_done"] = int(steps_done)
            # a cache-prefix admission never ran its prefix steps: bill
            # only the stepped delta, credit the prefix as saved
            prefix = int(rec.pop("_cache_prefix_steps", 0) or 0)
            rec["usage"] = {"lane_s": rec["solve_s"] or 0.0,
                            "steps": max(0, int(steps_done) - prefix),
                            "chunks": int(chunks),
                            "bytes_written": 0, "steps_saved": prefix,
                            "cached": False}
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
        if self.tracer.enabled:
            self.tracer.instant("lane-kernel-fallback",
                                self.tracer.thread_track("scheduler"),
                                args={"bucket": bucket, "lanes": lanes,
                                      "reason": reason})

    def _mem_warn(self, warn: dict) -> None:
        """The leak sentinel fired (runtime/prof.py MemWatermark): one
        structured ``mem_watermark`` record + a human line, at a chunk
        boundary on the scheduler thread."""
        master_print(
            f"mem watermark: device memory grew monotonically by "
            f"{warn['growth_bytes'] / 2**20:.1f} MiB over the last "
            f"{warn['window_samples']} samples to "
            f"{warn['bytes_in_use'] / 2**20:.1f} MiB "
            f"({warn['source']}) — a rollback-stack or lane-grow leak "
            f"looks exactly like this; see TROUBLESHOOTING.md")
        json_record("mem_watermark", **warn)

    def _fail_group(self, runner: _Runner, exc: BaseException) -> None:
        """The boundary-fetch watchdog fired for one bucket group: its device
        state is unreadable, so every in-flight occupant and every queued
        request of THIS group fails with a structured record — and the
        other groups keep draining. (The online loop reuses it as the
        fail-everything exit when the loop itself dies; only a real
        watchdog timeout bumps the watchdog counter.)"""
        is_watchdog = isinstance(exc, async_io.BoundedFetchTimeout)
        if is_watchdog:
            self.watchdog_fired += 1
            if self.tracer.enabled:
                self.tracer.instant("watchdog-fired", runner.group_track,
                                    args={"bucket": runner.track_name,
                                          "error": str(exc)})
        master_print(f"serve fetch watchdog: bucket {runner.key} boundary "
                     f"fetch hung ({exc}); failing the group's "
                     f"{sum(o is not None for o in runner.occupant)} "
                     f"in-flight and {len(runner.q)} queued request(s)")
        for lane, req in enumerate(runner.occupant):
            if req is not None:
                runner._trace_occupancy(lane, req, "error")
                self._fail_request(
                    req, "error",
                    f"fetch-watchdog: {exc} — lane {lane}'s group state "
                    f"is unreadable; request failed cleanly", lane=lane,
                    steps_done=max(0, req.cfg.ntime
                                   - int(runner.dev_rem[lane])),
                    chunks=int(runner.lane_chunks[lane]))
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
        if is_watchdog:
            # flight-recorder trigger: the ring holds the wedged request's
            # span chain up to the hang
            self._flight_dump(f"fetch watchdog fired for bucket "
                              f"{runner.key}")

    def _flight_dump(self, reason: str) -> None:
        """Flight-recorder dump (watchdog, quarantine after rollbacks,
        numerics violation, scheduler crash): the event ring written
        atomically to ``flight_dir`` (default ``out_dir``; with neither set
        the dump is skipped, never the cwd). Never raises into the failure
        path it documents. A dump emits a structured ``flightrec`` record
        naming the file."""
        d = self.scfg.flight_dir or self.scfg.out_dir
        if d is None:
            return
        try:
            path = self.tracer.flight_dump(d, reason)
        except Exception as e:  # noqa: BLE001 — best-effort by contract
            master_print(f"flight recorder: dump failed "
                         f"({type(e).__name__}: {e})")
            return
        if path is not None:
            json_record("flightrec", reason=reason, path=str(path),
                        events=len(self.tracer), dump=self.tracer.dumps,
                        max_dumps=trace_mod.MAX_FLIGHT_DUMPS)

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
        now = wall_clock()
        with self._cond:
            snap = self._public(rec)
            listeners = list(self._listeners)
            submit_t = rec.get("_submit_t")
            if submit_t is not None and snap.get("status") != "rejected":
                cls = snap.get("class", DEFAULT_SLO_CLASS)
                h = self.lat_hist.get(cls)
                if h is None:
                    h = self.lat_hist[cls] = policy_mod.Histogram()
                h.observe(max(0.0, now - submit_t))
            # observatory feed: the usage ledger and the SLO burn windows
            # take the terminal snapshot (engine -> observatory lock order)
            alert = self.prof.note_terminal(snap, now)
            if self.scfg.emit_records:
                json_record("serve_request", **snap)
            self._cond.notify_all()
        if alert is not None:
            master_print(
                f"slo alert: class {alert['class']!r} burning its error "
                f"budget at {alert['fast_burn']:.1f}x (fast) / "
                f"{alert['slow_burn']:.1f}x (slow) the sustainable rate "
                f"(target {alert['target']:g}) — see TROUBLESHOOTING.md")
            json_record("slo_alert", **alert)
        if self.tracer.enabled:
            # flow end: the terminal record left the engine
            xid = snap.get("trace_id")
            if xid:
                self.tracer.flow("f", self.tracer.thread_track(), xid,
                                 ts=now)
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

    def field_of(self, request_id: str) -> Optional[np.ndarray]:
        """The final field of a terminal ``ok`` request, or ``None`` — from
        the in-memory record (``keep_fields`` / no out_dir) or the
        published ``.npz`` (a bf16 field as its ``V2`` bits). The
        gateway's ``GET /v1/requests/<id>?field=1`` reads it, so the
        canary prober verifies results through the front door; the npz
        load runs outside the engine lock."""
        with self._lock:
            rec = self._by_id.get(request_id)
            T = rec.get("T") if rec is not None else None
            path = rec.get("path") if rec is not None else None
        if T is not None:
            return np.asarray(T)
        if path is not None:
            with np.load(path) as z:
                return np.asarray(z["T"])
        return None

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

    def queue_depths(self) -> Dict[str, int]:
        """Queued (not yet admitted) request count per tenant."""
        with self._lock:
            return {t: n for t, n in self._queued_by_tenant.items() if n}

    def backlog_snapshot(self) -> Dict[str, int]:
        """Queued/running work totals (integer step sums) from the records
        only — never runner state, which is scheduler-thread-confined — so
        any handler thread may call it. ``running_steps_bound`` counts each
        resident request at its full ``ntime`` (an upper bound)."""
        queued_req = queued_steps = running_req = running_steps = 0
        with self._lock:
            for rec in self._by_id.values():
                st = rec.get("status")
                if st == "queued":
                    queued_req += 1
                    queued_steps += int(rec.get("ntime") or 0)
                elif st == "running":
                    running_req += 1
                    running_steps += int(rec.get("ntime") or 0)
        return {"queued_requests": queued_req,
                "queued_steps": queued_steps,
                "running_requests": running_req,
                "running_steps_bound": running_steps}

    # --- engine-state checkpointing ----------------------------------------
    def engine_ckpt_dir(self) -> str:
        """Resolved manifest directory: explicit engine_ckpt_dir, else
        <out_dir>/engine-ckpt, else ./engine-ckpt."""
        from pathlib import Path

        if self.scfg.engine_ckpt_dir:
            return self.scfg.engine_ckpt_dir
        if self.scfg.out_dir:
            return str(Path(self.scfg.out_dir) / "engine-ckpt")
        return "engine-ckpt"

    def _note_boundary(self) -> None:
        """One processed chunk boundary (every runner, scheduler thread):
        advance the checkpoint cadence clock, arm the checkpoint pause when
        the interval is crossed, and give ``engine-kill@N`` its address."""
        with self._lock:
            self.boundaries_total += 1
            n = self.boundaries_total
            interval = self.scfg.engine_ckpt_interval
            if (interval > 0 and not self._ckpt_pause
                    and n - self._last_ckpt_boundary >= interval):
                self._ckpt_pause = True
        if self._plan is not None:
            self._plan.maybe_engine_kill(n)

    def _ckpt_tick(self) -> None:
        """Take the armed checkpoint once the pipeline is EMPTY: every
        runner's in-flight deque drained, so the live stacks are exactly
        the last judged boundary (the maybe_grow precedent — the
        consistent cut). A no-op unless the pause is armed."""
        if not self._ckpt_pause:
            return
        if any(r.inflight for r in self._active_runners or ()):
            return
        try:
            self._engine_checkpoint(reason="interval")
        finally:
            with self._cond:
                self._ckpt_pause = False
                self._last_ckpt_boundary = self.boundaries_total
                self._cond.notify_all()

    def _engine_checkpoint(self, reason: str) -> None:
        """Snapshot the whole engine at THIS empty-pipeline cut: one
        on-card copy per occupied lane (``LaneEngine.snapshot_lane``: a
        clone of the lane's region enqueued before any later chunk, with
        its pinned D2H behind it, so no chunk that ping-pongs the stacks
        can reach it; the clone and the copy stay on the scheduler's one
        stream and the writer thread only waits on the copy's event), plus
        a JSON manifest of lane occupancy, queued requests and usage
        partials. The manifest is submitted to the FIFO writer after every
        field job and every earlier writeback, so a manifest on disk
        proves everything it references is durable — a kill mid-generation
        leaves fields without a manifest, and discovery falls back one
        generation."""
        from pathlib import Path

        d = Path(self.engine_ckpt_dir())
        with self._lock:
            if self._engine_ckpt_next <= 0:
                self._engine_ckpt_next = ckpt_mod.next_engine_generation(d)
            gen = self._engine_ckpt_next
            self._engine_ckpt_next = gen + 1
        now = wall_clock()
        inflight_entries: List[dict] = []
        field_jobs: List = []
        failed: List[str] = []

        def _entry(req: Request, remaining: int, chunks: int,
                   lane_s: float, numerics) -> dict:
            rec = self._by_id[req.id]
            return {"id": req.id,
                    "cfg": dataclasses.asdict(req.cfg),
                    "fingerprint": ckpt_mod.config_fingerprint(req.cfg),
                    "placement": req.placement,
                    "remaining": int(remaining),
                    "steps_done": int(req.cfg.ntime - remaining),
                    "chunks": int(chunks),
                    "lane_s": round(float(lane_s), 6),
                    "until": req.until, "tol": req.tol,
                    "tenant": req.tenant, "class": req.slo_class,
                    "deadline_ms": rec.get("deadline_ms"),
                    "seq": req.seq,
                    "numerics": numerics}

        def _field_job(rid: str, fp: str, remaining: int, get_field,
                       cfg: HeatConfig):
            def job():
                try:
                    T = get_field()
                    ckpt_mod.save_engine_field(d, gen, rid, T, fp,
                                               remaining)
                except BaseException as e:  # noqa: BLE001 — abort the gen
                    failed.append(f"{rid}: {type(e).__name__}: {e}")
                    return
                # boundary snapshots double as the solve cache's prefix
                # store; put() swallows its own failures
                if self.solvecache is not None and remaining > 0:
                    step = int(cfg.ntime) - int(remaining)
                    if step > 0:
                        self.solvecache.put(cfg, step, T=T,
                                            kind="snapshot")
            job._trace = (f"engine-ckpt field {rid}", None)
            return job

        for r in (self._active_runners or ()):
            mega = isinstance(r, MegaLaneRunner)
            for lane, req in enumerate(r.occupant):
                if req is None:
                    continue
                remaining = int(r.dev_rem[lane])
                rec = self._by_id[req.id]
                lane_s = (now - rec.get("_start_t", now)
                          + rec.get("_resumed_lane_s", 0.0))
                num = (self.numerics.export_state(req.id)
                       if self.numerics is not None else None)
                e = _entry(req, remaining, int(r.lane_chunks[lane]),
                           lane_s, num)
                # a mega occupant's field is its cropped owned field
                snap = (r.eng.final_snapshot() if mega
                        else r.eng.snapshot_lane(lane, req.cfg.n))
                inflight_entries.append(e)
                field_jobs.append(_field_job(
                    req.id, e["fingerprint"], remaining,
                    lambda s=snap: LaneEngine.extract(s), req.cfg))
        queued_entries: List[dict] = []
        with self._lock:
            queues = list(self._queues.values())
            if self._mega_queue is not None:
                queues.append(self._mega_queue)
            queued_reqs = [q2 for q in queues for q2 in q.items()]
        for req in sorted(queued_reqs, key=lambda q2: q2.seq):
            rst = req.restore
            if rst:
                # a resumed (or prefix-seeded) request still waiting for a
                # lane carries its mid-solve field in host memory: persist
                # it as an in-flight entry or its progress would be lost
                e = _entry(req, int(rst["remaining"]),
                           int(rst.get("chunks", 0)),
                           float(rst.get("lane_s", 0.0)),
                           rst.get("numerics"))
                inflight_entries.append(e)
                field_jobs.append(_field_job(
                    req.id, e["fingerprint"], int(rst["remaining"]),
                    lambda rst=rst: rst["T"], req.cfg))
            else:
                e = _entry(req, req.cfg.ntime, 0, 0.0, None)
                e.pop("numerics")
                queued_entries.append(e)
        with self._lock:
            live = ({e["id"] for e in inflight_entries}
                    | {e["id"] for e in queued_entries})
            done = sorted(rid for rid in self._by_id if rid not in live)
        manifest = {"kind": ckpt_mod.ENGINE_MANIFEST_KIND,
                    "version": ckpt_mod.ENGINE_MANIFEST_VERSION,
                    "generation": gen, "reason": reason,
                    "boundaries": self.boundaries_total,
                    "policy": self.scfg.policy,
                    "inflight": inflight_entries,
                    "queued": queued_entries,
                    "done": done}

        def manifest_job():
            if failed:
                master_print(
                    f"engine checkpoint: generation {gen} ABORTED — "
                    f"{len(failed)} lane field(s) failed to persist "
                    f"({'; '.join(failed)}); the previous generation "
                    f"remains the resume point")
                return
            path = ckpt_mod.save_engine_manifest(d, gen, manifest,
                                                 plan=self._plan)
            with self._lock:
                self._engine_ckpt_gen = gen
            json_record("engine_ckpt", generation=gen, reason=reason,
                        path=str(path), boundaries=manifest["boundaries"],
                        inflight=len(inflight_entries),
                        queued=len(queued_entries), done=len(done))
        manifest_job._trace = (f"engine-ckpt manifest gen {gen}", None)

        def fields_job():
            # one generation's fields are written concurrently (zlib and
            # sha256 release the GIL): a generation of many lanes, each
            # compressed for its file and again for its cache entry, would
            # otherwise hold the FIFO writer — and, through its
            # backpressure, the scheduler — for the sum of their times
            _run_concurrently(field_jobs, self.tracer)
        fields_job._trace = (f"engine-ckpt fields gen {gen}", None)

        writer = self._active_writer
        if writer is not None:
            if field_jobs:
                writer.submit(fields_job)
            writer.submit(manifest_job)
        else:
            fields_job()
            manifest_job()

    # --- execution --------------------------------------------------------
    def run(self) -> List[dict]:
        """Drain every queued request through dispatch-ahead continuous
        batching; returns all records (submit order)."""
        if self.online:
            raise RuntimeError(
                "Engine.run()/results() cannot be called while the online "
                "scheduler thread is serving — use poll()/wait() for "
                "records, shutdown() to drain")
        writer = async_io.SnapshotWriter(tracer=self.tracer)
        t0 = wall_clock()
        try:
            runners = [_GroupRunner(self, key, q, writer)
                       for key, q in list(self._queues.items()) if q]
            if self._mega_queue and self.mega_lanes > 0:
                # one runner per occupied mega slot, round-robined with the
                # bucket groups: a mega boundary's bookkeeping hides under
                # packed chunks and vice versa
                runners += [MegaLaneRunner(self, i, self._mega_queue, writer)
                            for i in range(min(self.mega_lanes,
                                               len(self._mega_queue)))]
            # engine checkpoints read the live runners and the writer from
            # the driving loop (scheduler-thread-confined)
            self._active_runners = tuple(runners)
            self._active_writer = writer
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
                    # an armed engine checkpoint fires at the empty cut,
                    # before the pipeline refills
                    self._ckpt_tick()
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
        except BaseException as e:
            # flight-recorder trigger: dump the ring first, then drain —
            # every writeback already queued still lands (or fails per
            # request), but a writer error must not mask this one
            self._flight_dump(f"scheduler crashed: {type(e).__name__}: {e}")
            writer.drain(raise_errors=False)
            self._active_runners, self._active_writer = (), None
            raise
        # the always-at-drain checkpoint (engine_ckpt_interval > 0 opts
        # in): every request done, so a later --resume re-admits nothing
        if self.scfg.engine_ckpt_interval > 0:
            self._engine_checkpoint(reason="drain")
        writer.drain()
        self._active_runners, self._active_writer = (), None
        if self.tracer.enabled:
            self.tracer.complete("engine.run", self.tracer.thread_track(),
                                 t0, cat="engine")
            if self.scfg.trace:
                self.tracer.export(self.scfg.trace)
        return list(self._records)

    def results(self) -> List[dict]:
        """``run`` + records (the common library call)."""
        if any(self._queues.values()) or self._mega_queue:
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
                name="heat-tpu-serve-scheduler")
            self._thread.start()
        return self

    def begin_drain(self, handoff: bool = False) -> None:
        """The online loop finishes every lane already admitted AND every
        request already queued, then exits. ``handoff=True`` is
        drain-to-checkpoint (POST /drainz?handoff=1): the loop stops lane
        fills and chunk dispatch, takes the boundaries already in flight,
        checkpoints the whole engine at the first empty-pipeline cut —
        without finishing lanes — and exits; ``serve --resume`` picks the
        work up there. Idempotent, and a later plain drain never cancels a
        requested handoff."""
        with self._cond:
            self._draining = True
            if handoff:
                self._handoff = True
                self._ckpt_pause = True
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
        writer = async_io.SnapshotWriter(tracer=self.tracer)
        # bucket groups keyed by BucketKey, mega slots by ("mega-slot", i)
        runners: Dict[object, object] = {}
        self._active_writer = writer
        t0 = wall_clock()
        try:
            while True:
                if self._handoff:
                    # drain-to-checkpoint: no fills, no new dispatch — take
                    # only the boundaries already in flight, then
                    # checkpoint at the first empty cut and exit. Lane
                    # occupants stay status="running"; they and the queue
                    # ride the manifest
                    self._active_runners = tuple(runners.values())
                    for r in [r for r in runners.values() if r.inflight]:
                        try:
                            r.process_boundary()
                        except async_io.BoundedFetchTimeout as e:
                            self._fail_group(r, e)
                    if not any(r.inflight for r in runners.values()):
                        self._engine_checkpoint(reason="handoff")
                        break
                    continue
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
                if self._mega_queue and self.mega_lanes > 0:
                    # mega slots appear with the first overflow request and
                    # persist, like the bucket runners
                    for i in range(self.mega_lanes):
                        mr = runners.get(("mega-slot", i))
                        if mr is None:
                            runners[("mega-slot", i)] = MegaLaneRunner(
                                self, i, self._mega_queue, writer)
                        else:
                            mr._fill()
                self._active_runners = tuple(runners.values())
                self._ckpt_tick()
                live = [r for r in runners.values() if r.has_work()]
                if not live:
                    with self._cond:
                        if (self._draining
                                and not any(self._queues.values())
                                and not self._mega_queue):
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
            # normal drain exit (the handoff exit checkpointed already): an
            # interval-opted engine always leaves a final generation
            if self.scfg.engine_ckpt_interval > 0 and not self._handoff:
                self._engine_checkpoint(reason="drain")
        except BaseException as e:  # noqa: BLE001 — surfaced via loop_error
            # a crash in the daemon thread has nowhere to propagate: record
            # it and fail every in-flight and queued request cleanly
            with self._lock:
                self.loop_error = e
            master_print(f"serve scheduler loop failed: "
                         f"{type(e).__name__}: {e}")
            self._flight_dump(f"scheduler loop crashed: "
                              f"{type(e).__name__}: {e}")
            for r in runners.values():
                self._fail_group(r, e)
        finally:
            try:
                writer.drain(raise_errors=False)
            finally:
                self._active_runners, self._active_writer = (), None
                if self.tracer.enabled:
                    self.tracer.complete("serve-loop",
                                         self.tracer.thread_track(), t0,
                                         cat="engine")
                    if self.scfg.trace:
                        try:
                            self.tracer.export(self.scfg.trace)
                        except OSError as te:
                            master_print(f"trace export to "
                                         f"{self.scfg.trace} failed: {te}")
                with self._cond:
                    self._cond.notify_all()  # unblock wait() callers

    # --- lane retirement --------------------------------------------------
    def _finish_timing(self, req: Request, chunks: int = 0,
                       steps_done: Optional[int] = None,
                       exit_mode: str = "steps") -> dict:
        steps = int(req.cfg.ntime if steps_done is None else steps_done)
        rec = self._by_id[req.id]
        now = wall_clock()
        with self._lock:
            start = rec.pop("_start_t", now)
            # a resumed request's first incarnation billed lane seconds too
            lane_s = (now - start) + rec.pop("_resumed_lane_s", 0.0)
            # a cache-prefix admission only STEPPED the delta: bill that,
            # credit the prefix as steps_saved
            prefix = int(rec.pop("_cache_prefix_steps", 0) or 0)
            stepped = max(0, steps - prefix)
            rec["solve_s"] = round(lane_s, 6)
            rec["steps_per_s"] = (round(stepped / lane_s, 3)
                                  if lane_s > 0 else None)
            rec["steps_done"] = steps
            rec["exit"] = exit_mode
            # the usage stamp: what THIS request consumed (bytes_written is
            # finalized by the writer thread before the record is emitted)
            rec["usage"] = {"lane_s": rec["solve_s"],
                            "steps": stepped,
                            "chunks": int(chunks), "bytes_written": 0,
                            "steps_saved": int(req.cfg.ntime) - stepped,
                            "cached": False}
            if prefix:
                self.steps_saved_total += prefix
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
                # bytes the tenant's result cost: the published file, or
                # the in-memory field when nothing hits disk
                from pathlib import Path

                nbytes = (Path(path).stat().st_size if path is not None
                          else int(T.nbytes))
                with self._lock:
                    if scfg.keep_fields or not scfg.out_dir:
                        rec["T"] = T
                    if path is not None:
                        rec["path"] = path
                    rec["status"] = "ok"
                    rec["usage"]["bytes_written"] = int(nbytes)
                # solve-cache population after the publish landed: a byte
                # copy of the published file (or the same serialization),
                # keyed under the step count the field carries
                if self.solvecache is not None:
                    self.solvecache.put(
                        cfg, int(cfg.ntime if steps_done is None
                                 else steps_done),
                        T=T, src_path=path, kind="result")
            except BaseException as e:  # noqa: BLE001 — per-request record
                if async_io.is_transient(e) and attempts["n"] <= writer.retries:
                    raise
                with self._lock:
                    rec["status"] = "error"
                    rec["error"] = f"{type(e).__name__}: {e}"
            self._emit(rec)

        # the writer thread labels its span with the request it serves
        job._trace = (f"writeback {req.id}", rec.get("trace_id"))
        writer.submit(job)

    def _finish_async(self, eng: LaneEngine, lane: int, req: Request,
                      writer, chunks: int = 0,
                      steps_done: Optional[int] = None,
                      exit_mode: str = "steps") -> None:
        """Dispatch-ahead retirement: a one-lane snapshot enqueued behind
        the chunks in flight (the scheduler thread never waits); the D2H
        wait and the writeback run in the writer thread."""
        rec = self._finish_timing(req, chunks=chunks, steps_done=steps_done,
                                  exit_mode=exit_mode)
        snap = eng.snapshot_lane(lane, req.cfg.n)
        self._writeback_job(rec, req, writer, lambda: eng.extract(snap))

    def _finish_sync(self, eng: LaneEngine, lane: int, req: Request,
                     writer, chunks: int = 0,
                     steps_done: Optional[int] = None,
                     exit_mode: str = "steps") -> None:
        """Sync-fallback retirement: fetch the lane on the scheduler thread,
        write back in the writer."""
        rec = self._finish_timing(req, chunks=chunks, steps_done=steps_done,
                                  exit_mode=exit_mode)
        T = eng.extract_lane(lane, req.cfg.n)
        self._writeback_job(rec, req, writer, lambda: T)

    # --- reporting --------------------------------------------------------
    def summary(self) -> dict:
        """The reference's summary keys. Of these, ``mega_compiles`` counts
        mega machinery builds (nothing is compiled per chunk size), and
        ``step_compiles`` and ``tail_compiles`` are 0 (nothing is compiled
        per bucket: the lane kernels are built once per checkout,
        ``compile_s`` is the time to load them and to build the mega
        machinery). The port adds ``device``, ``lane_passes``, the lane
        kernel launches that the dispatched chunks cost by kernel,
        ``lane_passes_by_bucket``, the same by ``"<kernel> <bucket side>
        <dtype>"``, ``lane_chunks``, those chunks by kernel, and
        ``mega_chunks``, the mega chunks dispatched."""
        with self._lock:
            by_status = collections.Counter(r["status"] for r in self._records)
            by_placement = collections.Counter(
                r["placement"] for r in self._records if r.get("placement"))
            n = len(self._records)
            queued = (sum(len(q) for q in self._queues.values())
                      + (len(self._mega_queue) if self._mega_queue else 0))
        # the observatories' snapshots AFTER the engine lock is released
        obs = self.prof.summary(wall_clock())
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
                "prof": self.scfg.prof,
                "cost_model": obs["cost_model"],
                "mem": obs["mem"],
                "slo_burn": obs["slo_burn"],
                "flightrec_dumps": self.tracer.dumps,
                "policy": self.scfg.policy,
                "lane_kernel": self.scfg.lane_kernel,
                "lane_kernel_fallbacks": self.lane_kernel_fallbacks,
                "lane_passes": dict(by_kernel),
                "lane_passes_by_bucket": {
                    f"{name} {n} {dtype}": count for (name, n, dtype), count
                    in sorted(self.lane_passes.items())},
                "lane_chunks": dict(self.lane_chunks),
                "placement": dict(by_placement),
                "mega_lanes": self.mega_lanes,
                "mega_compiles": self.mega_compiles,
                "mega_chunks": self.mega_chunks,
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
                "serve_resumed": self.serve_resumed_total,
                "cache": (self.solvecache.stats()
                          if self.solvecache is not None else None),
                "engine_ckpt_interval": self.scfg.engine_ckpt_interval,
                "engine_ckpt_generation": self._engine_ckpt_gen,
                "shed": self.shed,
                "watchdog_fired": self.watchdog_fired}
