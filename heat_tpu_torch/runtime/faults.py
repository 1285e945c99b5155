"""Deterministic fault injection for the solve path.

Makes the failure modes of a long solve injectable and deterministic, so
the crash -> resume -> converge loop (checkpoint quarantine, async-writer
retry, NaN rollback) is a tested subsystem:

- ``crash@N[:proc=P]``       — hard worker death (``os._exit``) at step >= N
- ``nan@N[:proc=P]``         — flip one cell of the field to NaN at step >= N
                               (a soft-error analog; pairs with
                               ``--on-nan rollback``)
- ``ckpt-corrupt@N``         — scribble over the checkpoint published at
                               step >= N (bitrot / torn-write analog)
- ``ckpt-truncate@N``        — cut that checkpoint file in half instead
- ``sink-error@N[:times=K]`` — the first K checkpoint writes at step >= N
                               raise a transient ``OSError(EIO)`` (the class
                               ``async_io.SnapshotWriter`` retries)
- ``sink-slow:ms=M``         — every checkpoint write sleeps M ms first

Serve-scoped kinds (the serving engine's per-lane fault domains,
``serve/scheduler.py``; the solo drive loop ignores them):

- ``lane-nan@N[:req=ID]``    — poison one cell of a serving lane's field
                               with NaN once that lane's request has
                               completed >= N steps (fire-once per
                               request). In a request's own ``inject`` the
                               fault targets that request; in the engine's
                               spec (``serve --inject``) ``req=ID`` selects
                               one request id, no ``req=`` poisons every
                               request. Pairs with ``--serve-on-nan``.
- ``perturb@N[:req=ID][:eps=E]`` — add a finite bump ``eps`` (default
                               1e3) to one cell of a serving lane's field
                               once its request has completed >= N steps
                               (fire-once per request, ``req=`` as for
                               lane-nan): the field stays finite, so the
                               finite bit holds, but the maximum-principle
                               witnesses leave their envelope. Pairs with
                               ``--numerics-guard``.
- ``fetch-hang[@N]:ms=M``    — the first boundary fetch (the Nth with
                               ``@N``) sleeps M ms inside the watched
                               fetch: a wedged-device analog for the
                               boundary-fetch watchdog (fire-once).
- ``engine-kill@N``          — SIGKILL the serve process once the engine
                               has processed >= N chunk boundaries (every
                               runner counts): the hard-death analog
                               that ``serve --resume`` recovers from.
- ``ckpt-manifest-corrupt@N`` — scribble over the engine-state manifest
                               published at generation >= N (no ``@N`` =
                               the first one). The resume loader must
                               quarantine it and fall back one
                               generation loudly.

Solve-cache kinds (``serve/solvecache.py``; ignored wherever the cache is
off):

- ``cache-corrupt[@N]``      — xor-scribble 64 bytes at the midpoint of
                               the consulted cache entry's npz on the
                               Nth cache consult (no ``@N`` = the first).
                               The consult's sha256 check must
                               quarantine it to ``*.corrupt`` and fall
                               back to recompute — never serve it.
- ``cache-stale``            — rewrite the consulted entry's sidecar
                               fingerprint to a different physics hash
                               (a mis-filed entry analog). The consult's
                               fingerprint check must quarantine and
                               recompute (fire-once).

Fleet-scoped kinds (the router's chaos drills, ``fleet/router.py``;
the solo drive loop and the serving engine ignore them):

- ``backend-down@N[:backend=K]`` — once the router has forwarded N
                               requests, drop a backend's TCP target
                               (connection refused from then on): K, or
                               the backend the Nth forward chose.
                               Fire-once.
- ``backend-slow:ms=M``      — every router->backend forward sleeps M
                               ms first.
- ``backend-flap:period=M[:backend=K][:times=T]`` — square-wave backend
                               K (default b0) down and up every M ms for
                               T down half-periods (default 1), then up
                               for good.
- ``stream-cut@N[:backend=K]`` — sever the router's relay socket to K
                               (default: the first relay to ask) after N
                               records have streamed back, the backend
                               alive (fire-once).
- ``backend-partition[:backend=K][:ms=M]`` — every connect to K stalls M
                               ms (default 1000), then times out: a
                               partition, not a refusal.

The grammar and the semantics of every kind are
``heat_tpu.runtime.faults``'s.

Specs come from ``--inject`` (``HeatConfig.inject``) or the
``HEAT_TPU_FAULTS`` env var; multiple faults are comma-separated, e.g.
``"nan@6,ckpt-corrupt@8"``. Grammar per fault: ``kind[@step][:key=val]...``.

Every fault is **restart-gated**: by default it fires only in incarnation 0
(``restart=R`` selects another, ``restart=-1`` fires in every one), read
from ``HEAT_TPU_RESTART``, so an injected crash kills the first run and not
the resumed one.

Strictly opt-in: with no spec, ``plan_for`` returns ``None`` and every call
site skips on one ``is not None`` test.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from .logging import master_print

ENV_VAR = "HEAT_TPU_FAULTS"
RESTART_ENV_VAR = "HEAT_TPU_RESTART"

# Distinctive exit code for an injected crash, so "chaos did this" is told
# apart from a real rc=1 traceback death.
CRASH_RC = 43

_KINDS = ("crash", "nan", "ckpt-corrupt", "ckpt-truncate",
          "sink-error", "sink-slow", "lane-nan", "fetch-hang", "perturb",
          "engine-kill", "ckpt-manifest-corrupt",
          "backend-down", "backend-slow", "cache-corrupt", "cache-stale",
          "backend-flap", "stream-cut", "backend-partition")


@dataclasses.dataclass
class Fault:
    kind: str
    step: Optional[int] = None  # fires at the first boundary/step >= this
    proc: Optional[int] = None  # None = every process
    times: int = 1              # sink-error: how many writes fail
    ms: float = 0.0             # sink-slow / fetch-hang: delay
    restart: int = 0            # incarnation filter (-1 = every incarnation)
    req: Optional[str] = None   # lane-nan/perturb: target request id
                                # (None = all)
    eps: float = 1e3            # perturb: added to one cell (finite, big
                                # enough to escape any envelope tolerance)
    backend: Optional[str] = None  # backend-down/flap/stream-cut/partition:
                                # the named backend (None = see each kind)
    period: float = 0.0         # backend-flap: half-period in ms
    t0: Optional[float] = None  # backend-flap: epoch (first evaluation)
    fired: bool = False


def _restart_count() -> int:
    try:
        return int(os.environ.get(RESTART_ENV_VAR, "0"))
    except ValueError:
        return 0


def _process_index() -> int:
    """This process's rank: the ``torch.distributed`` rank when a group is
    initialised, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def parse_spec(spec: str) -> List[Fault]:
    """Parse a fault spec; raises ValueError with the grammar on any typo
    (config validation calls this so a bad spec dies at parse time, not at
    step N of a long solve)."""
    faults = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        head, _, tail = entry.partition(":")
        kind, _, step_s = head.partition("@")
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {entry!r}; grammar is "
                f"'kind[@step][:key=val]...' with kind one of {_KINDS}")
        f = Fault(kind=kind)
        if step_s:
            try:
                f.step = int(step_s)
            except ValueError:
                raise ValueError(f"bad step {step_s!r} in fault {entry!r}")
        for kv in filter(None, tail.split(":")):
            key, eq, val = kv.partition("=")
            if not eq or key not in ("proc", "times", "ms", "restart",
                                     "req", "eps", "backend", "period"):
                raise ValueError(
                    f"bad fault param {kv!r} in {entry!r}; keys are "
                    f"proc=, times=, ms=, restart=, req=, eps=, backend=, "
                    f"period=")
            try:
                setattr(f, key, val if key in ("req", "backend")
                        else float(val) if key in ("ms", "eps", "period")
                        else int(val))
            except ValueError:
                raise ValueError(f"bad value {val!r} for {key} in {entry!r}")
        if (f.kind in ("crash", "nan", "lane-nan", "perturb", "engine-kill",
                       "backend-down", "stream-cut")
                and f.step is None):
            raise ValueError(f"fault {entry!r} needs a step: '{f.kind}@N'")
        if f.kind == "backend-flap" and f.period <= 0:
            raise ValueError(
                f"fault {entry!r} needs a half-period: "
                f"'backend-flap:period=MS'")
        faults.append(f)
    return faults


class FaultPlan:
    """One parsed spec with its firing state (fire-once flags, sink-error
    budgets). Plans are cached per spec string so the drive loop, the
    checkpoint writer, and the async sink all decrement the SAME budgets
    within a process."""

    def __init__(self, spec: str):
        self.spec = spec
        self.faults = parse_spec(spec)

    def _live(self, kind: str):
        for f in self.faults:
            if f.kind != kind:
                continue
            if f.restart != -1 and f.restart != _restart_count():
                continue
            if f.proc is not None and f.proc != _process_index():
                continue
            yield f

    # --- step-loop faults (backends.common.drive / serial loop) ----------
    def maybe_crash(self, step: int) -> None:
        for f in self._live("crash"):
            if not f.fired and step >= f.step:
                f.fired = True
                print(f"fault: injected crash at step {step} "
                      f"(proc {_process_index()}, spec {self.spec!r})",
                      file=sys.stderr, flush=True)
                os._exit(CRASH_RC)

    def maybe_nan(self, step: int, T):
        """Flip the center cell to NaN once the step arrives; returns the
        (possibly replaced) field."""
        for f in self._live("nan"):
            if not f.fired and step >= f.step:
                f.fired = True
                master_print(f"fault: injected NaN at step {step} "
                             f"(spec {self.spec!r})")
                T = _inject_nan(T)
        return T

    # --- serve-scoped faults (serve/scheduler.py lane fault domains) ------
    def lane_nan_steps(self, req_id: str) -> List[int]:
        """The step thresholds at which ``req_id``'s serving lane is
        poisoned with NaN. The fire-once state of lane-nan is per request
        and lives in the scheduler (plans are cached per spec string, so
        two requests sharing one spec must not share a fired flag)."""
        return sorted(f.step for f in self._live("lane-nan")
                      if f.req is None or f.req == req_id)

    def perturb_events(self, req_id: str) -> List[tuple]:
        """``(step, eps)`` thresholds at which ``req_id``'s serving lane is
        perturbed; the scheduler owns the fire-once state, as for
        ``lane_nan_steps``."""
        return sorted((f.step, f.eps) for f in self._live("perturb")
                      if f.req is None or f.req == req_id)

    def maybe_fetch_hang(self, fetch_index: int) -> None:
        """Called inside the watched boundary fetch: the first live
        fetch-hang whose ``@N`` the fetch counter has reached sleeps ``ms``
        and is spent (fire-once)."""
        for f in self._live("fetch-hang"):
            if not f.fired and fetch_index >= (f.step or 0):
                f.fired = True
                master_print(f"fault: injected {f.ms:.0f} ms hang on "
                             f"boundary fetch {fetch_index} "
                             f"(spec {self.spec!r})")
                time.sleep(f.ms / 1000.0)

    def maybe_engine_kill(self, boundary: int) -> None:
        """Called once per processed chunk boundary (the engine-wide
        count): SIGKILL this process once the count reaches ``@N``, so not
        even interpreter-level clean-up runs."""
        import signal

        for f in self._live("engine-kill"):
            if not f.fired and boundary >= f.step:
                f.fired = True
                print(f"fault: injected engine SIGKILL at boundary "
                      f"{boundary} (spec {self.spec!r})",
                      file=sys.stderr, flush=True)
                os.kill(os.getpid(), signal.SIGKILL)

    # --- fleet faults (fleet/router.py chaos drills) ----------------------
    def backend_slow(self) -> None:
        """Called before every router->backend forward: each live
        backend-slow fault sleeps its ``ms``."""
        for f in self._live("backend-slow"):
            if f.ms > 0:
                time.sleep(f.ms / 1000.0)

    def backend_down_target(self, nth: int) -> Optional[str]:
        """Called once per forwarded request with the router-wide forward
        counter: the first live backend-down fault whose ``@N`` ``nth``
        reaches is spent (fire-once) and answers which TCP target to drop
        — its ``backend=``, or ``""`` for 'whichever backend this Nth
        forward chose'. ``None``: no fault fires here."""
        for f in self._live("backend-down"):
            if not f.fired and nth >= f.step:
                f.fired = True
                print(f"fault: injected backend-down at forward {nth} "
                      f"(target {f.backend or '<routed>'}, "
                      f"spec {self.spec!r})", file=sys.stderr, flush=True)
                return f.backend or ""
        return None

    def backend_flap_states(self, now: float) -> Dict[str, bool]:
        """Called from the router's health tick: for each live backend-flap
        fault, is its target (default ``b0``) down at time ``now``? The
        epoch is stamped on the first evaluation; the flap runs ``times``
        down half-periods of ``period`` ms with up half-periods between,
        then stays up. Returns {backend_name: down?}."""
        states: Dict[str, bool] = {}
        for f in self._live("backend-flap"):
            if f.t0 is None:
                f.t0 = now
            half = f.period / 1000.0
            phase = int((now - f.t0) // half) if half > 0 else 0
            # phases 0, 2, 4, ... are down pulses, up in between; after
            # `times` down pulses (phase >= 2*times - 1) up for good
            down = phase < 2 * f.times - 1 and phase % 2 == 0
            states[f.backend or "b0"] = down
        return states

    def stream_cut_fire(self, backend: str, nrecords: int) -> bool:
        """Called from the relay's read loop with the count of records
        already streamed back from ``backend``: the first live stream-cut
        fault that targets it (or no backend) and whose ``@N`` is reached
        is spent (fire-once) and answers True — sever the socket."""
        for f in self._live("stream-cut"):
            if f.fired or (f.backend is not None and f.backend != backend):
                continue
            if nrecords >= f.step:
                f.fired = True
                print(f"fault: injected stream-cut on backend {backend} "
                      f"after {nrecords} records (spec {self.spec!r})",
                      file=sys.stderr, flush=True)
                return True
        return False

    def backend_partition_ms(self, backend: str) -> Optional[float]:
        """Called before a router->backend HTTP request: the stall in ms
        (default 1000) if a live backend-partition fault targets
        ``backend`` (or no backend), else None. Not fire-once: a partition
        lasts as long as the spec."""
        for f in self._live("backend-partition"):
            if f.backend is None or f.backend == backend:
                return f.ms if f.ms > 0 else 1000.0
        return None

    # --- checkpoint-sink faults (runtime.checkpoint.save) -----------------
    def sink_fault(self, step: int) -> None:
        """Called at the top of a checkpoint write: transient-error and
        slow-sink faults land here, BEFORE any bytes move."""
        for f in self._live("sink-slow"):
            if f.ms > 0:
                time.sleep(f.ms / 1000.0)
        for f in self._live("sink-error"):
            if f.times > 0 and (f.step is None or step >= f.step):
                f.times -= 1
                raise OSError(
                    errno.EIO,
                    f"injected transient sink error at step {step} "
                    f"({f.times} more to come; spec {self.spec!r})")

    def damage_checkpoint(self, path: Path, step: int) -> None:
        """Called after a checkpoint file is published: corrupt/truncate
        faults damage it in place (the bitrot the quarantine path must
        catch on the next resume)."""
        for f in self._live("ckpt-corrupt"):
            if not f.fired and (f.step is None or step >= f.step):
                f.fired = True
                data = bytearray(path.read_bytes())
                mid = len(data) // 2
                for i in range(mid, min(mid + 64, len(data))):
                    data[i] ^= 0xFF
                path.write_bytes(bytes(data))
                master_print(f"fault: corrupted checkpoint {path.name} "
                             f"(spec {self.spec!r})")
        for f in self._live("ckpt-truncate"):
            if not f.fired and (f.step is None or step >= f.step):
                f.fired = True
                data = path.read_bytes()
                path.write_bytes(data[:len(data) // 2])
                master_print(f"fault: truncated checkpoint {path.name} "
                             f"(spec {self.spec!r})")


    def damage_cache(self, cache_dir, fingerprint: str,
                     consult: int) -> None:
        """Called at the top of every solve-cache consult
        (serve/solvecache.py) with the consult counter: cache-corrupt
        xor-scribbles the consulted fingerprint's npz entry (sha256
        mismatch — bitrot analog), cache-stale rewrites its sidecar
        fingerprint (a mis-filed entry analog). Both fire-once; the
        consult's validation must quarantine the damage, never serve
        it."""
        d = Path(cache_dir)
        for f in self._live("cache-corrupt"):
            if f.fired or consult < (f.step or 1):
                continue
            for p in sorted(d.glob(f"{fingerprint}-*.npz")):
                f.fired = True
                data = bytearray(p.read_bytes())
                mid = len(data) // 2
                for i in range(mid, min(mid + 64, len(data))):
                    data[i] ^= 0xFF
                p.write_bytes(bytes(data))
                master_print(f"fault: corrupted cache entry {p.name} "
                             f"(spec {self.spec!r})")
                break
        for f in self._live("cache-stale"):
            if f.fired or consult < (f.step or 1):
                continue
            for p in sorted(d.glob(f"{fingerprint}-*.json")):
                f.fired = True
                try:
                    import json as _json

                    meta = _json.loads(p.read_text())
                except ValueError:
                    meta = {}
                meta["fingerprint"] = "0" * 16
                p.write_text(_json.dumps(meta, sort_keys=True) + "\n")
                master_print(f"fault: staled cache sidecar {p.name} "
                             f"(spec {self.spec!r})")
                break

    def damage_manifest(self, path: Path, generation: int) -> None:
        """Called after an engine-state manifest is published
        (runtime.checkpoint.save_engine_manifest): xor-scribble 64 bytes
        at the midpoint — JSON turns to garbage, the resume loader's
        validate step must quarantine it and fall back one generation."""
        for f in self._live("ckpt-manifest-corrupt"):
            if not f.fired and (f.step is None or generation >= f.step):
                f.fired = True
                data = bytearray(path.read_bytes())
                mid = len(data) // 2
                for i in range(mid, min(mid + 64, len(data))):
                    data[i] ^= 0xFF
                path.write_bytes(bytes(data))
                master_print(f"fault: corrupted engine manifest "
                             f"{path.name} (spec {self.spec!r})")


def _inject_nan(T):
    import numpy as np

    idx = tuple(s // 2 for s in T.shape)
    if not isinstance(T, np.ndarray):
        # a tensor, or the sharded backend's shards (global cell index):
        # the drive loop owns its field buffer
        T[idx] = float("nan")
        return T
    T = np.array(T)
    T[idx] = np.nan
    return T


_PLANS: Dict[str, FaultPlan] = {}


def plan_for(cfg=None) -> Optional[FaultPlan]:
    """The active fault plan for this run, or None (the overwhelmingly
    common case). ``cfg.inject`` wins over ``HEAT_TPU_FAULTS``. Plans cache
    per spec so firing state is shared across the drive loop and the
    checkpoint module within a process."""
    return plan_for_spec(getattr(cfg, "inject", "")
                         or os.environ.get(ENV_VAR, ""))


def plan_for_spec(spec: str) -> Optional[FaultPlan]:
    """A plan for a raw spec string — the fleet router's ``--inject`` has
    no HeatConfig to carry it. Same cache and firing state as
    ``plan_for``; an empty spec gives None."""
    spec = (spec or "").strip()
    if not spec:
        return None
    plan = _PLANS.get(spec)
    if plan is None:
        plan = _PLANS[spec] = FaultPlan(spec)
    return plan


def reset() -> None:
    """Drop all cached firing state (tests re-running a spec)."""
    _PLANS.clear()
