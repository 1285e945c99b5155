"""Numerics checking, the profiler hook, the lock-order watchdog and the
race sanitizer.

The debug mode that matters for an explicit stencil is *numerics*: catching
NaN/Inf blow-ups (e.g. sigma above the FTCS stability bound) at the step
where they appear instead of in the final output. Profiling upgrades the
reference's two wall-clock timers to a ``torch.profiler`` trace.

The **lock-order watchdog** (``HEAT_TPU_LOCKCHECK=1``) is the dynamic
half of the ``lock-discipline`` static rule (``heat_tpu_torch/analysis``):
the serving stack's locks form a documented partial order —

    fleet < gateway < engine < writer < cache < observatory

(the engine calls *into* the observatory, sometimes while holding its own
lock, e.g. ``Engine._emit``; observatory instruments never take the
engine lock, so a /metrics scrape can never deadlock the boundary hot
path). With the env flag set, every lock the stack creates through
:func:`make_lock` becomes an :class:`_OrderedLock` that tracks the
calling thread's held-lock stack and **raises** :class:`LockOrderError`
at the exact acquisition that would invert the order — turning a
some-day deadlock into a deterministic failure. Off (the default),
``make_lock`` returns a plain ``threading.Lock``: zero overhead, zero
behavior change.

The **race sanitizer** (``HEAT_TPU_RACECHECK=1`` to raise, ``=record`` to
log and continue) is the dynamic half of the ``races`` static rule:
:func:`instrument_races` arms Eraser-style per-(object, field)
candidate-lockset tracking on the thread-shared serving objects (Engine,
SnapshotWriter, Gateway, Tracer, SolveCache, the fleet's Router,
registry and breakers), fed by the watchdog's per-thread held stacks —
``make_lock`` hands out ordered locks whenever EITHER checker is armed. A
write-write race with an empty lockset intersection raises
:class:`RaceError` (tests) or emits a structured ``race_detected`` record
plus a flight-recorder dump (production); :func:`race_stats` is queryable
like :func:`lock_order_stats`. :func:`install_thread_excepthook` rounds
out the thread-debug story: an uncaught exception in a background thread
becomes a structured ``thread_crash`` record + flight dump instead of a
silent stderr death.

Both read their environment variable when a lock or an object is created,
and this module imports neither numpy nor torch at import time: the
static analysis (``analysis/locks.py``) reads :data:`LOCK_RANKS` from
here without loading either.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import List, Optional

# --------------------------------------------------------------------------
# lock-order watchdog (opt-in: HEAT_TPU_LOCKCHECK=1)
# --------------------------------------------------------------------------

# The documented acquisition order, lowest first. A thread may only
# acquire a lock of STRICTLY greater rank than anything it already holds:
# two same-rank locks must never nest (the observatory instruments each
# carry their own lock precisely so they never have to), and the reverse
# order (observatory -> engine) is the deadlock the order exists to rule
# out. Rank names are the prefix before ":" in a make_lock name, so
# "observatory:ledger" and "observatory:burn" share a rank. "fleet" is
# the router in front of many gateways (fleet/router.py): outermost in
# every request path, so it ranks below gateway — router threads may
# call into a (same-process, in tests) gateway/engine surface while
# holding a fleet lock, never the reverse. "cache" (the solve cache,
# serve/solvecache.py) sits between writer and observatory: the writer
# thread publishes entries on its result path, and a cache consult may
# feed observatory counters — never the reverse.
LOCK_RANKS = {"fleet": -10, "gateway": 0, "engine": 10, "writer": 20,
              "cache": 25, "observatory": 30}


class LockOrderError(RuntimeError):
    """An acquisition that inverts the documented lock order."""


_tls = threading.local()
_stats_lock = threading.Lock()
_edges: set = set()          # (held_name, acquired_name) pairs observed
_violations: List[str] = []  # human-readable inversion descriptions
_taken: dict = {}            # rank -> ordered-lock acquisitions observed


def lockcheck_enabled() -> bool:
    """Is the dynamic lock-order watchdog armed (HEAT_TPU_LOCKCHECK=1)?
    Read at lock *creation* time: engines built after the env flips get
    ordered locks, existing plain locks are untouched."""
    return os.environ.get("HEAT_TPU_LOCKCHECK", "") == "1"


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _OrderedLock:
    """A ``threading.Lock`` that enforces the LOCK_RANKS partial order.

    Duck-types the subset of the Lock API the stack uses (``acquire`` /
    ``release`` / context manager), which is also exactly what
    ``threading.Condition`` needs to wrap it — ``Condition.wait`` falls
    back to plain release/acquire pairs, each of which keeps the
    held-stack bookkeeping exact. ``acquire(blocking=False)`` performs
    the order check only on a SUCCESSFUL acquisition: Condition's
    ``_is_owned`` probe try-acquires a lock the thread already holds and
    must get a quiet ``False``, not an error."""

    __slots__ = ("name", "rank", "_lock")

    def __init__(self, name: str, rank: int):
        self.name = name
        self.rank = rank
        self._lock = threading.Lock()

    def _check_order(self) -> None:
        stack = _held()
        if not stack:
            return
        worst = max(stack, key=lambda l: l.rank)
        if any(l is self for l in stack):
            msg = (f"reentrant acquire of lock {self.name!r} "
                   f"(non-reentrant by design; this would deadlock)")
        elif self.rank <= worst.rank:
            msg = (f"lock order inversion: acquiring {self.name!r} "
                   f"(rank {self.rank}) while holding {worst.name!r} "
                   f"(rank {worst.rank}) — documented order is "
                   + " < ".join(sorted(LOCK_RANKS, key=LOCK_RANKS.get)))
        else:
            return
        with _stats_lock:
            _violations.append(msg)
        raise LockOrderError(msg)

    def _note_acquired(self) -> None:
        stack = _held()
        rank = self.name.split(":", 1)[0]
        with _stats_lock:
            if stack:
                _edges.add((stack[-1].name, self.name))
            _taken[rank] = _taken.get(rank, 0) + 1
        stack.append(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            # check BEFORE blocking: an inversion must raise, not deadlock
            self._check_order()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            if not blocking:
                try:
                    self._check_order()
                except LockOrderError:
                    self._lock.release()
                    raise
            self._note_acquired()
        return ok

    def release(self) -> None:
        stack = _held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()


def make_lock(name: str):
    """The lock factory of the serving stack: a plain
    ``threading.Lock`` normally, an order-enforcing :class:`_OrderedLock`
    under ``HEAT_TPU_LOCKCHECK=1``. ``name`` is ``"<rank>[:<detail>]"``
    with ``<rank>`` a LOCK_RANKS key (unknown ranks raise at creation —
    a misnamed lock must not silently opt out of the discipline)."""
    rank_name = name.split(":", 1)[0]
    if rank_name not in LOCK_RANKS:
        raise ValueError(f"unknown lock rank {rank_name!r} in lock name "
                         f"{name!r}; known: {sorted(LOCK_RANKS)}")
    # the race sanitizer needs the per-thread held stacks too: candidate
    # locksets are computed from exactly this bookkeeping
    if not (lockcheck_enabled() or racecheck_enabled()):
        return threading.Lock()
    return _OrderedLock(name, LOCK_RANKS[rank_name])


def held_locks() -> List[str]:
    """Names of ordered locks the calling thread holds (tests)."""
    return [l.name for l in _held()]


def lock_order_stats() -> dict:
    """Watchdog observations so far: every (held -> acquired) edge seen,
    every inversion raised, and the acquisitions per rank (which ranks a
    run reached at all). An armed run passes when ``violations == []``
    after its drain."""
    with _stats_lock:
        return {"edges": sorted(_edges), "violations": list(_violations),
                "taken": dict(sorted(_taken.items()))}


def reset_lock_order_stats() -> None:
    with _stats_lock:
        _edges.clear()
        _violations.clear()
        _taken.clear()


# --------------------------------------------------------------------------
# Eraser-style race sanitizer (opt-in: HEAT_TPU_RACECHECK=1 | record)
# --------------------------------------------------------------------------
#
# The dynamic half of the `races` static rule (analysis/races.py):
# per-(object, field) candidate locksets, maintained from the lock-order
# watchdog's per-thread held stacks (Eraser, Savage et al. SOSP '97). A
# field starts owned by its first-touching thread; when a second thread
# touches it the candidate lockset is seeded from that thread's held
# ordered locks and intersected on every later access. A WRITE from a
# second writing thread with an empty lockset intersection is reported —
# reads shift ownership state but only write locksets are judged, matching
# the static guard map's contract (the repo's documented single-writer
# GIL-publish pattern is sanctioned, write-write races are not).
#
# HEAT_TPU_RACECHECK=1      -> raise RaceError at the racing write (tests)
# HEAT_TPU_RACECHECK=record -> emit a structured `race_detected` record and
#                              trigger the registered flight-dump hook,
#                              keep running (production triage)


class RaceError(RuntimeError):
    """A write-write race: a field written by two threads with no lock
    consistently held across the writes."""


_race_lock = threading.Lock()
_race_findings: List[dict] = []
_race_instrumented = 0
_flight_dump_hook: Optional[callable] = None
_instrumented_classes: dict = {}


def racecheck_enabled() -> bool:
    """Is the dynamic race sanitizer armed? Read at instrument/lock
    creation time, like :func:`lockcheck_enabled`."""
    return os.environ.get("HEAT_TPU_RACECHECK", "") in ("1", "record")


def _racecheck_raises() -> bool:
    return os.environ.get("HEAT_TPU_RACECHECK", "") == "1"


def set_flight_dump_hook(fn: Optional[callable]) -> None:
    """Register the flight-recorder dump callable (``Engine`` passes its
    ``_flight_dump``); called with a reason string when a race or thread
    crash is recorded in non-raising mode."""
    global _flight_dump_hook
    _flight_dump_hook = fn


def _fire_flight_dump(reason: str) -> None:
    hook = _flight_dump_hook
    if hook is None:
        return
    try:
        hook(reason)
    except Exception as e:  # noqa: BLE001 — the dump must never compound
        # the failure it is documenting
        from .logging import master_print
        master_print(f"race sanitizer: flight dump failed ({e})")


def _race_access(obj, label: str, field: str, write: bool) -> None:
    if getattr(_tls, "race_busy", False):
        return
    _tls.race_busy = True
    try:
        me = threading.get_ident()
        held = frozenset(l.name for l in _held())
        states = object.__getattribute__(obj, "_race_states")
        finding = None
        with _race_lock:
            st = states.get(field)
            if st is None:
                states[field] = {"owner": me, "writers": set(
                    [me] if write else []), "lockset": None,
                    "reported": False}
                return
            if write:
                st["writers"].add(me)
                if len(st["writers"]) >= 2:
                    st["lockset"] = (held if st["lockset"] is None
                                     else st["lockset"] & held)
            elif st["lockset"] is not None and me != st["owner"]:
                # a reader participating after sharing narrows the set
                # only if it holds SOME lock (a bare read is the
                # sanctioned GIL-publish consumer, not a vote)
                if held:
                    st["lockset"] = st["lockset"] & held
            if (write and st["lockset"] is not None
                    and not st["lockset"] and not st["reported"]):
                st["reported"] = True
                finding = {
                    "object": label, "field": field,
                    "thread": threading.current_thread().name,
                    "writers": len(st["writers"]),
                    "held": sorted(held),
                }
                _race_findings.append(finding)
        if finding is not None:
            msg = (f"race detected: {label}.{field} written from "
                   f"{finding['writers']} threads with empty lockset "
                   f"intersection (this write on "
                   f"{finding['thread']!r} holds "
                   f"{finding['held'] or 'no locks'})")
            if _racecheck_raises():
                raise RaceError(msg)
            from .logging import json_record, master_print
            master_print(f"race sanitizer: {msg}")
            json_record("race_detected", object=finding["object"],
                        field=finding["field"], thread=finding["thread"],
                        writers=finding["writers"],
                        held=finding["held"])
            _fire_flight_dump(f"race detected on {label}.{field}")
    finally:
        _tls.race_busy = False


def _instrumented_class(base: type) -> type:
    cached = _instrumented_classes.get(base)
    if cached is not None:
        return cached

    class _RaceInstrumented(base):  # type: ignore[misc, valid-type]
        __race_base__ = base

        def __getattribute__(self, name):
            val = object.__getattribute__(self, name)
            if name.startswith("_race_") or (name.startswith("__")
                                             and name.endswith("__")):
                return val
            d = object.__getattribute__(self, "__dict__")
            watch = d.get("_race_watch")
            if watch is not None and name in watch:
                _race_access(self, d.get("_race_label", base.__name__),
                             name, write=False)
            return val

        def __setattr__(self, name, value):
            object.__setattr__(self, name, value)
            d = object.__getattribute__(self, "__dict__")
            watch = d.get("_race_watch")
            if watch is not None and name in watch:
                _race_access(self, d.get("_race_label", base.__name__),
                             name, write=True)

    _RaceInstrumented.__name__ = base.__name__
    _RaceInstrumented.__qualname__ = base.__qualname__
    _instrumented_classes[base] = _RaceInstrumented
    return _RaceInstrumented


def instrument_races(obj, label: Optional[str] = None,
                     exempt: frozenset = frozenset()):
    """Arm Eraser-style per-field lockset tracking on ``obj``.

    No-op (and zero cost) unless :func:`racecheck_enabled`. The watched
    set is the instance's ``__dict__`` at instrument time — call at the
    END of ``__init__`` — minus ``exempt`` (fields the committed guard
    map sanctions via allow-markers: instance-confined accounting,
    lock-free rings), minus the synchronization objects themselves.
    Returns ``obj``."""
    global _race_instrumented
    if not racecheck_enabled():
        return obj
    if getattr(type(obj), "__race_base__", None) is not None:
        return obj  # already instrumented
    import queue as _queue
    sync_types = (threading.Event, threading.Condition,
                  threading.Semaphore, _queue.Queue, _OrderedLock,
                  type(threading.Lock()), type(threading.RLock()))
    watch = frozenset(
        k for k, v in vars(obj).items()
        if k not in exempt and not k.startswith("_race_")
        and not isinstance(v, sync_types) and not callable(v))
    object.__setattr__(obj, "_race_states", {})
    object.__setattr__(obj, "_race_watch", watch)
    object.__setattr__(obj, "_race_label", label or type(obj).__name__)
    obj.__class__ = _instrumented_class(type(obj))
    with _race_lock:
        _race_instrumented += 1
    return obj


def race_stats() -> dict:
    """Sanitizer observations so far, queryable like
    :func:`lock_order_stats`: instrumented-object count and every
    recorded finding. An armed run passes when ``findings == []`` after
    its drain."""
    with _race_lock:
        return {"instrumented": _race_instrumented,
                "findings": [dict(f) for f in _race_findings]}


def reset_race_stats() -> None:
    global _race_instrumented
    with _race_lock:
        _race_findings.clear()
        _race_instrumented = 0


def guard_report() -> Optional[dict]:
    """What the armed lock-order watchdog and race sanitizer saw in this
    process (``HEAT_TPU_LOCKCHECK=1``, ``HEAT_TPU_RACECHECK=1|record``), or
    None when neither is armed: a serve summary or a lab record carries it
    only then."""
    if not (lockcheck_enabled() or racecheck_enabled()):
        return None
    locks, races = lock_order_stats(), race_stats()
    return {"lockcheck": lockcheck_enabled(),
            "racecheck": racecheck_enabled(),
            "lock_order_violations": len(locks["violations"]),
            "lock_order_edges": len(locks["edges"]),
            "races_detected": len(races["findings"]),
            "race_instrumented": races["instrumented"],
            "edges": locks["edges"],
            "ranks_taken": locks["taken"],
            "violations": locks["violations"],
            "race_findings": races["findings"]}


# --------------------------------------------------------------------------
# background-thread crash hook
# --------------------------------------------------------------------------

_excepthook_installed = False


def install_thread_excepthook() -> None:
    """Route uncaught background-thread exceptions (writer, scheduler,
    gateway handler) into a structured ``thread_crash`` record plus a
    flight-recorder dump instead of an easy-to-miss stderr traceback.
    Idempotent; chains to the previously installed hook so default
    stderr reporting (and pytest's capture) still sees the crash."""
    global _excepthook_installed
    if _excepthook_installed:
        return
    _excepthook_installed = True
    prev = threading.excepthook

    def hook(args):
        try:
            from .logging import json_record
            name = args.thread.name if args.thread is not None else "?"
            daemon = bool(args.thread.daemon) if args.thread is not None \
                else False
            json_record("thread_crash", thread=name,
                        exc_type=getattr(args.exc_type, "__name__",
                                         str(args.exc_type)),
                        error=str(args.exc_value), daemon=daemon)
            _fire_flight_dump(f"uncaught exception in thread {name}: "
                              f"{getattr(args.exc_type, '__name__', '?')}")
        finally:
            prev(args)

    threading.excepthook = hook


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], device=None):
    """Wrap a region in a ``torch.profiler`` trace when a directory is
    given; the Chrome trace lands in ``trace_dir/trace.json``."""
    if not trace_dir:
        yield
        return
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))


def finite_flag(T):
    """All-finite reduction WITHOUT blocking the host on it.

    A tensor reduces on its own device and the 0-d bool tensor is returned
    still there: the caller holds it and reads it at the NEXT chunk
    boundary (``raise_if_flagged``), by which point the device has
    computed it behind the following chunk's work. Host arrays reduce
    eagerly (nothing to overlap)."""
    import numpy as np
    import torch

    if isinstance(T, torch.Tensor):
        return torch.isfinite(T).all()
    return np.isfinite(np.asarray(T).astype(np.float32)).all()


def raise_if_flagged(flag, step: int, label: str = "field") -> None:
    """Read a ``finite_flag`` result (one scalar) and raise with the step
    context the flag was computed at."""
    if not bool(flag):
        raise FloatingPointError(
            f"non-finite values in {label} at step {step} — check the CFL "
            f"bound sigma <= 1/(2*ndim) and the fuse/halo configuration"
        )


def check_finite(T, step: int, label: str = "field") -> None:
    """Synchronous form: compute the flag and block on it immediately."""
    raise_if_flagged(finite_flag(T), step, label)
