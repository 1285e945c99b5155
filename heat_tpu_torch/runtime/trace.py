"""Request-scoped tracing + always-on flight recorder.

The port of ``heat_tpu.runtime.trace``: the same event ring, tracks,
Chrome export, flight dumps and text summary, so a trace of the port and
one of the reference read alike.

The serving stack's aggregate observability (Prometheus counters,
``Timing`` totals) says *how much* boundary wait or device idle happened,
never *which request, which lane, which chunk*. This module is the
Dapper-shaped answer (Sigelman et al. 2010 — see PAPERS.md): a trace id
minted per request at admission, carried through every hop (queue ->
lane -> chunk boundaries -> writer publish -> HTTP record), and an
exporter that writes Chrome trace-event JSON loadable in Perfetto /
``chrome://tracing``.

Design constraints, in priority order:

- **Near-zero hot-path cost.** ``record`` is one monotonic clock read +
  one bounded-deque append of a tuple; no I/O, no formatting, no string
  building on the hot path (names are preformatted by the caller at
  admission/track-creation time, not per event). A disabled tracer
  (``capacity=0``) costs one attribute test per call site.
- **Bounded memory.** Events live in a ring (``collections.deque`` with
  ``maxlen``): a week-long serve run retains the newest ``capacity``
  events and silently drops the oldest — by construction, never by
  backpressure. CPython's deque append is GIL-atomic, so scheduler,
  writer, and gateway threads append without contending a lock.
- **Always-on flight recorder.** Recording runs even with ``--trace``
  off: when a watchdog fires, a lane is quarantined after its rollback
  budget, or the scheduler loop crashes, the ring is dumped atomically to
  ``<dir>/flightrec-<ts>.trace.json`` — the last N events *before* the
  fault, exactly what a postmortem needs and exactly what aggregate
  counters can never give. ``--trace-buffer 0`` / ``HEAT_TPU_TRACE=off``
  opts out of even this.

Event model (Chrome trace-event format, the subset Perfetto renders):

- ``X`` complete spans (ts + dur) on a (pid, tid) *track* — lane
  occupancy, chunk in flight, boundary fetch, writer jobs, HTTP handling;
- ``i`` instants — enqueue, rollback, quarantine, watchdog, growth,
  numerics verdicts (steady-state, numerics-violation), and steady-exit
  retirements whose args carry ``at_step`` vs ``predicted_at_step`` so
  predictor misses are triageable in Perfetto;
- ``C`` counter samples — the numerics observatory's per-lane residual
  and total-heat series, one sample per chunk boundary, rendered by
  Perfetto as stacked counter tracks;
- ``b``/``e`` async spans (id-paired, overlap-safe) — per-request queue
  wait, which can overlap arbitrarily on one tenant track;
- ``s``/``t``/``f`` flow events (id = the request's trace id) stitching
  one request's hops across threads: submit (gateway/JSONL thread) ->
  lane admission (lane track) -> retirement -> terminal record emission
  (writer thread).

Tracks are registered names: one *process* row per bucket group with one
*thread* row per lane (the lane occupancy timeline), plus process rows
for the scheduler / writer / gateway threads and the admission queues.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import debug
from .logging import master_print

# Ring capacity default: tuples are ~150 B, so the always-on recorder
# holds ~5 MiB at worst — hours of serve traffic at typical boundary
# rates, and the knob (--trace-buffer / ServeConfig.trace_buffer) is
# right there when a long wave needs more.
DEFAULT_BUFFER = 32768

ENV_VAR = "HEAT_TPU_TRACE"
_ENV_OFF = ("off", "0", "none", "")

# Flight dumps are a postmortem tool, not a log stream: a storm of
# watchdog fires across many bucket groups must not write a dump per
# group for the same incident.
MAX_FLIGHT_DUMPS = 8

# Uptime zero point for /metrics' heat_tpu_process_uptime_seconds (and
# anything else that wants "since this process started").
PROCESS_START = time.monotonic()


def process_uptime_s() -> float:
    return time.monotonic() - PROCESS_START


# Event tuples: (ts, dur, ph, name, cat, pid, tid, xid, args)
#   ts/dur   seconds on the time.perf_counter clock (the scheduler's
#            wall_clock seam uses the same clock, so queue-wait spans can
#            reuse submit timestamps verbatim); dur None except for "X"
#   ph       Chrome phase: X i b e s t f C
#   xid      trace/flow/async id (string) or None
#   args     small dict or None — the caller must not mutate it afterwards


class Tracer:
    """A bounded in-memory event ring with Chrome-trace export.

    One per serving engine (``Engine.tracer``) plus a process-global one
    for the solo ``drive()`` path (``get_tracer()``)."""

    def __init__(self, capacity: int = DEFAULT_BUFFER):
        self.capacity = int(capacity)
        self.enabled = self.capacity > 0
        self._buf: collections.deque = collections.deque(
            maxlen=max(1, self.capacity))
        # track registry + export only; never taken on the event path
        self._lock = debug.make_lock("observatory:trace")
        self._procs: Dict[str, int] = {}    # process name -> pid
        self._tracks: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._track_names: Dict[Tuple[int, int], Tuple[str, str]] = {}
        self._ids = itertools.count(1)
        self._id_prefix = f"{os.getpid():x}"
        self.dumps = 0                      # flight dumps written
        self.dump_paths: List[str] = []     # where they landed (the
                                            # flightrec record + /statusz
                                            # name these so operators
                                            # never grep the filesystem)
        self.dropped_hint = False           # ring wrapped at least once
        self._appended = 0
        # race sanitizer (no-op unless HEAT_TPU_RACECHECK): the exempt
        # trio is the allow-marked lock-free ring — _append stays a
        # zero-instrumentation hot path even when the sanitizer is armed
        debug.instrument_races(
            self, label="Tracer",
            exempt=frozenset({"_buf", "_appended", "dropped_hint"}))

    # --- identity ---------------------------------------------------------
    def mint_trace_id(self) -> str:
        """A process-unique request trace id (echoed in records and the
        ``X-Trace-Id`` header; doubles as the flow id that stitches the
        request's hops). Minted even when recording is disabled so the
        record schema never depends on tracing state."""
        return f"{self._id_prefix}-{next(self._ids):04x}"

    # --- tracks -----------------------------------------------------------
    def track(self, process: str, thread: str) -> Tuple[int, int]:
        """The (pid, tid) for a named track, registered on first use.
        Call at setup time (lane install, runner construction) and keep
        the tuple — the registry lookup is locked and not meant for the
        per-event path."""
        key = (process, thread)
        t = self._tracks.get(key)
        if t is not None:
            return t
        with self._lock:
            t = self._tracks.get(key)
            if t is None:
                pid = self._procs.setdefault(process, len(self._procs) + 1)
                t = (pid, sum(1 for k in self._tracks if k[0] == process) + 1)
                self._tracks[key] = t
                self._track_names[t] = key
        return t

    def thread_track(self, process: str = "threads") -> Tuple[int, int]:
        """Track for the calling thread (scheduler loop, gateway handler,
        snapshot writer): one row per live thread name."""
        return self.track(process, threading.current_thread().name)

    # --- recording (the hot path) -----------------------------------------
    def now(self) -> float:
        return time.perf_counter()

    def complete(self, name: str, track: Tuple[int, int], t0: float,
                 t1: Optional[float] = None, cat: str = "serve",
                 trace_id: Optional[str] = None, args: Optional[dict] = None
                 ) -> None:
        """One finished span [t0, t1] on ``track`` (phase "X")."""
        if not self.enabled:
            return
        if t1 is None:
            t1 = time.perf_counter()
        self._append((t0, t1 - t0, "X", name, cat, track[0], track[1],
                      trace_id, args))

    def instant(self, name: str, track: Tuple[int, int], cat: str = "serve",
                trace_id: Optional[str] = None, args: Optional[dict] = None,
                ts: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self._append((time.perf_counter() if ts is None else ts, None, "i",
                      name, cat, track[0], track[1], trace_id, args))

    def counter(self, name: str, track: Tuple[int, int], values: dict,
                cat: str = "numerics", ts: Optional[float] = None) -> None:
        """One sample of a named counter track (phase "C"): ``values``
        maps series name -> number and must not be mutated by the caller
        afterwards (same no-copy contract as every ``args`` here). The
        numerics observatory emits one of these per lane per chunk
        boundary — residual + total heat riding the boundary vector."""
        if not self.enabled:
            return
        self._append((time.perf_counter() if ts is None else ts, None, "C",
                      name, cat, track[0], track[1], None, values))

    def flow(self, phase: str, track: Tuple[int, int], flow_id: str,
             name: str = "request", ts: Optional[float] = None) -> None:
        """One hop of a cross-thread flow arrow: phase "s" (start at
        submit), "t" (step: admission, retirement), "f" (end: terminal
        record emitted). All hops of one request share ``flow_id`` (its
        trace id)."""
        if not self.enabled:
            return
        self._append((time.perf_counter() if ts is None else ts, None,
                      phase, name, "request", track[0], track[1], flow_id,
                      None))

    def async_span(self, name: str, track: Tuple[int, int], t0: float,
                   t1: float, xid: str, cat: str = "queue",
                   args: Optional[dict] = None) -> None:
        """An id-paired async span ("b"/"e"): unlike "X" spans these may
        overlap freely on one track (many requests of one tenant waiting
        at once), which is exactly the queue-wait shape."""
        if not self.enabled:
            return
        self._append((t0, None, "b", name, cat, track[0], track[1], xid,
                      args))
        self._append((t1, None, "e", name, cat, track[0], track[1], xid,
                      None))

    def _append(self, ev: tuple) -> None:
        self._appended += 1
        if self._appended > self.capacity:  # heat-tpu: allow[races] lock-free ring by design — deque.append is GIL-atomic and _appended/dropped_hint are advisory drop hints where a lost update only blurs the hint, so the span hot path takes no lock
            self.dropped_hint = True
        self._buf.append(ev)

    def __len__(self) -> int:
        return len(self._buf)

    # --- export -----------------------------------------------------------
    def snapshot(self) -> List[tuple]:
        # deque -> tuple is a C-level walk with no Python re-entry, so it
        # is consistent under the GIL against concurrent appends
        return list(tuple(self._buf))

    def to_chrome(self, events: Optional[List[tuple]] = None) -> dict:
        """The ring (or ``events``) as a Chrome trace-event JSON object.
        Timestamps are exported in microseconds relative to the earliest
        event; events are sorted, so per-track ``ts`` is monotone."""
        evs = self.snapshot() if events is None else list(events)
        evs.sort(key=lambda e: e[0])
        t0 = evs[0][0] if evs else 0.0
        out = []
        with self._lock:
            names = dict(self._track_names)
        seen_pids = set()
        for (pid, tid), (pname, tname) in sorted(names.items()):
            if pid not in seen_pids:
                seen_pids.add(pid)
                out.append({"ph": "M", "ts": 0, "pid": pid, "tid": 0,
                            "name": "process_name",
                            "args": {"name": pname}})
            out.append({"ph": "M", "ts": 0, "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": tname}})
        for ts, dur, ph, name, cat, pid, tid, xid, args in evs:
            e = {"ph": ph, "ts": round((ts - t0) * 1e6, 3), "pid": pid,
                 "tid": tid, "name": name, "cat": cat}
            if ph == "X":
                e["dur"] = round((dur or 0.0) * 1e6, 3)
            elif ph == "i":
                e["s"] = "t"
            if ph in ("s", "t", "f"):
                e["id"] = xid
                e["bp"] = "e"
            elif ph in ("b", "e"):
                e["id"] = xid
            a = dict(args) if args else {}
            if xid is not None and ph in ("X", "i", "b"):
                a["trace_id"] = xid
            if a:
                e["args"] = a
            out.append(e)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path, events: Optional[List[tuple]] = None) -> Path:
        """Write the Chrome trace JSON atomically (same torn-file
        discipline as every other publish in this repo: temp name outside
        any discovery glob, then rename)."""
        path = Path(path)
        if path.parent:
            path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(events), f)
        tmp.rename(path)
        return path

    def flight_dump(self, out_dir, reason: str) -> Optional[Path]:
        """Dump the ring to ``<out_dir>/flightrec-<ts>.trace.json`` (the
        flight-recorder exit: watchdog fire, quarantine-after-rollbacks,
        scheduler crash). Bounded per tracer (``MAX_FLIGHT_DUMPS``) and
        never allowed to raise into the failure path it is documenting."""
        with self._lock:
            # atomic slot reserve: concurrent failure paths (watchdog on
            # the scheduler thread, a client shutdown) must not both pass
            # the bound check and overshoot MAX_FLIGHT_DUMPS
            if not self.enabled or self.dumps >= MAX_FLIGHT_DUMPS:
                return None
            self.dumps += 1
            seq = self.dumps
        stamp = time.strftime("%Y%m%dT%H%M%S")
        path = Path(out_dir) / f"flightrec-{stamp}-{seq}.trace.json"
        try:
            self.export(path)
        except OSError as e:
            master_print(f"flight recorder: dump to {path} failed ({e}) — "
                         f"continuing without it")
            return None
        with self._lock:
            self.dump_paths.append(str(path))
        master_print(f"flight recorder: {reason} — dumped {len(self._buf)} "
                     f"event(s) to {path}")
        return path


# --- CLI/env resolution -------------------------------------------------------

def resolve_trace(path_flag: Optional[str],
                  buffer_flag: Optional[int]) -> Tuple[Optional[str], int]:
    """Fold ``--trace FILE`` / ``--trace-buffer N`` / ``HEAT_TPU_TRACE``
    into (export path or None, ring capacity).

    ``HEAT_TPU_TRACE=FILE`` is the env spelling of ``--trace FILE`` (the
    flag wins); ``HEAT_TPU_TRACE=off`` (or ``0``) disables recording
    entirely — no flight recorder, no export. An explicit
    ``--trace-buffer`` always sets the capacity; asking for an export
    with a zero buffer is a contradiction and rejected loudly."""
    env = os.environ.get(ENV_VAR, "").strip()
    env_off = env.lower() in _ENV_OFF
    path = path_flag or (None if env_off else env or None)
    if buffer_flag is not None:
        if buffer_flag < 0:
            raise ValueError(f"--trace-buffer must be >= 0 (0 disables "
                             f"recording), got {buffer_flag}")
        capacity = buffer_flag
    else:
        capacity = 0 if (env_off and env) and not path_flag else DEFAULT_BUFFER
    if path and capacity == 0:
        raise ValueError("--trace needs a non-zero --trace-buffer (the "
                         "export is the ring's contents)")
    return path, capacity


# --- process-global tracer (the solo drive() path) ----------------------------

_GLOBAL: Optional[Tracer] = None
# plain: a double-checked singleton guard, held only to construct or
# swap the global tracer (rank observatory; nothing is taken under it)
_GLOBAL_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer the solo ``drive()`` path records into
    (serving engines own theirs — ``Engine.tracer``). Created lazily with
    the default flight-recorder capacity; ``configure`` replaces it."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Tracer()
    return _GLOBAL


def configure(capacity: int = DEFAULT_BUFFER) -> Tracer:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = Tracer(capacity=capacity)
    return _GLOBAL


# --- text summary (`python -m heat_tpu_torch trace FILE`) -------------------------------------

def summarize(chrome: dict, top: int = 5) -> List[str]:
    """Render a text timeline summary from a Chrome trace object (a
    ``--trace`` export, a flight dump, or a ``/tracez`` response): wall
    span, per-lane utilization per bucket group, top queue-wait requests,
    boundary-fetch/device-idle totals, and notable instants."""
    if isinstance(chrome, list):      # the bare-array trace form
        chrome = {"traceEvents": chrome}
    evs = chrome.get("traceEvents", [])
    procs: Dict[int, str] = {}
    threads: Dict[Tuple[int, int], str] = {}
    for e in evs:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            procs[e["pid"]] = e["args"]["name"]
        elif e.get("name") == "thread_name":
            threads[(e["pid"], e["tid"])] = e["args"]["name"]
    data = [e for e in evs if e.get("ph") != "M"]
    if not data:
        return ["trace: no events (buffer empty — see TROUBLESHOOTING: "
                "was the ring too small, or tracing disabled?)"]
    t_lo = min(e["ts"] for e in data)
    t_hi = max(e["ts"] + e.get("dur", 0.0) for e in data)
    wall = max(t_hi - t_lo, 1e-9)
    lines = [f"trace: {len(data)} event(s) over {wall / 1e6:.3f}s across "
             f"{len(threads)} track(s)"]

    # per-lane utilization: X spans on "lane N" tracks of "lanes ..." rows
    busy: Dict[Tuple[int, int], float] = collections.defaultdict(float)
    reqs: Dict[Tuple[int, int], int] = collections.defaultdict(int)
    for e in data:
        if e.get("ph") != "X":
            continue
        key = (e["pid"], e["tid"])
        if (procs.get(e["pid"], "").startswith("lanes")
                and threads.get(key, "").startswith("lane")):
            busy[key] += e.get("dur", 0.0)
            reqs[key] += 1
    if busy:
        lines.append("lane utilization (occupancy wall / trace wall):")
        for key in sorted(busy):
            lines.append(
                f"  {procs.get(key[0], key[0])} {threads.get(key, key[1])}: "
                f"{100.0 * busy[key] / wall:5.1f}% "
                f"({reqs[key]} request(s))")

    # top queue waits: b/e pairs named queue-wait, id-paired
    begins: Dict[str, dict] = {}
    waits: List[Tuple[float, str, dict]] = []
    for e in data:
        if e.get("name") != "queue-wait":
            continue
        if e.get("ph") == "b":
            begins[e.get("id")] = e
        elif e.get("ph") == "e" and e.get("id") in begins:
            b = begins.pop(e["id"])
            waits.append((e["ts"] - b["ts"], e["id"],
                          b.get("args", {})))
    if waits:
        waits.sort(reverse=True, key=lambda w: w[0])
        lines.append(f"top queue waits (of {len(waits)}):")
        for dur, xid, args in waits[:top]:
            lines.append(f"  {args.get('id', xid)}: {dur / 1e6:.3f}s "
                         f"(tenant {args.get('tenant', '?')}, "
                         f"class {args.get('class', '?')}, "
                         f"policy {args.get('policy', '?')})")

    for name, label in (("boundary-fetch", "boundary-fetch wall"),
                        ("device-idle", "device-idle wall")):
        tot = sum(e.get("dur", 0.0) for e in data
                  if e.get("ph") == "X" and e.get("name") == name)
        n = sum(1 for e in data if e.get("ph") == "X"
                and e.get("name") == name)
        if n:
            lines.append(f"{label}: {tot / 1e6:.3f}s over {n} span(s) "
                         f"({100.0 * tot / wall:.1f}% of trace wall)")

    # counter tracks ("C" samples — the numerics observatory's per-lane
    # residual/heat series): min/max/last per series, so a text triage
    # shows whether a residual was still falling when the trace ended
    counters: Dict[Tuple[str, str], List[float]] = collections.defaultdict(list)
    for e in data:
        if e.get("ph") != "C":
            continue
        for series, v in (e.get("args") or {}).items():
            if isinstance(v, (int, float)):
                counters[(e.get("name", "?"), series)].append(float(v))
    if counters:
        lines.append("counter tracks:")
        for (name, series), vals in sorted(counters.items()):
            lines.append(
                f"  {name}/{series}: {len(vals)} sample(s), "
                f"min {min(vals):.3g}, max {max(vals):.3g}, "
                f"last {vals[-1]:.3g}")

    notable = collections.Counter(
        e["name"] for e in data if e.get("ph") == "i"
        and e.get("name") in ("watchdog-fired", "rollback", "quarantine",
                              "deadline-shed", "lane-tier-grow",
                              "numerics-violation", "steady-state",
                              "steady-exit"))
    if notable:
        lines.append("events: " + ", ".join(
            f"{n} {k}" for k, n in sorted(notable.items())))
    return lines


def summarize_file(path, top: int = 5) -> List[str]:
    with open(path) as f:
        return summarize(json.load(f), top=top)
