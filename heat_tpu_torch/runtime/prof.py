"""Performance & cost observatory: the serving stack's metering layer.

The port of ``heat_tpu.runtime.prof``. ``runtime/trace.py`` answers
*where time went* for one request; this module answers *what work costs*
in aggregate. Everything here is fed from timestamps the scheduler
already takes (dispatch->fetch deltas, boundary waits, terminal-record
transitions) — no new device syncs — and the whole layer switches off
with ``ServeConfig(prof=False)`` / ``serve --prof off`` (the usage stamps
on records stay, so the record schema never flickers; only the
aggregation, model and sampling work stops).

Five instruments, one :class:`Observatory` per serving engine:

- :class:`CostModel` — the **online chunk-cost model**: per
  (bucket, lane-tier, dispatch-depth, kernel) EWMA + histogram of
  seconds-per-lane-step, learned from chunk-boundary service times.
  The observation is the queueing service-time estimator
  ``t_fetch_done - max(prev_fetch_done, t_dispatch)``: exact under a
  fenced boundary (depth 0/1), and equal to the per-chunk service time
  under a saturated dispatch-ahead pipeline. Exported through
  ``Engine.summary()["cost_model"]``, ``/metrics`` gauges and
  ``GET /statusz``; ``until=steady`` admissions read their
  ``predicted_wall_s`` from it.
- :class:`CompileLog` — the **compile observatory**: a process-wide
  structured log of the port's one-time costs — each kernel source's
  ``nvcc`` build (``ops/_build``) and the solo drive's warm-up — with
  key, wall seconds, and first-vs-warm.
- :class:`MemWatermark` — **memory watermarks + leak sentinel**: polls
  the engine device's memory (``device_memory_bytes``) every N chunk
  boundaries, off the hot path, tracking peak bytes and the growth over
  a rolling window. Monotone growth across the whole window past a byte
  floor — the rollback-stack / lane-grow leak shape — emits ONE
  structured ``mem_watermark`` warning record (re-armed only after the
  level doubles again).
- :class:`UsageLedger` — the **per-tenant usage ledger**: every terminal
  record is stamped with its resource usage (lane-seconds, steps,
  chunks, bytes written) by the scheduler; the ledger aggregates the
  exact same stamps per (tenant, class), so ``GET /v1/usage`` totals
  reconcile exactly with the sum over per-request records.
- :class:`BurnMonitor` — the **SLO burn-rate monitor**: per-class
  rolling deadline-hit windows (fast + slow) over requests that carried
  a deadline. Burn rate is ``miss_fraction / error_budget`` (budget =
  1 - target, ``config.SLO_TARGETS``). When BOTH windows burn above the
  threshold the monitor returns one structured ``slo_alert``
  (cooldown-limited).

Lock order: every instrument carries its own small lock and none of them
ever takes the engine lock — the engine calls into the observatory
(sometimes while holding its own lock, e.g. ``_emit``), and the gateway's
scrape threads call snapshot methods that take only observatory locks.
The order is always engine -> observatory, never the reverse.
"""

from __future__ import annotations

import collections
import itertools
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import debug


# --- /metrics histogram primitive (moved here from serve/policy.py so the
# --- observatory owns its primitives without a runtime -> serve import;
# --- policy.py re-exports for its existing consumers) --------------------

# Latency-shaped default buckets (seconds): sub-ms admission rejections up
# through minute-scale batch solves; queue-depth histograms reuse the same
# machinery with integer buckets.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
# Per-lane-step seconds span ~7 decades between a warm lane kernel on the
# card and a cold one-core CPU host: log-spaced buckets or the histogram says nothing
LANE_STEP_BUCKETS = tuple(10.0 ** e for e in range(-8, 1))


class Histogram:
    """A Prometheus-style cumulative histogram (stdlib-only).

    ``observe`` is called from the scheduler AND writer threads, so it
    carries its own lock (deliberately not the engine lock: a /metrics
    scrape must never contend with the boundary hot path for the lock
    that guards admission)."""

    def __init__(self, buckets=LATENCY_BUCKETS):
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._n = 0
        self._lock = debug.make_lock("observatory:hist")

    def observe(self, v: float) -> None:
        with self._lock:
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += v
            self._n += 1

    def snapshot(self) -> dict:
        """Cumulative (le -> count) pairs + sum/count, scrape-consistent."""
        with self._lock:
            counts = list(self._counts)
            total_sum, n = self._sum, self._n
        cum = list(itertools.accumulate(counts))
        les = [*(f"{b:g}" for b in self.buckets), "+Inf"]
        return {"buckets": list(zip(les, cum)), "sum": total_sum, "count": n}

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-upper-bound estimate of the q-quantile (the benchmark's
        p50/p95/p99 reporting; None when empty). Conservative: returns the
        smallest bucket bound covering q of the observations."""
        snap = self.snapshot()
        if not snap["count"]:
            return None
        target = q * snap["count"]
        for le, cum in snap["buckets"]:
            if cum >= target:
                return math.inf if le == "+Inf" else float(le)
        return math.inf


# --- (a) online chunk-cost model ---------------------------------------------

# EWMA smoothing: ~the last 10 boundaries dominate — fast enough to track
# a thermal/occupancy shift inside one wave, slow enough that one noisy
# fetch doesn't whipsaw a placement decision.
COST_EWMA_ALPHA = 0.2


class _CostEntry:
    __slots__ = ("ewma", "count", "wall_s", "lane_steps", "hist", "last")

    def __init__(self):
        self.ewma: Optional[float] = None   # s per lane-step
        self.count = 0                      # boundaries observed
        self.wall_s = 0.0                   # total observed chunk service s
        self.lane_steps = 0                 # total lane-steps covered
        self.hist = Histogram(LANE_STEP_BUCKETS)
        self.last: Optional[float] = None   # newest s per lane-step


class CostModel:
    """Online per-(bucket, lane-tier, dispatch-depth, kernel) chunk-cost
    EWMA.

    ``observe(bucket, lanes, depth, k, wall_s, kernel=...)`` records one
    chunk boundary's service time (``wall_s`` seconds for ``k`` steps of
    ``lanes`` lanes); the normalized unit is seconds per *lane-step* —
    the number a placement/autoscaling decision compares across buckets
    (cells/s for a bucket of side B falls out as ``B^ndim /
    s_per_lane_step``). ``kernel`` names the chunk body ("torch" — the
    plain lane step — or "cuda", the hand-written lane kernels): the two
    are different machines with different cost curves, so one EWMA must
    never average across them."""

    def __init__(self, alpha: float = COST_EWMA_ALPHA):
        self.alpha = float(alpha)
        self._entries: Dict[Tuple[str, int, int, str, str], _CostEntry] = {}
        self._lock = debug.make_lock("observatory:cost")

    def observe(self, bucket: str, lanes: int, depth: int, k: int,
                wall_s: float, kernel: str = "torch",
                placement: str = "packed") -> None:
        if wall_s < 0 or k < 1 or lanes < 1:
            return
        per = wall_s / (k * lanes)
        key = (bucket, lanes, depth, kernel, placement)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _CostEntry()
            e.ewma = (per if e.ewma is None
                      else (1 - self.alpha) * e.ewma + self.alpha * per)
            e.count += 1
            e.wall_s += wall_s
            e.lane_steps += k * lanes
            e.last = per
        e.hist.observe(per)   # histogram carries its own lock

    def estimate_s_per_lane_step(self, bucket: str, lanes: int, depth: int,
                                 kernel: str = "torch",
                                 placement: str = "packed"
                                 ) -> Optional[float]:
        with self._lock:
            e = self._entries.get((bucket, lanes, depth, kernel, placement))
            return None if e is None else e.ewma

    def estimate_request_s(self, bucket: str, lanes: int, depth: int,
                           ntime: int, kernel: str = "torch",
                           placement: str = "packed") -> Optional[float]:
        """Predicted wall for one request of ``ntime`` steps admitted to
        this (bucket, tier): its lane advances one step whenever the
        whole group does, and a group step costs ``lanes *
        s_per_lane_step`` — queue wait excluded (that is the admission
        policy's number, not the chunk program's). Semantic scheduling
        passes the PREDICTED step count here instead of the nominal one
        for ``until=steady`` admissions (scheduler._forecast_wall), so
        the forecast reflects the steps the request is expected to run."""
        per = self.estimate_s_per_lane_step(bucket, lanes, depth, kernel,
                                            placement)
        return None if per is None else per * lanes * ntime

    def snapshot(self) -> List[dict]:
        """Scrape-consistent list of per-key stats (summary()/ /metrics/
        /statusz all render from this one shape)."""
        with self._lock:
            items = list(self._entries.items())
        out = []
        for (bucket, lanes, depth, kernel, placement), e in sorted(items):
            mean = e.wall_s / e.lane_steps if e.lane_steps else None
            out.append({
                "bucket": bucket, "lanes": lanes, "depth": depth,
                "kernel": kernel, "placement": placement,
                "chunks": e.count,
                "ewma_s_per_lane_step": e.ewma,
                "mean_s_per_lane_step": mean,
                "last_s_per_lane_step": e.last,
                "p50_s_per_lane_step": e.hist.quantile(0.5),
                "p95_s_per_lane_step": e.hist.quantile(0.95),
                "wall_s": round(e.wall_s, 6),
            })
        return out


# --- (b) compile observatory -------------------------------------------------

# The structured compile log is process-wide (module singleton), not
# per-engine: the kernel builds (ops/_build) and the solo drive()
# warm-up both note here — one log answers "what did this process build
# or warm up, when, and was the build cache warm" for all of them.
COMPILE_LOG_CAPACITY = 512


class CompileLog:
    """Bounded structured log of chunk-program compiles."""

    def __init__(self, capacity: int = COMPILE_LOG_CAPACITY):
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._seen: set = set()
        self._lock = debug.make_lock("observatory:compile")
        self.programs = 0
        self.total_s = 0.0
        self.first_s = 0.0       # wall spent on first-time keys
        self.warm_s = 0.0        # wall spent re-compiling seen keys

    def note(self, label: str, k: int, seconds: float) -> dict:
        """Record one actually-performed compile (cache hits never reach
        here). ``first`` marks a (label, k) never compiled before in this
        process — a warm re-compile's wall is the persistent compile
        cache's report card."""
        key = (label, k)
        with self._lock:
            first = key not in self._seen
            self._seen.add(key)
            ev = {"label": label, "k": int(k),
                  "seconds": round(float(seconds), 6), "first": first,
                  "ts": time.perf_counter()}
            self._events.append(ev)
            self.programs += 1
            self.total_s += seconds
            if first:
                self.first_s += seconds
            else:
                self.warm_s += seconds
        return ev

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def summary(self) -> dict:
        with self._lock:
            return {"programs": self.programs,
                    "distinct": len(self._seen),
                    "total_s": round(self.total_s, 3),
                    "first_s": round(self.first_s, 3),
                    "warm_s": round(self.warm_s, 3)}


_COMPILE_LOG: Optional[CompileLog] = None
# plain: a double-checked singleton guard, held only to construct the
# log (rank observatory; nothing is taken under it)
_COMPILE_LOG_LOCK = threading.Lock()


def compile_log() -> CompileLog:
    global _COMPILE_LOG
    if _COMPILE_LOG is None:
        with _COMPILE_LOG_LOCK:
            if _COMPILE_LOG is None:
                _COMPILE_LOG = CompileLog()
    return _COMPILE_LOG


# --- (c) memory watermarks + leak sentinel -----------------------------------

def device_memory_bytes(device=None) -> Tuple[Optional[int], str]:
    """Current memory usage in bytes of the engine's ``device``, best
    source available. On a CUDA device: the caching allocator's
    ``torch.cuda.memory_stats(device)["allocated_bytes.all.current"]``
    (every live tensor's block, the lane stacks and rollback snapshots
    included), source ``"device"``. On the CPU, where the lane stacks are
    host memory: the process's resident set size from
    ``/proc/self/statm`` (a leaked lane stack stays resident, so the
    leak sentinel still sees it), source ``"rss"``. ``(None,
    "unavailable")`` when neither can be read."""
    try:
        import torch

        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            stats = torch.cuda.memory_stats(dev)
            return int(stats.get("allocated_bytes.all.current", 0)), "device"
        import os

        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE"), "rss"
    except Exception:  # noqa: BLE001 — a metering layer must never raise
        return None, "unavailable"


# Leak sentinel tuning: the window must be long enough that admission
# churn (a wave draining) shows *some* decrease, and the byte floor high
# enough that per-boundary jitter (a handle, a snapshot row) never trips
# it. A real rollback-stack or lane-grow leak adds a full lane stack per
# event — megabytes — and is strictly monotone.
MEM_WINDOW = 8
MEM_MIN_GROWTH_BYTES = 16 << 20   # 16 MiB across the window


class MemWatermark:
    """Rolling device-memory samples: peak, growth slope, leak warning."""

    def __init__(self, window: int = MEM_WINDOW,
                 min_growth_bytes: int = MEM_MIN_GROWTH_BYTES):
        self.window = max(2, int(window))
        self.min_growth = int(min_growth_bytes)
        self._samples: collections.deque = collections.deque(
            maxlen=self.window)
        self._lock = debug.make_lock("observatory:mem")
        self.peak: Optional[int] = None
        self.last: Optional[int] = None
        self.source = "unavailable"
        self.samples_taken = 0
        self.warnings = 0
        self._rearm_at: Optional[int] = None   # warn again only past this

    def note(self, nbytes: Optional[int], ts: float,
             source: str = "device") -> Optional[dict]:
        """Record one sample; returns a ``mem_watermark`` warning payload
        when the leak sentinel fires (monotone growth across the full
        window past the byte floor), else None."""
        if nbytes is None:
            return None
        with self._lock:
            self.samples_taken += 1
            self.last = int(nbytes)
            self.source = source
            if self.peak is None or nbytes > self.peak:
                self.peak = int(nbytes)
            self._samples.append((float(ts), int(nbytes)))
            if len(self._samples) < self.window:
                return None
            vals = [v for _, v in self._samples]
            growth = vals[-1] - vals[0]
            monotone = all(b > a for a, b in zip(vals, vals[1:]))
            if not monotone or growth < self.min_growth:
                return None
            if self._rearm_at is not None and vals[-1] < self._rearm_at:
                return None
            # one warning per level: re-arm only once usage doubles again,
            # so a slow leak warns at 2x, 4x, ... instead of every window
            self._rearm_at = vals[-1] * 2
            self.warnings += 1
            dt = self._samples[-1][0] - self._samples[0][0]
            return {"bytes_in_use": vals[-1], "peak_bytes": self.peak,
                    "growth_bytes": growth,
                    "window_samples": len(vals),
                    "window_s": round(dt, 3),
                    "slope_bytes_per_s": (round(growth / dt, 1)
                                          if dt > 0 else None),
                    "source": source}

    def snapshot(self) -> dict:
        with self._lock:
            return {"peak_bytes": self.peak, "last_bytes": self.last,
                    "source": self.source,
                    "samples": self.samples_taken,
                    "warnings": self.warnings}


# --- (d) per-tenant usage ledger ---------------------------------------------

# "steps" bills the steps a request ACTUALLY ran (below ntime for an
# until=steady early exit); "steps_saved" credits the steps a steady
# exit did not run — saved device time billed as saved.
# "cached" marks a solve-cache full hit: billed zero
# lane_s/steps, hit counted — on records it is a bool, in ledger cells
# it sums to the cell's hit count.
USAGE_FIELDS = ("lane_s", "steps", "chunks", "bytes_written",
                "steps_saved", "cached")


def empty_usage() -> dict:
    """The usage stamp every terminal record carries (schema-stable:
    rejected requests carry zeros, not a missing key)."""
    return {"lane_s": 0.0, "steps": 0, "chunks": 0, "bytes_written": 0,
            "steps_saved": 0, "cached": False}


class _LedgerCell:
    __slots__ = ("lane_s", "steps", "chunks", "bytes_written",
                 "steps_saved", "cached", "requests", "by_status",
                 "by_placement")

    def __init__(self):
        self.lane_s = 0.0
        self.steps = 0
        self.chunks = 0
        self.bytes_written = 0
        self.steps_saved = 0
        self.cached = 0
        self.requests = 0
        self.by_status: collections.Counter = collections.Counter()
        # placement dimension: how many of this cell's
        # requests ran as packed vmapped lanes vs mesh-spanning mega
        # lanes ("none" = rejected before placement) — a mega request
        # occupies the WHOLE mesh for its lane-seconds, so billing and
        # capacity plans need the split, not just the totals
        self.by_placement: collections.Counter = collections.Counter()

    def asdict(self) -> dict:
        return {"lane_s": round(self.lane_s, 6), "steps": self.steps,
                "chunks": self.chunks, "bytes_written": self.bytes_written,
                "steps_saved": self.steps_saved, "cached": self.cached,
                "requests": self.requests, "by_status": dict(self.by_status),
                "by_placement": dict(self.by_placement)}


class UsageLedger:
    """Aggregates the exact usage stamps the scheduler writes into each
    terminal record, per (tenant, class). Adding THE SAME values that
    land on the records is what makes ``GET /v1/usage`` reconcile
    exactly against a drained run's record stream (acceptance-tested)."""

    def __init__(self):
        self._cells: Dict[Tuple[str, str], _LedgerCell] = {}
        self._lock = debug.make_lock("observatory:ledger")

    def add(self, tenant: str, slo_class: str, status: str,
            usage: dict, placement: Optional[str] = None) -> None:
        with self._lock:
            cell = self._cells.get((tenant, slo_class))
            if cell is None:
                cell = self._cells[(tenant, slo_class)] = _LedgerCell()
            cell.lane_s += float(usage.get("lane_s") or 0.0)
            cell.steps += int(usage.get("steps") or 0)
            cell.chunks += int(usage.get("chunks") or 0)
            cell.bytes_written += int(usage.get("bytes_written") or 0)
            cell.steps_saved += int(usage.get("steps_saved") or 0)
            cell.cached += int(bool(usage.get("cached")))
            cell.requests += 1
            cell.by_status[status] += 1
            cell.by_placement[placement or "none"] += 1

    def snapshot(self) -> dict:
        """``/v1/usage`` payload: per-tenant (per-class) aggregates plus
        engine-wide totals."""
        with self._lock:
            items = [((t, c), cell.asdict())
                     for (t, c), cell in self._cells.items()]
        tenants: Dict[str, dict] = {}
        totals = _LedgerCell()
        for (tenant, cls), d in sorted(items):
            tdict = tenants.setdefault(
                tenant, {"classes": {}, "lane_s": 0.0, "steps": 0,
                         "chunks": 0, "bytes_written": 0, "steps_saved": 0,
                         "cached": 0, "requests": 0})
            tdict["classes"][cls] = d
            for f in (*USAGE_FIELDS, "requests"):
                tdict[f] = (round(tdict[f] + d[f], 6)
                            if f == "lane_s" else tdict[f] + d[f])
            totals.lane_s += d["lane_s"]
            totals.steps += d["steps"]
            totals.chunks += d["chunks"]
            totals.bytes_written += d["bytes_written"]
            totals.steps_saved += d["steps_saved"]
            totals.cached += d["cached"]
            totals.requests += d["requests"]
            totals.by_status.update(d["by_status"])
            totals.by_placement.update(d.get("by_placement") or {})
        return {"tenants": tenants, "totals": totals.asdict()}


# --- (e) SLO burn-rate monitor -----------------------------------------------

# Multiwindow burn-rate defaults (the Google-SRE shape, scaled to serve
# runs that live minutes, not months): the fast window catches an acute
# burn, the slow window keeps a blip from paging. Threshold 2.0 = the
# class is burning its error budget at twice the sustainable rate in
# BOTH windows.
SLO_FAST_WINDOW_S = 300.0
SLO_SLOW_WINDOW_S = 3600.0
SLO_BURN_THRESHOLD = 2.0
SLO_ALERT_COOLDOWN_S = 300.0


class _ClassWindow:
    __slots__ = ("events", "alerts", "last_alert_t")

    def __init__(self):
        self.events: collections.deque = collections.deque()  # (ts, ok)
        self.alerts = 0
        self.last_alert_t: Optional[float] = None


class BurnMonitor:
    """Per-class rolling deadline-hit windows -> burn-rate gauges/alerts.

    Only requests that CARRIED a deadline feed the monitor (an undated
    batch request cannot miss an SLO it never had); a hit is terminal
    status ``ok``, everything else — ``deadline``, ``nonfinite``,
    ``error`` — burns budget. Timestamps come from the engine's
    ``wall_clock`` seam so tests drive the windows deterministically."""

    def __init__(self, targets: Dict[str, float],
                 fast_window_s: float = SLO_FAST_WINDOW_S,
                 slow_window_s: float = SLO_SLOW_WINDOW_S,
                 threshold: float = SLO_BURN_THRESHOLD,
                 cooldown_s: float = SLO_ALERT_COOLDOWN_S):
        self.targets = dict(targets)
        self.fast_s = float(fast_window_s)
        self.slow_s = float(slow_window_s)
        self.threshold = float(threshold)
        self.cooldown_s = float(cooldown_s)
        self._classes: Dict[str, _ClassWindow] = {}
        self._lock = debug.make_lock("observatory:burn")

    def _budget(self, cls: str) -> float:
        target = self.targets.get(cls, 0.95)
        return max(1.0 - target, 1e-9)

    @staticmethod
    def _window_stats(events, now: float, width: float) -> Tuple[int, int]:
        lo = now - width
        n = miss = 0
        for ts, ok in events:
            if ts >= lo:
                n += 1
                if not ok:
                    miss += 1
        return n, miss

    def note(self, cls: str, ok: bool, now: float) -> Optional[dict]:
        """Record one dated request's outcome; returns an ``slo_alert``
        payload when both windows burn above threshold (cooldown-
        limited), else None."""
        with self._lock:
            w = self._classes.get(cls)
            if w is None:
                w = self._classes[cls] = _ClassWindow()
            w.events.append((float(now), bool(ok)))
            lo = now - self.slow_s
            while w.events and w.events[0][0] < lo:
                w.events.popleft()
            budget = self._budget(cls)
            n_f, m_f = self._window_stats(w.events, now, self.fast_s)
            n_s, m_s = self._window_stats(w.events, now, self.slow_s)
            fast = (m_f / n_f) / budget if n_f else 0.0
            slow = (m_s / n_s) / budget if n_s else 0.0
            if fast < self.threshold or slow < self.threshold:
                return None
            if (w.last_alert_t is not None
                    and now - w.last_alert_t < self.cooldown_s):
                return None
            w.last_alert_t = now
            w.alerts += 1
            return {"class": cls,
                    "target": self.targets.get(cls, 0.95),
                    "threshold": self.threshold,
                    "fast_burn": round(fast, 3),
                    "slow_burn": round(slow, 3),
                    "fast_window_s": self.fast_s,
                    "slow_window_s": self.slow_s,
                    "fast_events": n_f, "fast_misses": m_f,
                    "slow_events": n_s, "slow_misses": m_s}

    def snapshot(self, now: float) -> Dict[str, dict]:
        with self._lock:
            items = [(cls, list(w.events), w.alerts)
                     for cls, w in self._classes.items()]
        out = {}
        for cls, events, alerts in items:
            budget = self._budget(cls)
            n_f, m_f = self._window_stats(events, now, self.fast_s)
            n_s, m_s = self._window_stats(events, now, self.slow_s)
            out[cls] = {
                "target": self.targets.get(cls, 0.95),
                "fast_burn": round((m_f / n_f) / budget if n_f else 0.0, 4),
                "slow_burn": round((m_s / n_s) / budget if n_s else 0.0, 4),
                "fast_hit_ratio": (round(1 - m_f / n_f, 4) if n_f else None),
                "slow_hit_ratio": (round(1 - m_s / n_s, 4) if n_s else None),
                "fast_events": n_f, "slow_events": n_s,
                "alerts": alerts,
            }
        return out


# --- the per-engine facade ---------------------------------------------------

MEM_POLL_EVERY_DEFAULT = 32   # chunk boundaries between memory samples


class Observatory:
    """One engine's metering facade: the scheduler feeds it timestamps it
    already has; the gateway/statusz/summary read scrape-consistent
    snapshots. ``enabled=False`` turns every feed into an early-return
    (the baseline of the observatory-cost A/B)."""

    def __init__(self, enabled: bool = True,
                 slo_targets: Optional[Dict[str, float]] = None,
                 mem_poll_every: int = MEM_POLL_EVERY_DEFAULT,
                 slo_fast_window_s: float = SLO_FAST_WINDOW_S,
                 slo_slow_window_s: float = SLO_SLOW_WINDOW_S,
                 slo_burn_threshold: float = SLO_BURN_THRESHOLD,
                 device=None):
        self.enabled = bool(enabled)
        self.device = device          # where the lanes live (the memory
                                      # watermark's source)
        self.cost = CostModel()
        self.ledger = UsageLedger()
        self.mem = MemWatermark()
        self.burn = BurnMonitor(slo_targets or {},
                                fast_window_s=slo_fast_window_s,
                                slow_window_s=slo_slow_window_s,
                                threshold=slo_burn_threshold)
        self.mem_poll_every = int(mem_poll_every)
        self._boundaries = 0          # mem-poll cadence counter; GIL-atomic
                                      # += is fine for a sampling cadence

    # -- feeds (scheduler side) --------------------------------------------
    def observe_chunk(self, bucket: str, lanes: int, depth: int, k: int,
                      wall_s: float, kernel: str = "torch",
                      placement: str = "packed") -> None:
        if self.enabled:
            self.cost.observe(bucket, lanes, depth, k, wall_s,
                              kernel=kernel, placement=placement)

    def note_terminal(self, snap: dict, now: float) -> Optional[dict]:
        """Feed one terminal record snapshot (ledger + burn windows);
        returns an ``slo_alert`` payload or None. Called under the engine
        lock (see module doc: engine -> observatory lock order only)."""
        if not self.enabled:
            return None
        usage = snap.get("usage") or empty_usage()
        self.ledger.add(snap.get("tenant") or "default",
                        snap.get("class") or "standard",
                        snap.get("status") or "?", usage,
                        placement=snap.get("placement"))
        if (snap.get("deadline_ms") is None
                or snap.get("status") == "rejected"):
            # undated requests have no SLO to burn; rejections never ran
            # (bad request or shed — the shed counter covers overload)
            return None
        return self.burn.note(snap.get("class") or "standard",
                              snap.get("status") == "ok", now)

    def maybe_sample_memory(self, now: float,
                            force: bool = False) -> Optional[dict]:
        """Cadenced memory sample (every ``mem_poll_every`` boundaries):
        called at chunk boundaries, where the scheduler is already doing
        host bookkeeping — never inside the dispatch hot loop. Returns a
        ``mem_watermark`` warning payload when the leak sentinel fires."""
        if not self.enabled or self.mem_poll_every <= 0:
            return None
        self._boundaries += 1
        if not force and self._boundaries % self.mem_poll_every:
            return None
        nbytes, source = device_memory_bytes(self.device)
        return self.mem.note(nbytes, now, source)

    # -- snapshots (scrape side) -------------------------------------------
    def summary(self, now: float) -> dict:
        return {"cost_model": self.cost.snapshot(),
                "mem": self.mem.snapshot(),
                "slo_burn": self.burn.snapshot(now),
                "compile": compile_log().summary()}
