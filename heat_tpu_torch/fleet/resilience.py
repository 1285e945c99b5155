"""Fleet resilience primitives: per-backend circuit breakers and the
SRE-style retry budget (``heat_tpu.fleet.resilience``'s contract).

Retry-on-alternate alone covers only never-admitted batches, and a
flapping backend would trigger recovery/steal thrash on every down edge.
This module holds the two stateful primitives the resilience layer hangs
off:

:class:`Breaker` — one closed/open/half-open state machine per backend,
fed by probe transitions, relay/connect errors, and sustained SLO burn.
An OPEN breaker excludes its backend from placement and from steal
thief/victim selection; after a cooldown it becomes HALF-OPEN, and
re-admission is gated on the sine-canary probe (serve/probe.py) passing
*through the router path* — a backend that answers /healthz but returns
wrong bytes stays out. Each failed canary doubles the cooldown (capped),
so a persistently sick backend is probed ever more rarely.

:class:`RetryBudget` — retries capped as a fraction of successes (the
SRE book's overload chapter): the bucket starts full, every delivered
success refills ``ratio`` tokens (capped), every retry hop spends one.
When the bucket is dry the router stops amplifying overload and sheds
with a structured record instead of re-dispatching.

Both carry their own lock of rank ``fleet`` — the rank of the router's
and the registry's locks, so (two same-rank locks never nest) every call
into them is made while holding no other fleet lock. Pure state machines:
no I/O, no threads; the router owns the clock and the canary."""

from __future__ import annotations

import random
import threading
from typing import List, Optional, Tuple

# /metrics gauge encoding (heat_tpu_fleet_breaker_state{backend=...})
CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class Breaker:
    """Circuit breaker for one backend.

    closed --(trip: consecutive errors / loss / sustained burn)--> open
    open --(cooldown elapsed)--> half-open (single canary in flight)
    half-open --(router-path canary passes)--> closed
    half-open --(canary fails)--> open, cooldown doubled (capped)
    """

    TRIP_THRESHOLD = 3      # consecutive relay/connect/probe errors
    BURN_TRIP_TICKS = 8     # consecutive burn-demoted health ticks
    COOLDOWN_MAX_S = 120.0

    def __init__(self, backend: str, trip_threshold: int = TRIP_THRESHOLD,
                 cooldown_s: float = 5.0,
                 burn_trip_ticks: int = BURN_TRIP_TICKS):
        self.backend = backend
        self.trip_threshold = max(1, int(trip_threshold))
        self.base_cooldown_s = float(cooldown_s)
        self.burn_trip_ticks = max(1, int(burn_trip_ticks))
        self._lock = threading.Lock()   # rank: fleet
        self.state = CLOSED
        self.consecutive_errors = 0
        self.burn_ticks = 0
        self.cooldown_s = float(cooldown_s)
        self.opened_t = 0.0          # monotonic stamp of the last open
        self.last_transition_t = 0.0  # any state change (steal thrash guard)
        self.last_reason = ""
        self.transitions = 0
        self.canary_inflight = False

    # --- feeds (router calls these holding no other fleet lock) ----------
    def note_success(self) -> None:
        """A relay batch fully delivered / a probe passed while closed."""
        with self._lock:
            if self.state == CLOSED:
                self.consecutive_errors = 0

    def note_error(self, reason: str, now: float) -> Optional[str]:
        """A connect error, non-200, mid-stream break, or failed probe.
        Returns the new state name iff this error tripped the breaker."""
        with self._lock:
            if self.state != CLOSED:
                return None
            self.consecutive_errors += 1
            if self.consecutive_errors < self.trip_threshold:
                return None
            return self._open(reason, now)

    def trip(self, reason: str, now: float) -> Optional[str]:
        """Hard trip (backend lost / recovery started): open immediately
        regardless of the error count. Returns new state iff changed."""
        with self._lock:
            if self.state == OPEN:
                return None
            return self._open(reason, now)

    def note_burn(self, demoted: bool, now: float) -> Optional[str]:
        """One health tick's burn verdict: ``burn_trip_ticks`` consecutive
        demoted ticks trip the breaker (sustained SLO burn = sick backend,
        not a blip). Returns new state iff this tick tripped it."""
        with self._lock:
            if not demoted:
                self.burn_ticks = 0
                return None
            self.burn_ticks += 1
            if self.state != CLOSED or self.burn_ticks < self.burn_trip_ticks:
                return None
            return self._open("slo-burn", now)

    def _open(self, reason: str, now: float) -> str:
        # caller holds self._lock
        self.state = OPEN
        self.opened_t = now
        self.last_transition_t = now
        self.last_reason = reason
        self.transitions += 1
        self.canary_inflight = False
        return OPEN

    # --- half-open admission ---------------------------------------------
    def try_half_open(self, now: float) -> bool:
        """If open and the cooldown has elapsed, move to half-open and
        claim the single canary slot (True = caller must run the canary).
        At most one canary is in flight per breaker."""
        with self._lock:
            if self.state == OPEN and now - self.opened_t >= self.cooldown_s:
                self.state = HALF_OPEN
                self.last_transition_t = now
                self.transitions += 1
                self.canary_inflight = True
                return True
            return False

    def canary_result(self, ok: bool, now: float) -> str:
        """Fold the router-path canary verdict in. Pass -> closed (error
        and burn counters reset, cooldown restored to base). Fail ->
        back to open with the cooldown doubled (capped)."""
        with self._lock:
            self.canary_inflight = False
            if ok:
                self.state = CLOSED
                self.consecutive_errors = 0
                self.burn_ticks = 0
                self.cooldown_s = self.base_cooldown_s
                self.last_reason = "canary-pass"
            else:
                self.state = OPEN
                self.opened_t = now
                self.cooldown_s = min(self.COOLDOWN_MAX_S,
                                      self.cooldown_s * 2)
                self.last_reason = "canary-fail"
            self.last_transition_t = now
            self.transitions += 1
            return self.state

    # --- reads -------------------------------------------------------------
    def allows(self) -> bool:
        """May the router place NEW work here? Only when closed —
        half-open admits exactly the canary, nothing else."""
        with self._lock:
            return self.state == CLOSED

    def snapshot(self) -> dict:
        with self._lock:
            return {"backend": self.backend, "state": self.state,
                    "code": STATE_CODES[self.state],
                    "consecutive_errors": self.consecutive_errors,
                    "burn_ticks": self.burn_ticks,
                    "cooldown_s": self.cooldown_s,
                    "last_reason": self.last_reason,
                    "last_transition_t": self.last_transition_t,
                    "transitions": self.transitions}


class RetryBudget:
    """Fleet-wide retry budget: retries as a bounded fraction of
    successes. ``take()`` spends one token per retry HOP (not per row —
    a batch re-dispatch is one decision); ``credit()`` refills ``ratio``
    tokens per delivered success, capped at ``cap``. Dry bucket -> the
    router sheds instead of re-dispatching (never amplifies overload)."""

    def __init__(self, cap: float = 20.0, ratio: float = 0.2):
        self.cap = float(cap)
        self.ratio = float(ratio)
        self._lock = threading.Lock()   # rank: fleet
        self.tokens = float(cap)
        self.taken = 0
        self.denied = 0

    def take(self) -> bool:
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                self.taken += 1
                return True
            self.denied += 1
            return False

    def credit(self, n: int = 1) -> None:
        with self._lock:
            self.tokens = min(self.cap, self.tokens + self.ratio * n)

    def snapshot(self) -> dict:
        with self._lock:
            return {"tokens": self.tokens, "cap": self.cap,
                    "ratio": self.ratio, "taken": self.taken,
                    "denied": self.denied}


def backoff_s(hop: int, base_s: float = 0.05, cap_s: float = 2.0,
              rng: Optional[random.Random] = None) -> float:
    """Jittered exponential backoff before re-placement: full jitter on
    ``min(cap, base * 2**hop)`` (AWS-style — decorrelates retry herds
    without a coordination channel)."""
    r = rng.random() if rng is not None else random.random()
    return min(cap_s, base_s * (2.0 ** max(0, hop))) * (0.5 + 0.5 * r)


def breaker_rows(breakers: List[Breaker]) -> List[Tuple[str, dict]]:
    """(name, snapshot) rows sorted by backend name — the one shape
    /metrics, /statusz, and the fleet summary all render from."""
    return sorted(((b.backend, b.snapshot()) for b in breakers),
                  key=lambda kv: kv[0])
