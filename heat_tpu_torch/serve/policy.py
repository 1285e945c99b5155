"""Pluggable admission policies for the serving engine.

A copy of ``heat_tpu.serve.policy``'s queues (pure Python): the scheduler
stops caring about ordering, the queue decides who is admitted next.

- ``fifo`` — a deque: pop in submit order. The default.
- ``edf`` — earliest-deadline-first *within* an SLO class, classes in
  priority order (``config.SLO_CLASSES``: interactive < standard < batch).
  Requests without a deadline sort after every dated request of their
  class; submit order breaks ties, so ``edf`` degrades to ``fifo`` when
  nobody sets deadlines.
- ``fair`` — weighted fair share *across tenants* (virtual time: each
  tenant accumulates served work divided by its weight; the next admission
  goes to the backlogged tenant with the least normalized service),
  EDF-within-class *inside* each tenant. A tenant returning from idle is
  raised to the current virtual time, so it cannot hoard credit.

Thread-safety contract: queue objects are NOT internally locked — every
push/pop happens under the engine's one lock (scheduler.py).

The Prometheus-shaped ``Histogram`` the gateway's ``/metrics`` exports
(per-class latency, queue depth) lives in ``runtime/prof.py``; it is
re-exported here, as the reference does.
"""

from __future__ import annotations

import collections
import heapq
import math
from typing import Dict, List, Optional, Tuple

from ..config import SLO_CLASSES
from ..runtime.prof import (DEPTH_BUCKETS, LATENCY_BUCKETS,  # noqa: F401
                            Histogram)

POLICIES = ("fifo", "edf", "fair")


def _predicted_rank(req) -> float:
    """Predicted-finish rank: an ``until=steady`` request with a
    closed-form eigenmode ETA (``Request.predicted_steps``,
    runtime/convergence.py) ranks by that predicted step count —
    shortest-predicted-job-first among otherwise equal peers. Fixed-step
    requests (and steady requests without a finite prediction) rank
    ``+inf``, so classes first, earliest deadline, FIFO among undated
    peers stay as they were."""
    pred = getattr(req, "predicted_steps", None)
    if getattr(req, "until", "steps") != "steady" or pred is None:
        return math.inf
    return float(pred)


def _edf_key(req) -> Tuple[int, float, float, int]:
    """(class priority, deadline, predicted finish, submit seq): classes
    strictly first, earliest absolute deadline inside a class, then the
    predicted-finish rank (``_predicted_rank``: +inf unless an until=steady
    request carries an ETA), FIFO among the rest (deadline +inf).
    ``req.seq`` is the engine-wide submit counter, so the ordering is
    total and deterministic."""
    deadline = req.deadline_t if req.deadline_t is not None else math.inf
    return (SLO_CLASSES.get(req.slo_class, max(SLO_CLASSES.values())),
            deadline, _predicted_rank(req), req.seq)


class FifoQueue:
    """Pop in submit order."""

    def __init__(self):
        self._q = collections.deque()

    def push(self, req) -> None:
        self._q.append(req)

    def pop(self):
        return self._q.popleft() if self._q else None

    def items(self) -> List:
        """Non-destructive snapshot of every queued request (engine-state
        checkpointing reads the queue without disturbing pop order)."""
        return list(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


class EdfQueue:
    """Class-priority + earliest-deadline-first heap (see module doc)."""

    def __init__(self):
        self._h: List[Tuple[Tuple[int, float, float, int], object]] = []

    def push(self, req) -> None:
        heapq.heappush(self._h, (_edf_key(req), req))

    def pop(self):
        return heapq.heappop(self._h)[1] if self._h else None

    def items(self) -> List:
        """Snapshot of queued requests (heap order, not pop order — a
        resume pushes them again, which re-sorts)."""
        return [entry[1] for entry in self._h]

    def __len__(self) -> int:
        return len(self._h)

    def __bool__(self) -> bool:
        return bool(self._h)


class FairShareQueue:
    """Weighted fair share across tenants, EDF-within-class per tenant.

    Virtual-time WFQ over request *work* (``points * steps``): popping a
    tenant's request advances that tenant's virtual time by
    ``work / weight``; the next pop serves the backlogged tenant with the
    smallest virtual time (tenant name breaks exact ties). A tenant whose
    queue just went non-empty is raised to the minimum active virtual time.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._weights = dict(weights or {})
        self._tenants: Dict[str, List] = {}   # tenant -> EDF heap
        self._vtime: Dict[str, float] = {}
        self._count = 0

    def _weight(self, tenant: str) -> float:
        return float(self._weights.get(tenant, 1.0))

    def push(self, req) -> None:
        h = self._tenants.get(req.tenant)
        if h is None:
            h = self._tenants[req.tenant] = []
        if not h:
            # idle -> backlogged: catch up to the busiest floor
            active = [self._vtime[t] for t, q in self._tenants.items()
                      if q and t != req.tenant]
            floor = min(active) if active else 0.0
            self._vtime[req.tenant] = max(
                self._vtime.get(req.tenant, 0.0), floor)
        heapq.heappush(h, (_edf_key(req), req))
        self._count += 1

    def pop(self):
        live = [(self._vtime[t], t) for t, h in self._tenants.items() if h]
        if not live:
            return None
        _, tenant = min(live)
        req = heapq.heappop(self._tenants[tenant])[1]
        self._count -= 1
        # fair share charges PREDICTED work where a prediction exists (an
        # until=steady request is expected to stop early — billing nominal
        # steps would under-schedule its tenant)
        steps = req.cfg.ntime
        pred = getattr(req, "predicted_steps", None)
        if getattr(req, "until", "steps") == "steady" and pred is not None:
            steps = min(steps, pred)
        work = float(req.cfg.points * max(steps, 1))
        self._vtime[tenant] += work / self._weight(tenant)
        return req

    def items(self) -> List:
        """Snapshot of every tenant's queued requests (unordered; a resume
        pushes them again. Virtual-time credit is not part of it: a
        resumed engine restarts every tenant at vtime 0)."""
        return [entry[1] for h in self._tenants.values() for entry in h]

    def __len__(self) -> int:
        return self._count

    def __bool__(self) -> bool:
        return self._count > 0


# --- admission tracing (runtime/trace.py) ------------------------------------
# Queue objects stay trace-free; the scheduler calls these at its push/pop
# sites: an ``enqueue`` instant per push and an id-paired ``queue-wait``
# span per pop, per tenant track.

def note_enqueue(tracer, policy: str, req) -> None:
    tracer.instant("enqueue", tracer.track("queue", req.tenant),
                   cat="queue", trace_id=req.trace_id,
                   args={"id": req.id, "policy": policy,
                         "class": req.slo_class}, ts=req.submit_t)


def note_pop(tracer, policy: str, req, now: float) -> None:
    tracer.async_span("queue-wait", tracer.track("queue", req.tenant),
                      req.submit_t, now, req.trace_id,
                      args={"id": req.id, "policy": policy,
                            "tenant": req.tenant, "class": req.slo_class})


def make_queue(policy: str, tenant_weights=()):
    """One admission queue for one bucket group under ``policy``."""
    if policy == "fifo":
        return FifoQueue()
    if policy == "edf":
        return EdfQueue()
    if policy == "fair":
        return FairShareQueue(dict(tenant_weights))
    raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
