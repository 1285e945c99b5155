"""Pluggable placement policies for the fleet router (the contract of
``heat_tpu.fleet.placement``).

Every function here is a pure function of :class:`~.registry.Backend`
snapshots (their last ``GET /v1/status`` payloads plus the router-local
pending accounting) and one request's parsed config — no sockets, no
clocks, no globals — so the policy unit tests feed fake status payloads
and assert on the math (tests/test_torch_fleet_placement.py).

The default ``least-loaded`` policy ranks candidates by **predicted
backlog seconds**: the status payload's queued + running step sums plus
the router's own not-yet-acknowledged pending steps, converted to
seconds with the backend's online cost model (work-weighted EWMA
s/lane-step across its observed rows; a cold backend falls back to a
prior so relative comparison still works before any chunk has been
timed). On top of that ranking:

- **burn-aware demotion**: a backend whose fast AND slow SLO burn
  windows both exceed 1.0 for any class (the multiwindow alert
  condition, Google SRE workbook) is demoted — it only receives work
  when every candidate is demoted, so a burning replica gets headroom
  to recover instead of more load;
- **mega routing**: a request whose side overflows a backend's buckets
  is only placed on backends advertising mega capability (the engine's
  two-tier split lifted one level: sharded mega-lanes);
- **starvation-free round-robin tiebreak**: equal-backlog candidates
  (the cold-fleet case: everyone at zero) rotate through a monotone
  router counter instead of always picking the first, so no backend
  starves while scores tie.

``round-robin`` skips the scoring entirely (health + capability filter,
then rotate) — the A/B baseline and the "my cost model is lying to me"
escape hatch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

POLICIES = ("least-loaded", "round-robin")

# Cold-start prior: seconds per lane-step before a backend has timed a
# single chunk. The absolute value barely matters (placement compares
# backends, and cold backends all share it); it just has to be finite
# and positive so queued work on a cold backend still counts.
PRIOR_S_PER_LANE_STEP = 1e-5

# Two backlog predictions within this relative band tie (floats from
# independently-scraped payloads are never bit-equal).
TIE_REL = 0.05

BURN_THRESHOLD = 1.0


def s_per_lane_step(status: Optional[dict]) -> float:
    """Work-weighted mean EWMA s/lane-step across the backend's observed
    cost-model rows; the prior when it has observed nothing. Every row
    counts whatever its ``kernel`` label (the port's ``cuda``/``torch``,
    the reference's ``pallas``/``xla``), so no decision depends on it."""
    rows = (status or {}).get("cost_model") or []
    num = den = 0.0
    for e in rows:
        ew = e.get("ewma_s_per_lane_step")
        chunks = e.get("chunks") or 0
        if ew and chunks:
            num += float(ew) * int(chunks)
            den += int(chunks)
    return (num / den) if den else PRIOR_S_PER_LANE_STEP


def backlog_steps(backend) -> int:
    """Queued + running + router-pending work, in steps."""
    bl = ((backend.status or {}).get("backlog")) or {}
    return (int(bl.get("queued_steps") or 0)
            + int(bl.get("running_steps_bound") or 0)
            + int(backend.pending_steps))


def predicted_backlog_s(backend) -> float:
    """The least-loaded score: cost model x queue work, in seconds."""
    return backlog_steps(backend) * s_per_lane_step(backend.status)


def burn_demoted(status: Optional[dict],
                 threshold: float = BURN_THRESHOLD) -> bool:
    """True when any SLO class burns its error budget in BOTH windows —
    the multiwindow alert condition, used here as a placement demotion
    instead of (only) a page."""
    for b in ((status or {}).get("slo_burn") or {}).values():
        fast = b.get("fast_burn")
        slow = b.get("slow_burn")
        if (fast is not None and slow is not None
                and fast > threshold and slow > threshold):
            return True
    return False


def brownout_level(backends: List) -> int:
    """Fleet-wide brownout level for edge shedding (router dispatch).

    0 — some eligible backend is not burn-demoted: normal placement
    (demotion steers work away from the burning replicas) handles it.
    1 — EVERY eligible backend's fast AND slow burn windows fire: the
    edge sheds ``batch`` rows with Retry-After instead of placing them
    anyway (the old all-demoted passthrough behaviour for that class).
    2 — additionally the worst fast burn is at double threshold: shed
    ``standard`` too. ``interactive`` is never shed by brownout.

    Pure function of the backend snapshots so tests feed fake status
    payloads and assert the ladder directly."""
    cands = [b for b in backends
             if b.healthy and not b.fault_down and not b.lost]
    if not cands or not all(burn_demoted(b.status) for b in cands):
        return 0
    worst = 0.0
    for b in cands:
        for w in ((b.status or {}).get("slo_burn") or {}).values():
            fast = w.get("fast_burn")
            if fast is not None:
                worst = max(worst, float(fast))
    return 2 if worst >= 2 * BURN_THRESHOLD else 1


def can_serve(backend, n: Optional[int]) -> bool:
    """Capability filter: can this backend serve a side-``n`` request?
    Oversized-for-its-buckets requests need mega capability. A backend
    with no status payload yet is assumed capable (the cold-fleet case;
    the engine rejects structurally-unservable requests itself)."""
    if n is None or backend.status is None:
        return True
    mega = backend.status.get("mega") or {}
    max_bucket = int(mega.get("max_bucket") or 0)
    if max_bucket and n <= max_bucket:
        return True
    return bool(mega.get("capable"))


def eligible(backends: List, n: Optional[int]) -> List:
    """Health + capability filter shared by every policy."""
    return [b for b in backends
            if b.healthy and not b.fault_down and not b.lost
            and can_serve(b, n)]


def choose(policy: str, backends: List, n: Optional[int],
           rr_index: int, prefer=None) -> Tuple[Optional[object], Dict]:
    """Pick a backend for one side-``n`` request. Returns
    ``(backend | None, decision)`` where ``decision`` is a small dict
    for tracing/statusz (scores, who was demoted, why None).

    ``prefer`` is an optional set of backend names that should win when
    any of them is eligible — the solve-cache placement hint (a prefix
    hit wants the backend that can actually consume the cached
    frontier). A preference never overrides health/capability: when no
    preferred backend is eligible the full pool competes as usual."""
    if policy not in POLICIES:
        raise ValueError(f"unknown placement policy {policy!r}; "
                         f"known: {POLICIES}")
    cands = eligible(backends, n)
    if not cands:
        return None, {"policy": policy, "reason": "no-eligible-backend",
                      "n": n}
    preferred = False
    if prefer:
        narrowed = [b for b in cands if b.name in prefer]
        if narrowed:
            cands, preferred = narrowed, True
    if policy == "round-robin":
        b = cands[rr_index % len(cands)]
        return b, {"policy": policy, "backend": b.name,
                   **({"preferred": True} if preferred else {})}
    demoted = [b.name for b in cands if burn_demoted(b.status)]
    pool = [b for b in cands if b.name not in demoted] or cands
    scores = {b.name: predicted_backlog_s(b) for b in pool}
    best = min(scores.values())
    tied = [b for b in pool
            if scores[b.name] <= best + TIE_REL * max(best, 1e-9)]
    b = tied[rr_index % len(tied)]
    return b, {"policy": policy, "backend": b.name,
               "backlog_s": {k: round(v, 6) for k, v in scores.items()},
               "demoted": demoted,
               **({"preferred": True} if preferred else {})}
