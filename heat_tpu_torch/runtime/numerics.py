"""Numerics observatory: per-lane solution-quality telemetry.

A copy of ``heat_tpu.runtime.numerics``. It watches the quality of the PDE
solution a serving lane sells, from the four per-lane statistics the lane
kernels (``ops/cuda_lanes``: ``lanes2d``/``lanes3d``, and their plain
versions) fuse into every chunk's boundary vector
(``serve/engine.BOUNDARY_ROWS`` rows 2-5: final-mini-step residual
``max|ΔT|``, request-region min/max, total heat ``ΣT``), so watching costs
no device pass and no transfer. The scheduler feeds each fetched boundary
here; this class owns the MATH (EWMAs, detector thresholds, fire-once
state) and returns event dicts; all POLICY — structured records, the
``--numerics-guard`` quarantine routing, counters — stays in the
scheduler.

Three detectors per lane:

- **steady state** — the residual EWMA sits below the request's steady
  tolerance (per-request ``tol`` override, else ``--steady-tol``) while
  steps remain: the lane is burning chip on an already-converged field.
  Fires ONCE per request, so long converged jobs cannot log-storm. For
  ``until=steady`` requests the scheduler ACTS on this event — the lane
  retires at its dispatch frontier; for fixed-step requests it stays
  observability-only.
- **discrete maximum principle** — under the CFL bound each FTCS update
  is a convex combination of old values, so request-region values may
  never escape ``[min(IC, bc), max(IC, bc)]`` (LeVeque's classic
  finite-difference analysis; see PAPERS.md). The region min/max are
  exact witnesses; escape beyond a dtype-aware rounding allowance means
  a mis-set ``r`` past the CFL bound, dtype drift, a soft error, or an
  injected ``perturb`` fault.
- **heat-content jump** — total heat under Dirichlet walls changes only
  by boundary flux, chunk over chunk a smooth decay; a discontinuous
  jump (vs an EWMA of recent per-chunk deltas) is the signature of a
  corrupted field that max-principle tolerance might still admit.
  Best-effort by design (heat is NOT conserved here — flux through the
  walls is physics, not a fault), armed only after two observations.

Thread-safety/lock-ordering contract: one small private lock (a plain
``threading.Lock``), and this module NEVER takes the engine lock — the
scheduler calls in (engine -> numerics order only), and readers of
``snapshot()`` hold the numerics lock alone.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional

from . import convergence

# Dtype-aware maximum-principle allowance, RELATIVE to the envelope
# scale: per-step storage rounding can push a convex combination
# epsilon past the envelope, so the witness tolerance must cover
# accumulated rounding without masking real escapes. bfloat16 carries
# ~8 mantissa bits (eps ~ 3.9e-3) and drifts visibly over a chunk;
# float32/float64 stay near machine epsilon.
ENVELOPE_TOL = {"float64": 1e-9, "float32": 1e-4, "bfloat16": 5e-2}

# Residual-EWMA smoothing: ~5-chunk memory — fast enough that a freshly
# loaded lane's transient clears in a few boundaries, slow enough that
# one noisy chunk cannot fake convergence.
EWMA_ALPHA = 0.35

# Heat-jump detector: fires when one chunk's |Δheat| exceeds this many
# times the EWMA of recent deltas (floored at a fraction of the heat
# scale so a fully-steady lane's zero EWMA cannot turn jitter into an
# alarm). Deliberately loose — Dirichlet flux is physics.
HEAT_JUMP_FACTOR = 50.0
HEAT_JUMP_FLOOR_FRAC = 1e-3


@dataclasses.dataclass
class _LaneState:
    """Per-request detector state, admitted at lane fill and dropped at
    the request's terminal record (every path: ok, quarantine, fail)."""

    lo: float                   # envelope min(IC, bc)
    hi: float                   # envelope max(IC, bc)
    tol: float                  # dtype-aware envelope allowance
    resid_ewma: Optional[float] = None
    heat: Optional[float] = None        # last observed ΣT
    dheat_ewma: Optional[float] = None  # EWMA of |Δheat| per chunk
    steady_fired: bool = False
    violated: bool = False
    boundaries: int = 0
    last_resid: float = float("nan")
    last_min: float = float("nan")
    last_max: float = float("nan")
    # semantic scheduling: per-request steady tolerance
    # override (None -> the engine-wide --steady-tol; distinct from
    # ``tol`` above, which is the ENVELOPE allowance) and the fused
    # eigenmode/observed decay-rate estimator feeding ETA prediction.
    steady_tol: Optional[float] = None
    fuser: Optional[convergence.RateFuser] = None


class NumericsObservatory:
    """Ingests per-lane boundary stats; returns detector events.

    ``observe`` returns a list of event dicts (usually empty — one
    comparison and an EWMA update per lane per boundary): ``{"kind":
    "steady", ...}`` once per converged request, ``{"kind":
    "violation", "why": "max-principle" | "heat-jump", ...}`` on
    detector escape. The scheduler owns what happens next."""

    def __init__(self, steady_tol: float):
        self.steady_tol = float(steady_tol)
        self._lock = threading.Lock()
        self._lanes: Dict[str, _LaneState] = {}
        self.steady_total = 0
        self.violation_total = 0

    # --- lifecycle --------------------------------------------------------
    def admit(self, req_id: str, lo: float, hi: float, dtype: str,
              steady_tol: Optional[float] = None,
              log_rate: Optional[float] = None) -> None:
        """Arm the detectors for one request: the maximum-principle
        envelope is [min(IC, bc), max(IC, bc)] — analytic
        (``grid.ic_envelope``), so admission costs zero device work. ``steady_tol`` overrides
        the engine-wide tolerance for this request (client ``tol``);
        ``log_rate`` is the closed-form eigenmode log decay rate the
        ETA fuser starts from (``convergence.closed_form_log_rate``)."""
        lo, hi = float(lo), float(hi)
        scale = max(abs(lo), abs(hi), 1.0)
        tol = ENVELOPE_TOL.get(dtype, ENVELOPE_TOL["float32"]) * scale
        with self._lock:
            self._lanes[req_id] = _LaneState(
                lo=lo, hi=hi, tol=tol,
                steady_tol=None if steady_tol is None else float(steady_tol),
                fuser=convergence.RateFuser(log_rate))

    def forget(self, req_id: str) -> None:
        """Drop a request's state (terminal record — any status)."""
        with self._lock:
            self._lanes.pop(req_id, None)

    # --- ingestion --------------------------------------------------------
    def observe(self, req_id: str, resid: float, tmin: float, tmax: float,
                heat: float, remaining: int) -> List[dict]:
        """One fetched boundary's stats for one lane -> detector events.

        Non-finite stats are ignored outright: the finite bit on the
        same boundary row already routes that lane to the nonfinite
        path, and NaN would poison the EWMAs of a lane about to be
        rolled back."""
        events: List[dict] = []
        with self._lock:
            st = self._lanes.get(req_id)
            if st is None or not all(map(math.isfinite,
                                         (resid, tmin, tmax, heat))):
                return events
            st.boundaries += 1
            st.last_resid, st.last_min, st.last_max = resid, tmin, tmax
            if st.fuser is not None:
                st.fuser.observe(resid, remaining)
            st.resid_ewma = (resid if st.resid_ewma is None else
                             EWMA_ALPHA * resid
                             + (1.0 - EWMA_ALPHA) * st.resid_ewma)
            # maximum principle: witnesses may not escape the envelope
            if not st.violated and (tmin < st.lo - st.tol
                                    or tmax > st.hi + st.tol):
                st.violated = True  # one violation verdict per request
                self.violation_total += 1
                events.append({
                    "kind": "violation", "why": "max-principle",
                    "tmin": tmin, "tmax": tmax, "lo": st.lo, "hi": st.hi,
                    "tol": st.tol})
            # heat jump: armed after two boundaries (need a delta EWMA)
            if st.heat is not None:
                dheat = abs(heat - st.heat)
                if st.dheat_ewma is not None and not st.violated:
                    floor = HEAT_JUMP_FLOOR_FRAC * max(abs(st.heat), 1.0)
                    if dheat > HEAT_JUMP_FACTOR * max(st.dheat_ewma, floor):
                        st.violated = True
                        self.violation_total += 1
                        events.append({
                            "kind": "violation", "why": "heat-jump",
                            "heat": heat, "heat_prev": st.heat,
                            "dheat": dheat, "dheat_ewma": st.dheat_ewma})
                st.dheat_ewma = (dheat if st.dheat_ewma is None else
                                 EWMA_ALPHA * dheat
                                 + (1.0 - EWMA_ALPHA) * st.dheat_ewma)
            st.heat = heat
            # steady state: converged but still burning steps (fire once)
            eff_tol = (self.steady_tol if st.steady_tol is None
                       else st.steady_tol)
            if (not st.steady_fired and remaining > 0
                    and st.resid_ewma < eff_tol):
                st.steady_fired = True
                self.steady_total += 1
                events.append({
                    "kind": "steady", "resid": resid,
                    "resid_ewma": st.resid_ewma,
                    "steady_tol": eff_tol})
        return events

    # --- detector state out and back in ----------------------------------
    def export_state(self, req_id: str) -> Optional[dict]:
        """JSON-safe detector state for one in-flight request, as the
        reference's engine checkpoint captures it at a chunk-boundary cut
        (the port has no engine checkpoint yet). The envelope
        (lo/hi/tol) and the closed-form rate are NOT exported — both are
        recomputed deterministically at re-admission; only the observed
        history (EWMAs, fire-once flags, rate samples) travels."""
        with self._lock:
            st = self._lanes.get(req_id)
            if st is None:
                return None
            return {"resid_ewma": st.resid_ewma, "heat": st.heat,
                    "dheat_ewma": st.dheat_ewma,
                    "steady_fired": st.steady_fired,
                    "violated": st.violated,
                    "boundaries": st.boundaries,
                    "last_resid": st.last_resid,
                    "last_min": st.last_min, "last_max": st.last_max,
                    "fuser": (None if st.fuser is None
                              else st.fuser.export_state())}

    def reseed(self, req_id: str, state: Optional[dict]) -> None:
        """Restore exported detector state over a fresh ``admit`` (call
        admit first: it re-arms envelope/tolerance/closed-form rate).
        The EWMAs continue where the killed engine left them, so a
        resumed ``until=steady`` lane retires on accumulated evidence
        instead of re-warming from scratch — and an already-fired
        steady flag stays fired (no duplicate steady_state record)."""
        if not state:
            return
        with self._lock:
            st = self._lanes.get(req_id)
            if st is None:
                return
            if state.get("resid_ewma") is not None:
                st.resid_ewma = float(state["resid_ewma"])
            if state.get("heat") is not None:
                st.heat = float(state["heat"])
            if state.get("dheat_ewma") is not None:
                st.dheat_ewma = float(state["dheat_ewma"])
            st.steady_fired = bool(state.get("steady_fired", False))
            st.violated = bool(state.get("violated", False))
            st.boundaries = int(state.get("boundaries") or 0)
            for k in ("last_resid", "last_min", "last_max"):
                if state.get(k) is not None:
                    setattr(st, k, float(state[k]))
            if st.fuser is not None and state.get("fuser"):
                st.fuser.reseed(state["fuser"])

    # --- prediction (semantic scheduling) ---------------------------------
    def _eta_locked(self, st: _LaneState) -> Optional[int]:
        """Predicted steps until this lane's residual EWMA crosses its
        effective steady tolerance (fused eigenmode + observed slope);
        None before the first boundary or when no decay is predicted.
        Caller holds the numerics lock."""
        if st.fuser is None or st.resid_ewma is None:
            return None
        eff_tol = self.steady_tol if st.steady_tol is None else st.steady_tol
        return convergence.predict_steps_to_tol(
            st.resid_ewma, eff_tol, st.fuser.fused_log_rate())

    def eta_steps(self, req_id: str) -> Optional[int]:
        """Predicted remaining steps to steady for one request, for the
        scheduler's tail sizing. Takes only
        the numerics lock (engine -> numerics order preserved)."""
        with self._lock:
            st = self._lanes.get(req_id)
            return None if st is None else self._eta_locked(st)

    # --- export surface ----------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time view: per-lane latest stats plus the monotone
        totals. Takes only the numerics lock."""
        with self._lock:
            lanes = {
                rid: {"resid": st.last_resid,
                      "resid_ewma": st.resid_ewma,
                      "heat": st.heat,
                      "tmin": st.last_min, "tmax": st.last_max,
                      "lo": st.lo, "hi": st.hi,
                      "steady": st.steady_fired,
                      "violated": st.violated,
                      "boundaries": st.boundaries,
                      "steady_tol": (self.steady_tol if st.steady_tol is None
                                     else st.steady_tol),
                      "eta_steps": self._eta_locked(st)}
                for rid, st in self._lanes.items()}
            return {"steady_tol": self.steady_tol,
                    "steady_total": self.steady_total,
                    "violation_total": self.violation_total,
                    "lanes": lanes}
