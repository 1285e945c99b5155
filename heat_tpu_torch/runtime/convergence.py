"""Convergence prediction: eigenmode decay fused with observed residual slope.

A copy of ``heat_tpu.runtime.convergence`` (pure host math), on the port's
config and grid.

Semantic scheduling needs to know, per lane, *when* the residual EWMA
will cross the steady tolerance — before it happens.  Two signals are
available for free:

- **Closed form.** Under FTCS with ``bc="edges"`` the slowest surviving
  eigenmode decays by ``lambda = 1 - 4*ndim*r*sin^2(pi/(2*(n-1)))`` per
  step (LeVeque; ``grid.sine_decay_factor``).  Asymptotically every
  smooth initial condition converges at this rate, so it is a usable
  prior from the moment of admission — zero observations required.
- **Observed slope.** Each chunk boundary carries the lane's interior
  residual in the (6, L) boundary vector; consecutive residuals
  ``steps`` apart give a measured per-step log-slope.  Early on the
  observed slope is *steeper* than the closed form (higher modes are
  still dying), so it corrects the prior where the prior is pessimistic.

``RateFuser`` blends the two: the observed slope is EWMA-smoothed and
confidence-weighted by sample count, ramping from pure closed form (no
observations) to pure observation (``OBS_FULL_WEIGHT_SAMPLES`` boundary
deltas seen).  Everything here is pure host math on Python floats — no
device work, no locks (the numerics observatory serializes calls under
its own lock), no new transfers.
"""

from __future__ import annotations

import math
from typing import Optional

from ..config import HeatConfig
from ..grid import ic_envelope, sine_decay_factor

# EWMA smoothing for the observed per-step log-slope.  Matches the
# residual EWMA alpha in runtime/numerics.py so the two estimates track
# the same effective window.
OBS_RATE_ALPHA = 0.35

# Observed-slope confidence ramps linearly from 0 to 1 over this many
# boundary-to-boundary deltas; past it the closed form is fully faded.
OBS_FULL_WEIGHT_SAMPLES = 4


def closed_form_log_rate(cfg: HeatConfig) -> Optional[float]:
    """Per-step log decay rate of the slowest eigenmode, or ``None``
    when the closed form does not predict decay (unstable ``r``, or a
    regime where ``lambda`` leaves ``(0, 1)`` and the mode oscillates)."""
    lam = sine_decay_factor(cfg)
    if 0.0 < lam < 1.0:
        return math.log(lam)
    return None


class RateFuser:
    """Per-lane fused residual decay-rate estimate.

    ``observe()`` once per chunk boundary with the raw residual and the
    remaining-step count (the step delta between observations is
    ``prev_remaining - remaining``, so variable chunk sizes — tail
    chunks — are handled for free).  ``fused_log_rate()`` returns the
    current best per-step log-rate, negative when the lane is decaying.
    """

    __slots__ = ("closed", "obs", "samples", "_last_resid", "_last_remaining")

    def __init__(self, closed: Optional[float]):
        self.closed = closed
        self.obs: Optional[float] = None
        self.samples = 0
        self._last_resid: Optional[float] = None
        self._last_remaining: Optional[int] = None

    def observe(self, resid: float, remaining: int) -> None:
        if (self._last_resid is not None and self._last_remaining is not None):
            steps = self._last_remaining - int(remaining)
            if steps > 0 and resid > 0.0 and self._last_resid > 0.0:
                rate = math.log(resid / self._last_resid) / steps
                if math.isfinite(rate):
                    if self.obs is None:
                        self.obs = rate
                    else:
                        self.obs = (OBS_RATE_ALPHA * rate
                                    + (1.0 - OBS_RATE_ALPHA) * self.obs)
                    self.samples += 1
        self._last_resid = float(resid)
        self._last_remaining = int(remaining)

    def fused_log_rate(self) -> Optional[float]:
        if self.obs is None or self.samples <= 0:
            return self.closed
        if self.closed is None:
            return self.obs
        w = min(1.0, self.samples / float(OBS_FULL_WEIGHT_SAMPLES))
        return w * self.obs + (1.0 - w) * self.closed

    # --- engine-state checkpoint / resume (serve --resume) ----------------
    # ``closed`` is NOT exported: it is recomputed from the config at
    # re-admission (deterministic), so only the observed half travels.
    def export_state(self) -> dict:
        return {"obs": self.obs, "samples": self.samples,
                "last_resid": self._last_resid,
                "last_remaining": self._last_remaining}

    def reseed(self, state: dict) -> None:
        self.obs = (None if state.get("obs") is None
                    else float(state["obs"]))
        self.samples = int(state.get("samples") or 0)
        lr = state.get("last_resid")
        self._last_resid = None if lr is None else float(lr)
        lrem = state.get("last_remaining")
        self._last_remaining = None if lrem is None else int(lrem)


def predict_steps_to_tol(resid: float, tol: float,
                         log_rate: Optional[float]) -> Optional[int]:
    """Steps until a residual decaying at ``log_rate`` per step drops
    from ``resid`` below ``tol``; ``None`` when no finite prediction
    exists (non-decaying rate, non-positive inputs)."""
    if resid is None or not (resid > 0.0) or not (tol > 0.0):
        return None
    if resid <= tol:
        return 0
    if log_rate is None or log_rate >= 0.0:
        return None
    return int(math.ceil(math.log(tol / resid) / log_rate))


def predict_admission_steps(cfg: HeatConfig, tol: float) -> Optional[int]:
    """Closed-form predicted retirement step at admission time — before
    a single boundary has been observed.

    The per-step residual of a mode with amplitude ``A`` decaying at
    ``lambda`` is ``(1 - lambda) * lambda**(s-1) * A``, so the first
    residual is ``(1 - lambda) * A`` with ``A`` bounded by the analytic
    IC envelope (``grid.ic_envelope`` — no host field materialized).
    The result is clamped to ``[0, ntime]``: a prediction past the
    nominal step count means "no early exit expected".
    """
    log_rate = closed_form_log_rate(cfg)
    if log_rate is None or not (tol > 0.0):
        return None
    lam = math.exp(log_rate)
    lo, hi = ic_envelope(cfg)
    amp = max(abs(hi), abs(lo), abs(hi - lo))
    r0 = (1.0 - lam) * amp
    s = predict_steps_to_tol(r0, tol, log_rate)
    if s is None:
        return None
    return min(int(cfg.ntime), max(0, s))
