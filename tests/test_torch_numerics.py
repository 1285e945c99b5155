"""The port's numerics observatory and convergence predictor against heat_tpu's.

``heat_tpu_torch.runtime.numerics`` / ``convergence`` are copies of the
reference's modules (pure host math). The same stats sequences go through
both observatories and must give the same event lists, snapshots and
totals; the predictors must give the same numbers. The cases mirror
``tests/test_numerics.py``'s observatory tests (envelope tolerance,
fire-once latching, heat-jump arming, non-finite stats ignored, steady only
with steps remaining) and ``tests/test_steady.py``'s predictor tests, plus
seeded random sequences.
"""

import math

import numpy as np
import pytest

from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.runtime import convergence as jconv
from heat_tpu.runtime import numerics as jnum
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.runtime import convergence as conv
from heat_tpu_torch.runtime import numerics as num


def _pair(steady_tol):
    return (num.NumericsObservatory(steady_tol=steady_tol),
            jnum.NumericsObservatory(steady_tol=steady_tol))


def _both(obs, method, *args, **kw):
    """Call ``method`` on both observatories; they must answer alike."""
    got = getattr(obs[0], method)(*args, **kw)
    want = getattr(obs[1], method)(*args, **kw)
    assert got == want, (method, args, kw)
    return got


def _snapshots_agree(obs):
    a, b = obs[0].snapshot(), obs[1].snapshot()
    assert a.keys() == b.keys()
    assert a["lanes"].keys() == b["lanes"].keys()
    for rid in a["lanes"]:
        for k, v in a["lanes"][rid].items():
            w = b["lanes"][rid][k]
            assert (v == w) or (isinstance(v, float) and math.isnan(v)
                                and math.isnan(w)), (rid, k, v, w)
    for k in ("steady_tol", "steady_total", "violation_total"):
        assert a[k] == b[k]


def test_constants_are_the_reference():
    assert num.ENVELOPE_TOL == jnum.ENVELOPE_TOL
    assert num.EWMA_ALPHA == jnum.EWMA_ALPHA
    assert num.HEAT_JUMP_FACTOR == jnum.HEAT_JUMP_FACTOR
    assert num.HEAT_JUMP_FLOOR_FRAC == jnum.HEAT_JUMP_FLOOR_FRAC
    assert conv.OBS_RATE_ALPHA == jconv.OBS_RATE_ALPHA
    assert conv.OBS_FULL_WEIGHT_SAMPLES == jconv.OBS_FULL_WEIGHT_SAMPLES


def test_envelope_tolerance_is_dtype_and_scale_aware():
    obs = _pair(1e-12)
    _both(obs, "admit", "r", lo=0.0, hi=2.0, dtype="bfloat16")
    assert _both(obs, "observe", "r", resid=0.1, tmin=0.0, tmax=2.05,
                 heat=10.0, remaining=5) == []
    (ev,) = _both(obs, "observe", "r", resid=0.1, tmin=0.0, tmax=2.3,
                  heat=10.0, remaining=4)
    assert ev["kind"] == "violation" and ev["why"] == "max-principle"
    for dtype in ("float32", "float64"):
        _both(obs, "admit", dtype, lo=1.0, hi=3.0, dtype=dtype)
        _both(obs, "observe", dtype, 0.1, 1.0 - 2e-4, 3.0, 1.0, 9)
    _snapshots_agree(obs)


def test_violation_latches_once_per_request():
    obs = _pair(1e-12)
    _both(obs, "admit", "r", lo=1.0, hi=2.0, dtype="float32")
    assert len(_both(obs, "observe", "r", resid=0.1, tmin=0.5, tmax=2.0,
                     heat=1.0, remaining=9)) == 1
    assert _both(obs, "observe", "r", resid=0.1, tmin=0.4, tmax=2.0,
                 heat=1.0, remaining=8) == []
    assert obs[0].violation_total == obs[1].violation_total == 1
    _snapshots_agree(obs)


def test_heat_jump_armed_after_two_boundaries():
    obs = _pair(1e-30)
    _both(obs, "admit", "r", lo=-1e9, hi=1e9, dtype="float32")
    events = [_both(obs, "observe", "r", resid=1.0, tmin=0.0, tmax=1.0,
                    heat=h, remaining=99)
              for h in (100.0, 99.5, 99.0, 60.0)]
    assert events[:3] == [[], [], []]
    (ev,) = events[3]
    assert ev["why"] == "heat-jump" and ev["heat_prev"] == 99.0
    _snapshots_agree(obs)


def test_nonfinite_stats_and_unknown_lanes_are_ignored():
    obs = _pair(1e-12)
    assert _both(obs, "observe", "ghost-of-a-request", 0.0, 0.0, 1.0, 1.0,
                 5) == []
    _both(obs, "admit", "r", lo=0.0, hi=1.0, dtype="float32")
    for bad in ((float("nan"), 0.0, 99.0, 1.0), (0.1, float("-inf"), 1.0,
                                                 1.0),
                (0.1, 0.0, 1.0, float("inf"))):
        assert _both(obs, "observe", "r", *bad, remaining=5) == []
    assert obs[0].snapshot()["lanes"]["r"]["boundaries"] == 0
    _snapshots_agree(obs)


def test_steady_fires_once_and_only_with_steps_remaining():
    obs = _pair(1e-6)
    _both(obs, "admit", "r", lo=0.0, hi=1.0, dtype="float32")
    (ev,) = _both(obs, "observe", "r", resid=0.0, tmin=0.0, tmax=1.0,
                  heat=1.0, remaining=5)
    assert ev["kind"] == "steady" and ev["steady_tol"] == 1e-6
    assert _both(obs, "observe", "r", 0.0, 0.0, 1.0, 1.0, 4) == []
    _both(obs, "admit", "s", lo=0.0, hi=1.0, dtype="float32")
    assert _both(obs, "observe", "s", 0.0, 0.0, 1.0, 1.0, 0) == []
    # a per-request tolerance overrides the engine's
    _both(obs, "admit", "t", lo=0.0, hi=1.0, dtype="float32",
          steady_tol=1e-1)
    (ev,) = _both(obs, "observe", "t", 0.05, 0.0, 1.0, 1.0, 3)
    assert ev["steady_tol"] == 1e-1
    _snapshots_agree(obs)
    _both(obs, "forget", "r")
    _both(obs, "forget", "r")
    _snapshots_agree(obs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_stats_sequences_agree(seed):
    """Seeded sequences of decaying residuals with jumps, excursions,
    NaNs and tail chunks: every event list, ETA and snapshot equal, and
    export_state / reseed round-trip the same way."""
    rng = np.random.default_rng(seed)
    obs = _pair(float(10.0 ** rng.uniform(-8, -3)))
    ids = [f"r{i}" for i in range(4)]
    for i, rid in enumerate(ids):
        _both(obs, "admit", rid, lo=1.0, hi=2.0,
              dtype=("float32", "bfloat16", "float64", "float32")[i],
              steady_tol=None if i % 2 else float(rng.uniform(1e-6, 1e-3)),
              log_rate=(None, -0.01, -0.1, 0.0)[i])
    rem = {rid: 400 for rid in ids}
    resid = {rid: 0.1 for rid in ids}
    heat = {rid: 1000.0 for rid in ids}
    for _ in range(40):
        for rid in ids:
            rem[rid] = max(0, rem[rid] - int(rng.choice((16, 4))))
            resid[rid] *= float(rng.uniform(0.3, 0.99))
            heat[rid] -= float(rng.uniform(0, 2))
            r, lo, hi, h = resid[rid], 1.0, 2.0, heat[rid]
            u = rng.uniform()
            if u < 0.03:
                r = float("nan")
            elif u < 0.06:
                hi = 2.5
            elif u < 0.09:
                h = heat[rid] * 0.5
            _both(obs, "observe", rid, r, lo, hi, h, rem[rid])
            _both(obs, "eta_steps", rid)
    _snapshots_agree(obs)
    for rid in ids:
        state = _both(obs, "export_state", rid)
        _both(obs, "admit", rid + "-again", lo=1.0, hi=2.0, dtype="float32")
        _both(obs, "reseed", rid + "-again", state)
        _both(obs, "eta_steps", rid + "-again")
    _snapshots_agree(obs)


# --- the predictor -----------------------------------------------------------


CFGS = [dict(n=12, ntime=160, ic="sine", bc="edges"),
        dict(n=200, ntime=4000, ic="hat", bc="ghost", bc_value=1.0),
        dict(n=64, ntime=300, ndim=3, sigma=0.15, ic="hat_half"),
        dict(n=50, ntime=900, sigma=0.3, ic="uniform"),   # past CFL
        dict(n=1000, ntime=8000, sigma=0.1, ic="hat_small", bc="edges",
             dtype="bfloat16")]


@pytest.mark.parametrize("kw", CFGS)
@pytest.mark.parametrize("tol", [1e-3, 1e-5, 1e-9])
def test_admission_prediction_is_the_reference(kw, tol):
    cfg, jcfg = HeatConfig(**kw), JHeatConfig(**kw)
    assert conv.closed_form_log_rate(cfg) == jconv.closed_form_log_rate(jcfg)
    assert (conv.predict_admission_steps(cfg, tol)
            == jconv.predict_admission_steps(jcfg, tol))


def test_predict_steps_to_tol_and_fuser_are_the_reference():
    for args in ((1.0, 1e-3, -0.1), (1e-4, 1e-3, -0.1), (1.0, 1e-3, None),
                 (1.0, 1e-3, 0.0), (0.0, 1e-3, -0.1), (1.0, 0.0, -0.1),
                 (None, 1e-3, -0.1), (2.5, 1e-7, -0.0137)):
        assert (conv.predict_steps_to_tol(*args)
                == jconv.predict_steps_to_tol(*args))
    rng = np.random.default_rng(7)
    for closed in (None, -0.02):
        a, b = conv.RateFuser(closed), jconv.RateFuser(closed)
        rem, r = 1000, 1.0
        for _ in range(12):
            rem -= int(rng.choice((16, 4, 0)))
            r *= float(rng.uniform(0.2, 1.2))
            a.observe(r, rem)
            b.observe(r, rem)
            assert a.fused_log_rate() == b.fused_log_rate()
        assert a.export_state() == b.export_state()
