"""The port's models (``heat_tpu_torch.models``) against the reference's
(``heat_tpu.models``) on the same configs and the same initial fields:
the model table, the stability bound and its verdict, and the t->inf
oracle in every BC family, its refusals included. The oracle is also held
to a long serial solve, as the reference's own oracle tests hold it, and
the CLI's stability warning reads the model."""

import numpy as np
import pytest

import heat_tpu.config as ref_config
import heat_tpu.grid as ref_grid
import heat_tpu.models as ref_models
from heat_tpu_torch import config, grid, models
from heat_tpu_torch.backends import solve


def _pair(**kw):
    return config.HeatConfig(**kw), ref_config.HeatConfig(**kw)


@pytest.mark.parametrize("ndim", [2, 3])
def test_model_table_is_the_references(ndim):
    port, ref = _pair(ndim=ndim)
    got, want = models.get_model(port), ref_models.get_model(ref)
    assert (got.ndim, got.stencil_points) == (want.ndim, want.stencil_points)
    assert got.stability_limit() == want.stability_limit()
    assert models.MODELS[ndim] == (models.Heat2D if ndim == 2
                                   else models.Heat3D)
    assert sorted(models.MODELS) == sorted(ref_models.MODELS)


@pytest.mark.parametrize("ndim,sigma", [
    (2, 0.25), (2, 0.25 + 5e-13), (2, 0.2500001), (2, 0.3),
    (3, 1 / 6), (3, 1 / 6 + 5e-13), (3, 0.17), (3, 0.25)])
def test_is_stable_matches_the_reference(ndim, sigma):
    port, ref = _pair(ndim=ndim, sigma=sigma)
    assert models.get_model(port).is_stable(port) == \
        ref_models.get_model(ref).is_stable(ref)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("bc,ic,bc_value", [
    ("ghost", "hat", 1.0), ("ghost", "hat", 2.5),
    ("periodic", "hat", 1.0), ("periodic", "hat_small", 1.0),
    ("edges", "uniform", 1.0), ("edges", "hat", 3.0)])
def test_steady_state_matches_the_reference(ndim, bc, ic, bc_value):
    kw = dict(n=11, ndim=ndim, bc=bc, ic=ic, bc_value=bc_value,
              dtype="float64")
    port, ref = _pair(**kw)
    T0 = grid.initial_condition(port)
    np.testing.assert_array_equal(T0, np.asarray(ref_grid.initial_condition(ref)))
    got = models.get_model(port).steady_state(port, T0)
    want = ref_models.get_model(ref).steady_state(ref, T0)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bc", ["periodic", "edges"])
def test_steady_state_needs_the_initial_field(bc):
    port, ref = _pair(n=9, bc=bc)
    with pytest.raises(ValueError) as got:
        models.get_model(port).steady_state(port)
    with pytest.raises(ValueError) as want:
        ref_models.get_model(ref).steady_state(ref)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ndim", [2, 3])
def test_non_uniform_ring_is_refused_like_the_reference(ndim):
    port, ref = _pair(n=9, ndim=ndim, bc="edges")
    ramp = np.linspace(0.0, 1.0, 9 ** ndim).reshape((9,) * ndim)
    with pytest.raises(NotImplementedError) as got:
        models.get_model(port).steady_state(port, ramp)
    with pytest.raises(NotImplementedError) as want:
        ref_models.get_model(ref).steady_state(ref, ramp)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bc,ic", [("ghost", "hat"), ("edges", "uniform")])
def test_steady_state_is_the_long_solves_limit(bc, ic):
    cfg = config.HeatConfig(n=9, ntime=4000, dtype="float64", ic=ic, bc=bc,
                            backend="serial")
    T0 = grid.initial_condition(cfg)
    res = solve(cfg)
    np.testing.assert_allclose(
        res.T, models.get_model(cfg).steady_state(cfg, T0), atol=1e-6)


@pytest.mark.parametrize("ndim,sigma,warns", [
    (2, 0.25, False), (2, 0.26, True), (3, 1 / 6, False), (3, 0.25, True)])
def test_cli_warning_reads_the_model(ndim, sigma, warns, capsys):
    import heat_tpu.cli as ref_cli
    from heat_tpu_torch import cli

    port, ref = _pair(ndim=ndim, sigma=sigma)
    cli._warn_if_unstable(port)
    got = capsys.readouterr().out
    ref_cli._warn_if_unstable(ref)
    want = capsys.readouterr().out
    assert got == want
    assert ("WARNING: sigma=" in got) == warns
