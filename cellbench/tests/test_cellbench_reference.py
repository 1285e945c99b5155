"""The plain reference against hand-worked cases and a loop over cells."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

PATH = Path(__file__).resolve().parents[1] / "reference" / "ftcs2d.py"


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ftcs2d_reference", PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_coefficient_is_sigma(ref):
    # r = nu * dt / delta^2 with dt = sigma * delta^2 / nu: sigma again
    assert ref.coefficient(4096, 0.25, 0.05, 2.0) == pytest.approx(0.25, rel=1e-15)
    assert ref.coefficient(32768, 0.25, 0.05, 1.0) == pytest.approx(0.25, rel=1e-15)


def test_edges_by_hand(ref):
    # a cross of ones around a cold centre: the centre takes
    # 0 + 0.25 * (1 + 1 + 1 + 1 - 4 * 0) = 1; the ring stays
    T = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    out = ref.edges(T, 0.25, 1)
    want = T.clone()
    want[1, 1] = 1.0
    assert torch.equal(out, want)
    # the second step: the centre reads the same ring, 1 + 0.25 * (4 - 4) = 1
    assert torch.equal(ref.edges(T, 0.25, 2), want)
    assert T[1, 1] == 0.0   # the input is not written


def test_ghost_by_hand(ref):
    # 2x2 cold cells inside ghosts at 1: each cell has two ghosts and two
    # cells; step 1: 0 + 0.25 * (2 - 0) = 0.5; step 2:
    # 0.5 + 0.25 * (1 + 1 + 0.5 + 0.5 - 4 * 0.5) = 0.75
    T = torch.zeros(2, 2)
    assert torch.equal(ref.ghost(T, 0.25, 1.0, 1), torch.full((2, 2), 0.5))
    assert torch.equal(ref.ghost(T, 0.25, 1.0, 2), torch.full((2, 2), 0.75))


def _loop(T, r, steps):
    """Cell by cell in float64, the outermost ring kept: the update as the
    upstream writes it."""
    T = np.array(T, dtype=np.float64)
    for _ in range(steps):
        old = T.copy()
        n0, n1 = T.shape
        for j in range(1, n0 - 1):
            for k in range(1, n1 - 1):
                T[j, k] = old[j, k] + r * (old[j + 1, k] + old[j, k + 1]
                                           + old[j - 1, k] + old[j, k - 1]
                                           - 4 * old[j, k])
    return T


@pytest.mark.parametrize("bc", ["edges", "ghost"])
def test_against_a_loop_over_cells(ref, bc):
    rng = np.random.default_rng(5)
    T = rng.uniform(0.5, 1.5, size=(9, 7))
    r, steps = ref.coefficient(9, 0.25, 0.05, 2.0), 6
    if bc == "edges":
        want = _loop(T, r, steps)
        got = ref.edges(torch.from_numpy(T), r, steps)
    else:
        want = _loop(np.pad(T, 1, constant_values=1.0), r, steps)[1:-1, 1:-1]
        got = ref.ghost(torch.from_numpy(T), r, 1.0, steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


def test_batch_of_fields(ref):
    # leading dimensions are fields stepped each on its own
    rng = np.random.default_rng(6)
    X = torch.from_numpy(rng.uniform(size=(3, 8, 8)).astype(np.float32))
    got = ref.edges(X, 0.25, 5)
    for i in range(3):
        assert torch.equal(got[i], ref.edges(X[i], 0.25, 5))


def test_run_reads_the_configuration(ref):
    cfg = {"n": 6, "sigma": 0.25, "nu": 0.05, "dom_len": 2.0, "bc": "ghost",
           "bc_value": 1.0}
    T = torch.zeros(6, 6)
    assert torch.equal(ref.run(cfg, T, 3), ref.ghost(T, ref.coefficient(6, 0.25, 0.05, 2.0), 1.0, 3))
    with pytest.raises(ValueError):
        ref.run(dict(cfg, bc="periodic"), T, 1)
