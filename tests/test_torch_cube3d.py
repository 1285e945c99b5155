"""The 3D deployment's solve on the port's normal path against the
benchmark's plain 3D reference, on the CPU: ``backends.solve`` with the
``cuda`` backend and ``device="cpu"`` (the kernels' plain versions, in
the passes the card's ``ftcs3d`` runs) from the benchmark's seeded fields
(``cellbench/harness/ic.py``), against ``cellbench/reference/ftcs3d.py``.

The limit, ``TOL``: the fields start in [0.5, 1.5), where an f32 unit in
the last place is 6e-8 to 1.2e-7. The kernel contracts two products into
fused multiply-adds and the reference rounds each operation, so they part
by about an ulp a step, and the diffusion averages those partings rather
than adding them up: at most 4.8e-7 over these cases (four ulps at 1.0,
at 99 steps). ``TOL`` is about 20 times that. The program's bf16 path
(an ulp of 4e-3 at 1.0) and either planted fault (one shell cell
updated; r off by one part in 1e4, a change of 1.7e-5 times the
Laplacian in the first step alone) lie far above it."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu_torch import backends
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.ops import cuda_stencil, pass_schedule

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cellbench.harness import ic  # noqa: E402

TOL = 1e-5
IC = {"kind": "seeded_uniform", "lo": 0.5, "span": 1.0}
SEED = 2 ** 31 + 25
# 43 and 99 steps cross several passes and end on a partial one at each
# size's pass depth: 4 at 24³, 5 at 33³, and 8 at 64³ as at 512³
SIZES = (24, 33, 64)
STEPS = (43, 99)
SIGMAS = (1 / 6, 0.15, 0.1)


@pytest.fixture(scope="module")
def ref():
    path = ROOT / "cellbench" / "reference" / "ftcs3d.py"
    spec = importlib.util.spec_from_file_location("ftcs3d_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gap(ref, n, sigma, steps, dtype="float32", index=0):
    """The widest gap between the program's final field and the
    reference's, from seeded field ``index``."""
    cfg = HeatConfig(n=n, ndim=3, ntime=steps, sigma=sigma, backend="cuda",
                     dtype=dtype)
    T0 = ic.field(IC, SEED, index, n, 3)
    got = backends.solve(cfg, T0=T0.numpy(), device="cpu").T
    want = ref.run({"n": n, "sigma": sigma, "nu": cfg.nu,
                    "dom_len": cfg.dom_len, "bc": "edges"}, T0, steps)
    return float((torch.from_numpy(np.asarray(got)) - want).abs().max())


@pytest.mark.parametrize("n", SIZES)
def test_the_steps_cross_passes_and_end_on_a_partial_one(n):
    for steps in STEPS:
        passes = pass_schedule.passes((n, n, n), torch.float32, steps)
        depth = max(passes)
        assert len(passes) > 2 and sum(passes) == steps
        assert steps % depth != 0
    assert max(pass_schedule.passes((64,) * 3, torch.float32, 99)) == 8


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("sigma", SIGMAS, ids=["sixth", "0.15", "0.1"])
@pytest.mark.parametrize("n", SIZES)
def test_program_agrees_with_the_reference(ref, n, sigma, steps):
    gap = _gap(ref, n, sigma, steps, index=steps)
    assert gap <= TOL


@pytest.mark.parametrize("n", SIZES)
def test_bf16_path_fails_the_limit(ref, n):
    assert _gap(ref, n, 1 / 6, 43, dtype="bfloat16") > 10 * TOL


def _plant(monkeypatch, how):
    real = cuda_stencil._pass

    def broken(T, r, ksteps, bounds, out=None, plain=False):
        if how == "r":
            return real(T, r * (1 + 1e-4), ksteps, bounds, out=out,
                        plain=plain)
        res = real(T, r, ksteps, bounds, out=out, plain=plain)
        # one cell of the shell's low face takes an FTCS update from its
        # five neighbours in the field, the sixth read as itself
        j = k = T.shape[-1] // 2
        c = T[0, j, k].float()
        lap = (T[1, j, k] + T[0, j + 1, k] + T[0, j - 1, k]
               + T[0, j, k + 1] + T[0, j, k - 1]).float() - 5 * c
        res[0, j, k] = (c + r * lap).to(res.dtype)
        return res

    monkeypatch.setattr(cuda_stencil, "_pass", broken)


@pytest.mark.parametrize("how", ["shell", "r"])
@pytest.mark.parametrize("n", (24, 64))
def test_planted_faults_fail_the_limit(ref, monkeypatch, n, how):
    _plant(monkeypatch, how)
    assert _gap(ref, n, 1 / 6, 43) > TOL


def test_the_reference_by_hand(ref):
    # a cold centre among six warm neighbours: 0 + r * (6 - 0) = 1 at
    # r = 1/6; the shell, every other cell of a 3³ cube, keeps its values
    T = torch.zeros(3, 3, 3)
    for d in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        T[d] = 1.0
    out = ref.edges(T, 1 / 6, 1)
    want = T.clone()
    want[1, 1, 1] = 6 * (1 / 6)
    assert torch.allclose(out, want, rtol=0, atol=1e-7)
    assert T[1, 1, 1] == 0.0   # the input is not written
    with pytest.raises(ValueError):
        ref.run({"n": 3, "sigma": 0.1, "nu": 0.05, "dom_len": 2.0,
                 "bc": "ghost"}, T, 1)
