"""heat_tpu_torch's 3D stencil surface against heat_tpu's K3.

On the CPU the cuda wrappers run ``ftcs3d``'s plain PyTorch version
(``ftcs_multistep_3d_plain``); the reference's K3 (``_pallas_3d_aligned``,
through the public ``ftcs_multistep_*_pallas`` wrappers) runs in Pallas
interpret mode, as heat_tpu's own tests run it. Same inputs (numpy,
seeded), bytes compared. r = 1/6 and 0.15 are where the K3 body's two
fused multiply-adds show: ``s - 6*band`` and the masked update each round
once, and every other form differs in the last bit there. The kernel itself
is compared with the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_card.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat_tpu.ops import pallas_stencil as ps
from heat_tpu_torch.ops import cuda_stencil as cs

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default of one thread per core in each worker starves the rest.
torch.set_num_threads(1)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_SHAPES = [(24, 20, 130), (20, 17, 33)]


def _field(shape, seed=0):
    return np.random.default_rng(seed).uniform(1, 2, shape).astype(np.float32)


def _port(T, dtype):
    return torch.from_numpy(T).to(_TORCH[dtype])


def _ref(T, dtype):
    return jnp.asarray(T).astype(_JNP[dtype])


def _ndiff(got: torch.Tensor, ref) -> int:
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape
    return int((got.view(np.uint32) != ref.view(np.uint32)).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [1 / 6, 0.15, 0.1])
@pytest.mark.parametrize("k", [1, 5, 8, 20])
@pytest.mark.parametrize("shape", _SHAPES)
def test_plain_matches_k3_edges(shape, k, r, dtype):
    T = _field(shape, seed=k)
    ref = ps.ftcs_multistep_edges_pallas(_ref(T, dtype), r, k)
    assert _ndiff(cs.ftcs_multistep_edges_cuda(_port(T, dtype), r, k), ref) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [5, 20])
def test_plain_matches_k3_ghost(k, dtype):
    T = _field(_SHAPES[0], seed=11)
    ref = ps.ftcs_multistep_ghost_pallas(_ref(T, dtype), 0.15, 1.0, k)
    got = cs.ftcs_multistep_ghost_cuda(_port(T, dtype), 0.15, 1.0, k)
    assert _ndiff(got, ref) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [5, 20])
def test_plain_matches_k3_periodic(k, dtype):
    """k=20 wrap-pads 16 then 4 (the reference's 3D cap), and the 16-wide
    chunk runs in the passes planned for the padded shape."""
    T = _field(_SHAPES[0], seed=13)
    ref = ps.ftcs_multistep_periodic_pallas(_ref(T, dtype), 1 / 6, k)
    got = cs.ftcs_multistep_periodic_cuda(_port(T, dtype), 1 / 6, k)
    assert _ndiff(got, ref) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_k3_bounded(dtype):
    """Custom 6-value bounds that leave the low row edge unfrozen: the
    caller's discard margin there is k=3 rows (garbage in both, made
    differently); every other cell agrees, and frozen cells keep their
    values exactly."""
    T = _field(_SHAPES[0], seed=17)
    b = (-5, 19, 2, 17, 5, 124)
    ref = ps.ftcs_multistep_bounded_pallas(_ref(T, dtype), 0.15, 3,
                                           jnp.asarray(b, jnp.int32))
    got = cs.ftcs_multistep_bounded_cuda(_port(T, dtype), 0.15, 3, b)
    assert _ndiff(got[3:], ref[3:]) == 0
    frozen = np.ones(T.shape, bool)
    frozen[:19, 3:17, 6:124] = False
    keep = _port(T, dtype).float().numpy()[frozen]
    np.testing.assert_array_equal(got.float().numpy()[frozen], keep)


def _pass_variant(T: torch.Tensor, r: float, k: int, lap_fma: bool,
                  update_fma: bool) -> torch.Tensor:
    """The plain 3D pass with either fused multiply-add replaced by its
    two-rounding form."""
    band = T.to(torch.float32)
    maskr = cs._maskr(T.shape, cs._default_bounds(T.shape), r, T.device)
    for _ in range(k):
        s = torch.roll(band, -1, 0) + torch.roll(band, 1, 0)
        s = s + torch.roll(band, -1, 1)
        s = s + torch.roll(band, 1, 1)
        s = s + torch.roll(band, 1, 2)
        s = s + torch.roll(band, -1, 2)
        lap = cs._fma_f32(-6.0, band, s) if lap_fma else s - 6.0 * band
        band = (cs._fma_f32(maskr, lap, band) if update_fma
                else band + maskr * lap)
    return band.to(T.dtype)


@pytest.mark.parametrize("lap_fma,update_fma",
                         [(False, False), (True, False), (False, True)])
def test_k3_contracts_both_roundings(lap_fma, update_fma):
    """Each form without both FMAs differs from K3 at r = 1/6 (thousands of
    cells), while the form with both is the plain version: the contraction
    of the reference's compiled body stays pinned."""
    T = _field(_SHAPES[0], seed=23)
    ref = ps.ftcs_multistep_edges_pallas(_ref(T, "float32"), 1 / 6, 1)
    both = _pass_variant(_port(T, "float32"), 1 / 6, 1, True, True)
    assert _ndiff(both, ref) == 0
    other = _pass_variant(_port(T, "float32"), 1 / 6, 1, lap_fma, update_fma)
    assert _ndiff(other, ref) > 100


@pytest.mark.parametrize("bc", ["edges", "ghost", "periodic"])
def test_one_step_wrappers_match_pallas_3d(bc):
    T = _field((14, 11, 19), seed=29)
    r = 0.15
    got = {"edges": lambda t: cs.ftcs_step_edges_cuda(t, r),
           "ghost": lambda t: cs.ftcs_step_ghost_cuda(t, r, 1.0),
           "periodic": lambda t: cs.ftcs_step_periodic_cuda(t, r),
           }[bc](torch.from_numpy(T))
    want = {"edges": lambda t: ps.ftcs_step_edges_pallas(t, r),
            "ghost": lambda t: ps.ftcs_step_ghost_pallas(t, r, 1.0),
            "periodic": lambda t: ps.ftcs_step_periodic_pallas(t, r),
            }[bc](jnp.asarray(T))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(24, 20, 130), (9, 9, 9), (4, 4, 40000),
                                   (67, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_kernel_available_is_pallas_available(shape, dtype):
    want = ps.pallas_available(shape, _JNP.get(dtype, jnp.float64))
    assert cs.kernel_available(shape, getattr(torch, dtype)) == want


@pytest.mark.parametrize("shape,k", [((24, 20, 130), 5), ((24, 20, 130), 40),
                                     ((5, 30, 30), 40), ((67, 130), 40)])
def test_periodic_pad_width_is_the_reference(shape, k):
    assert cs.periodic_pad_width(shape, k) == ps.periodic_pad_width(shape, k)


def test_3d_without_a_plan_takes_the_plain_step():
    """Where the reference's planner has no 3D plan, the edges wrapper takes
    the plain step (the reference takes the XLA step); the bounded wrapper,
    which has no step to fall back on, refuses."""
    T = torch.from_numpy(_field((4, 4, 40000), seed=31))
    got = cs.ftcs_multistep_edges_cuda(T, 0.15, 2)
    want = cs.ftcs_step_edges(cs.ftcs_step_edges(T, 0.15), 0.15)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        cs.ftcs_multistep_bounded_cuda(T, 0.15, 1, (0, 3, 0, 3, 0, 39999))
    with pytest.raises(ValueError):  # 3D bounds are six values
        cs.ftcs_multistep_bounded_cuda(T[:, :, :20], 0.15, 1, (0, 3, 0, 3))


def test_pass_bound_3d():
    """The 3D bound: the field read and written once over the HBM rate,
    against 9 f32 operations per cell-step over the f32 rate."""
    from heat_tpu_torch.machine import PEAKS, DeviceModel

    dm = DeviceModel("NVIDIA H100 80GB HBM3", 132, None, None, 0, PEAKS["H100"])
    t, by = dm.pass_bound_s(512**3, 4, 8, ndim=3)
    assert by == "bytes" and t == pytest.approx(2 * 4 * 512**3 / 3.35e12)
    t, by = dm.pass_bound_s(512**3, 2, 16, ndim=3)
    assert by == "operations" and t == pytest.approx(9 * 16 * 512**3 / 67e12)
    assert dm.pass_bound_s(4096**2, 4, 16) == dm.pass_bound_s(4096**2, 4, 16,
                                                              ndim=2)

