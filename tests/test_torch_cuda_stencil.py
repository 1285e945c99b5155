"""heat_tpu_torch.ops.cuda_stencil against heat_tpu's Pallas kernels.

On the CPU the cuda wrappers run their kernel's plain PyTorch version
(``ftcs_multistep_2d_plain``); the reference's K1 (``_pallas_2d`` via the
public wrappers) and K2 (``_pallas_2d_coltiled``) run in Pallas interpret
mode, as heat_tpu's own tests run them. Same inputs (numpy, seeded), bytes
compared. r=0.2 and r=0.1 are the cases that show the single-rounding
update: at r=0.25 the product is exact and any rounding order agrees.
The kernel itself is compared with the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_card.py``.
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


def _field(shape, seed=0):
    return np.random.default_rng(seed).uniform(1, 2, shape).astype(np.float32)


def _port(T, dtype):
    return torch.from_numpy(T).to(_TORCH[dtype])


def _ref(T, dtype):
    return jnp.asarray(T).astype(_JNP[dtype])


def _bytes_equal(got: torch.Tensor, ref) -> None:
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape
    ndiff = int((got.view(np.uint32) != ref.view(np.uint32)).sum())
    assert ndiff == 0, f"{ndiff} of {got.size} cells differ"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [0.25, 0.2, 0.1])
@pytest.mark.parametrize("k", [1, 5, 16, 40])
def test_plain_matches_k1_edges(k, r, dtype):
    T = _field((67, 130), seed=k)
    ref = ps.ftcs_multistep_edges_pallas(_ref(T, dtype), r, k)
    _bytes_equal(cs.ftcs_multistep_edges_cuda(_port(T, dtype), r, k), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [16, 40])
def test_plain_matches_k1_edges_wide(k, dtype):
    T = _field((100, 500), seed=7)
    ref = ps.ftcs_multistep_edges_pallas(_ref(T, dtype), 0.2, k)
    _bytes_equal(cs.ftcs_multistep_edges_cuda(_port(T, dtype), 0.2, k), ref)


def test_bf16_deep_fusion_matches_reference():
    """bf16 rounds to storage at every pass boundary, so 40 fused steps
    must be cut where the reference cuts them: 32 + 8 on this width (its
    thin kernel's cap), which a 16-step cap (16 + 16 + 8) would miss."""
    T = _field((67, 130), seed=3)
    ref = ps.ftcs_multistep_edges_pallas(_ref(T, "bfloat16"), 0.2, 40)
    _bytes_equal(cs.ftcs_multistep_edges_cuda(_port(T, "bfloat16"), 0.2, 40), ref)
    sixteens = _ref(T, "bfloat16")
    for kk in (16, 16, 8):
        sixteens = ps.ftcs_multistep_edges_pallas(sixteens, 0.2, kk)
    assert not np.array_equal(np.asarray(sixteens.astype(jnp.float32)),
                              np.asarray(ref.astype(jnp.float32)))
    # f32 bytes do not depend on the pass schedule at all
    ref32 = ps.ftcs_multistep_edges_pallas(_ref(T, "float32"), 0.2, 40)
    _bytes_equal(cs.ftcs_multistep_edges_cuda(_port(T, "float32"), 0.2, 40), ref32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 16])
def test_plain_matches_k1_ghost(k, dtype):
    T = _field((67, 130), seed=11)
    ref = ps.ftcs_multistep_ghost_pallas(_ref(T, dtype), 0.2, 1.0, k)
    _bytes_equal(cs.ftcs_multistep_ghost_cuda(_port(T, dtype), 0.2, 1.0, k), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [5, 16, 40])
def test_plain_matches_k1_periodic(k, dtype):
    T = _field((67, 130), seed=13)
    ref = ps.ftcs_multistep_periodic_pallas(_ref(T, dtype), 0.2, k)
    _bytes_equal(cs.ftcs_multistep_periodic_cuda(_port(T, dtype), 0.2, k), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [0.25, 0.2, 0.1])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_plain_matches_k2_coltiled(k, r, dtype):
    """K2 called directly, as tests/test_pallas_tiling.py calls it: its
    wrap-rotate garbage stays in the kr/kc margins, so at the same pass
    depth it computes the same bytes as K1 and the plain version."""
    m, n = 100, 500
    R, C, kr, kc = 16, 256, 16, 128
    T = _field((m, n), seed=17)
    Tp = jnp.pad(_ref(T, dtype), [(0, ps._round_up(m, R) - m),
                                  (0, ps._round_up(n, C) - n)])
    ref = ps._pallas_2d_coltiled(Tp, r=r, ksteps=k, R=R, C=C, kr=kr, kc=kc,
                                 logical_shape=(m, n))[:m, :n]
    _bytes_equal(cs.ftcs_multistep_edges_cuda(_port(T, dtype), r, k), ref)


def test_bounded_wrapper_honours_custom_bounds():
    """Cells outside custom bounds stay frozen; inside, the bounded pass is
    the edges pass of the sub-array (margin >= k on every side)."""
    T = _field((40, 50), seed=19)
    Tt = torch.from_numpy(T)
    b = (4, 35, 6, 43)
    got = cs.ftcs_multistep_bounded_cuda(Tt, 0.2, 3, b)
    frozen = np.ones(T.shape, bool)
    frozen[5:35, 7:43] = False
    np.testing.assert_array_equal(got.numpy()[frozen], T[frozen])
    sub = cs.ftcs_multistep_edges_cuda(Tt[4:36, 6:44].contiguous(), 0.2, 3)
    np.testing.assert_array_equal(got.numpy()[4:36, 6:44], sub.numpy())


def test_fma_is_single_rounding():
    """The plain version's update rounds a*b+c once: against exact
    rational arithmetic on random f32 triples, including the rare cases
    where an f64 sum rounded again to f32 would be off by one ulp."""
    from fractions import Fraction

    rng = np.random.default_rng(23)
    a = rng.uniform(-1, 1, 4000).astype(np.float32)
    b = (rng.uniform(-1, 1, 4000) * 2.0 ** rng.integers(-30, 2, 4000)).astype(np.float32)
    c = rng.uniform(-2, 2, 4000).astype(np.float32)
    # an exact value just above an f32 tie, which an f64 sum rounds onto
    # the tie (and a second rounding then takes down):
    # (1 + 2^-23) - 2^-24 (1 + 2^-23)(1 - 2^-23) = 1 + 2^-24 + 2^-70
    c[0] = np.float32(1 + 2.0 ** -23)
    a[0] = np.float32(-(2.0 ** -24) * (1 + 2.0 ** -23))
    b[0] = np.float32(1 - 2.0 ** -23)
    naive = np.float32(np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0]))
    assert naive == np.float32(1.0)  # the double-rounded answer
    got = cs._fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))  # may itself be off by the tie rule
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i], got[i], best)
    assert got[0] == np.float32(1 + 2.0 ** -23)


def test_wrappers_refuse_other_devices_and_depths():
    T = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        cs._launch(T, 0.2, cs._KMAX_2D + 1, (0, 7, 0, 7), None)
    with pytest.raises(ValueError):
        cs._launch(torch.zeros(8, 8, 8), 0.2, cs._KMAX_3D + 1,
                   (0, 7) * 3, None)
    with pytest.raises(ValueError):
        cs._pass(T.to("meta"), 0.2, 1, (0, 7, 0, 7))
    assert cs.kernel_available((8, 8), torch.float32)
    assert not cs.kernel_available((8, 8), torch.float64)
    assert cs.kernel_available((8, 8, 8), torch.float32)
    assert not cs.kernel_available((8, 8, 8), torch.float64)
    assert not cs.kernel_available((8,), torch.float32)

