"""The card-only cases of heat_tpu_torch: each kernel, and each path that
launches one, against the port's plain version on the same card.

This file imports neither JAX nor heat_tpu, so it runs on the card's host,
which has neither installed (``chip_smoke.py`` runs it there with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_card.py``). The CPU tests hold each plain version against
the reference, so a kernel equal to its plain version is equal to the
reference. On a host without a card every case skips.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from heat_tpu_torch import config
from heat_tpu_torch.backends import sharded, solve
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.ops import cuda_lab
from heat_tpu_torch.ops import cuda_lanes
from heat_tpu_torch.ops import cuda_stencil as cs
from heat_tpu_torch.serve import Engine, ServeConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got.view(view), want.view(view))


def test_kernel_matches_plain_on_card():
    for dtype in (torch.float32, torch.bfloat16):
        T = torch.rand(1000, 4099, generator=torch.Generator().manual_seed(0))
        T = (1 + T).to(dtype).cuda()
        for k in (1, 7, 16, 32):
            got = cs.ftcs_multistep_edges_cuda(T, 0.2, k)
            want = cs.ftcs_multistep_edges_cuda(T, 0.2, k, plain=True)
            assert _same_bits(got, want), (dtype, k)


def test_kernel_matches_plain_on_card_3d():
    for dtype in (torch.float32, torch.bfloat16):
        T = torch.rand(67, 45, 129, generator=torch.Generator().manual_seed(0))
        T = (1 + T).to(dtype).cuda()
        for k in (1, 4, 8):
            got = cs.ftcs_multistep_edges_cuda(T, 1 / 6, k)
            want = cs.ftcs_multistep_edges_cuda(T, 1 / 6, k, plain=True)
            assert _same_bits(got, want), (dtype, k)


# the kernel lab: (function, variant) pairs, the TPU geometry the JAX
# functions take, and the inputs of tests/test_torch_lab_kernels.py
_LAB_PAIRS = [
    ("lab_3d_tiled", None), ("lab_3d_rolled", "f32"), ("lab_3d_rolled", "fma"),
    ("lab_thin2d_variant", "shrink"), ("lab_thin2d_variant", "rolled"),
    ("lab_thin2d_variant", "rolledfma"), ("lab_thin2d_variant", "bf16native"),
    ("lab_2d_coltiled", None), ("lab_2d_coltiled_rolled", "f32"),
    ("lab_2d_coltiled_rolled", "fma"), ("lab_2d_coltiled_rolled", "bf16native"),
    ("lab_2d_coltiled_rolled", "bf16fma"),
]
_LAB_GEO = {"2d": dict(R=8, C=128, kr=8, kc=64), "thin": dict(tile=8, kpad=8),
            "3d": dict(R=8, M=4, k=4, km=4)}


def _lab_field(nd: int, seed: int):
    logical, pad = ((40, 200), (40, 256)) if nd == 2 else ((16, 12, 100),
                                                           (16, 12, 128))
    T = np.zeros(pad, np.float32)
    T[tuple(slice(0, s) for s in logical)] = np.random.default_rng(
        seed).uniform(0.0, 2, logical)
    return T, logical


def test_lab_kernels_match_plain_on_the_card():
    for name, variant in _LAB_PAIRS:
        nd = 3 if "3d" in name else 2
        T, logical = _lab_field(nd, seed=4)
        geo = _LAB_GEO["thin" if name == "lab_thin2d_variant"
                       else f"{nd}d"]
        blocks = cuda_lab.BLOCKS_2D if nd == 2 else cuda_lab.BLOCKS_3D[:1]
        k = 8 if nd == 2 else 4
        for dtype in (torch.float32, torch.bfloat16):
            Tp = torch.from_numpy(T).to(dtype).cuda()
            kw = dict(geo, logical=logical)
            if variant is not None:
                kw["variant"] = variant
            fn = getattr(cuda_lab, name)
            for block in blocks:
                # the streamed 2D tile is compiled at a few depths only
                kb = (max(d for d in cuda_lab.STREAM_2D_DEPTHS if d <= k)
                      if block == cuda_lab.STREAM_2D else k)
                got = fn(Tp, 0.15, kb, block=block, **kw)
                want = fn(Tp, 0.15, kb, plain=True, **kw)
                g = got.float().cpu().numpy().view(np.uint32)
                w = want.float().cpu().numpy().view(np.uint32)
                assert int((g != w).sum()) == 0, (name, variant, dtype, block)


def _lane_case(nd, B, k, seed):
    """(fields f32, r, n, rem) of one lane case: four lanes, one with
    n < B, one whose countdown ends inside the chunk, one with none left,
    one with a NaN in its centre."""
    m = B + 2
    f = np.random.default_rng(seed).uniform(1, 2, (4,) + (m,) * nd)
    f = f.astype(np.float32)
    f[(3,) + (1 + B // 2,) * nd] = np.nan
    n = np.array([B - 3, B, B, B], np.int32)
    rem = np.array([k + 3, k // 2 if k > 1 else 0, 0, k + 1], np.int32)
    r = {2: [0.25, 0.2, 0.1, 0.25], 3: [1 / 6, 0.15, 0.1, 1 / 6]}[nd]
    return f, np.array(r, np.float32), n, rem


def _nan_bits(a: np.ndarray) -> np.ndarray:
    a = np.where(np.isnan(a), np.float32(np.nan), a).astype(np.float32)
    return a.view(np.uint32)


def test_lane_kernels_match_plain_on_the_card():
    for nd, B in ((2, 12), (2, 256), (3, 8), (3, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            for k in (1, 16, 37):
                f, r, n, rem = _lane_case(nd, B, k, seed=k)
                args = [torch.from_numpy(a).cuda() for a in (r, n, rem)]
                T = torch.from_numpy(f).to(dtype).cuda()
                fields, fin, stats = (
                    x.float().cpu().numpy() if x.is_floating_point()
                    else x.cpu().numpy()
                    for x in cuda_lanes.lane_multistep(T, *args, k, 1))
                want = cuda_lanes.lane_multistep(T, *args, k, 1, plain=True)
                w_fields = want[0].float().cpu().numpy()
                w_fin = want[1].cpu().numpy().astype(bool)
                w_stats = want[2].cpu().numpy()
                assert int((_nan_bits(fields) != _nan_bits(w_fields)).sum()) == 0
                np.testing.assert_array_equal(fin, w_fin)
                np.testing.assert_array_equal(stats[:3, w_fin],
                                              w_stats[:3, w_fin])
                np.testing.assert_allclose(stats[3, w_fin], w_stats[3, w_fin],
                                           rtol=1e-5)


def _matrix_requests(ndim, dtype, bcs):
    """tests/test_serve_lane_kernel.py:78-92, as keyword sets."""
    small = 6 if ndim == 3 else 8
    big = 8 if ndim == 3 else 12
    return [
        dict(n=big, ntime=13, ndim=ndim, dtype=dtype, bc=bcs[0], ic="hat"),
        dict(n=small, ntime=21, ndim=ndim, dtype=dtype, bc=bcs[1],
             ic="uniform", nu=0.1),
        dict(n=big - 2, ntime=5, ndim=ndim, dtype=dtype, bc=bcs[0],
             ic="hat_small"),
        dict(n=big, ntime=0, ndim=ndim, dtype=dtype, bc=bcs[1], ic="hat"),
        dict(n=small + 1, ntime=30, ndim=ndim, dtype=dtype, bc=bcs[0],
             ic="hat_half", bc_value=2.5),
    ]


def test_serve_on_the_card_matches_the_plain_body():
    """On the card the lane kernels serve the lane matrix to the bytes of
    the plain lane body run on the same card."""
    reqs = (_matrix_requests(2, "float32", ("ghost", "edges"))
            + _matrix_requests(2, "bfloat16", ("edges", "ghost"))
            + _matrix_requests(3, "float32", ("ghost", "edges")))
    out = {}
    for kernel in ("cuda", "torch"):
        cuda_lanes.reset_launches()
        eng = Engine(ServeConfig(lanes=2, chunk=4, buckets=(12,),
                                 lane_kernel=kernel, emit_records=False,
                                 keep_fields=True), device="cuda")
        ids = [eng.submit(HeatConfig(**r)) for r in reqs]
        recs = {r["id"]: r for r in eng.results()}
        assert all(recs[i]["status"] == "ok" for i in ids)
        assert (min(cuda_lanes.launches.values()) > 0) == (kernel == "cuda")
        # the scheduler's count of the chunks' passes = the wrappers' count
        summary = eng.summary()
        assert summary["lane_passes"] == {
            k: v for k, v in cuda_lanes.launches.items() if v}
        assert (sum(summary["lane_passes_by_bucket"].values())
                == sum(cuda_lanes.launches.values()))
        out[kernel] = [recs[i]["T"].tobytes() for i in ids]
    assert out["cuda"] == out["torch"]


@pytest.mark.parametrize("ndim", [2, 3])
def test_cuda_solve_on_card_is_the_plain_version(ndim):
    """On the card the solve goes through the kernel, and ends on the bytes
    the plain version computes on the CPU in the same passes."""
    cs.reset_launches()
    port = config.variant_config("python_cuda").with_(
        backend="cuda", n=40 if ndim == 3 else 67, ntime=40, ndim=ndim,
        sigma=0.15, heartbeat_every=0, write_int=False)
    got = solve(port, device="cuda")
    name = "ftcs2d" if ndim == 2 else "ftcs3d"
    assert got.timing.kernel == f"cuda {name}" and cs.launches[name]
    np.testing.assert_array_equal(got.T, solve(port, device="cpu").T)


def _sharded_field(cfg, **kw):
    return solve(cfg, device="cuda", virtual_devices=int(np.prod(cfg.mesh_shape)),
                 **kw).T


@pytest.mark.parametrize("ndim,comm", [(2, "direct"), (2, "staged"),
                                       (3, "direct"), (3, "staged")])
def test_overlap_on_the_card(ndim, comm):
    """``--exchange overlap`` on the card: the kernels on the interior and
    on every region (the staged slabs on a side stream), the bytes of the
    indep exchange in f32; in bf16 the bytes of the same overlap on the
    plain bounded version."""
    cfg = HeatConfig(n=512 if ndim == 2 else 64, ndim=ndim, ntime=37,
                     sigma=0.2 if ndim == 2 else 0.15, bc="ghost",
                     dtype="float32", backend="sharded", comm=comm,
                     mesh_shape=(2, 2) if ndim == 2 else (2, 2, 1))
    name = "ftcs2d" if ndim == 2 else "ftcs3d"
    cs.reset_launches()
    got = _sharded_field(cfg.with_(exchange="overlap"))
    assert cs.launches[name] > 0
    want = _sharded_field(cfg)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    bf16 = cfg.with_(dtype="bfloat16", exchange="overlap")
    got = _sharded_field(bf16)
    plain = functools.partial(cs.ftcs_multistep_bounded_cuda, plain=True)
    with mock.patch.object(sharded, "ftcs_multistep_bounded_cuda", plain):
        cs.reset_launches()
        want = _sharded_field(bf16)
        assert cs.launches[name] == 0
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
