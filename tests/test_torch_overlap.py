"""``--exchange overlap`` of the port's sharded backend against heat_tpu's,
on the CPU: every case of ``tests/test_overlap.py`` through both packages.

heat_tpu's overlap runs its Pallas kernel in interpret mode on the 8 virtual
CPU devices ``conftest.py`` provides, as ``tests/test_overlap.py`` runs it;
the port's runs its shards in this process (``LocalComm``, ``device="cpu"``),
each kernel call on the bounded kernel's plain version at its own input
shape. Held to the reference's overlap bytes in every case, bf16 included
(each region's passes are planned at its own shape, as the reference plans
them), and in f32 to the port's own indep bytes.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import heat_tpu.config as ref_config
from heat_tpu.backends.sharded import solve as ref_solve
from heat_tpu_torch import config
from heat_tpu_torch.backends import sharded
from heat_tpu_torch.backends.sharded import solve
from heat_tpu_torch.backends.serial_np import solve as serial_solve
from heat_tpu_torch.ops import cuda_stencil as cs

torch.set_num_threads(1)


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _check(**kw):
    """The port's overlap against the reference's overlap (bytes) and, in
    f32, against the port's indep (bytes); returns the port's field."""
    kw = {"dtype": "float32", "backend": "sharded", **kw}
    ref = _quiet(ref_solve, ref_config.HeatConfig(**kw, local_kernel="pallas",
                                                  exchange="overlap"))
    cfg = config.HeatConfig(**kw, local_kernel="cuda", exchange="overlap")
    got = _quiet(solve, cfg, device="cpu")
    assert got.exchange["local_kernel"] == "cuda"
    np.testing.assert_array_equal(_bits(got.T), _bits(ref.T))
    if kw["dtype"] == "float32":
        indep = _quiet(solve, cfg.with_(exchange="indep"), device="cpu")
        np.testing.assert_array_equal(_bits(got.T), _bits(indep.T))
    return got


@pytest.mark.parametrize("bc", ["edges", "ghost", "periodic"])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 2)])
def test_overlap_bitwise_2d(bc, mesh_shape):
    _check(n=64, ntime=12, bc=bc, mesh_shape=mesh_shape, fuse_steps=4)


@pytest.mark.parametrize("bc", ["edges", "periodic"])
def test_overlap_bitwise_3d(bc):
    _check(n=32, ndim=3, ntime=6, bc=bc, sigma=1 / 6, mesh_shape=(2, 2, 2),
           fuse_steps=2)


def test_overlap_bitwise_remainder_chunk():
    # ntime % fuse != 0: the remainder block runs ksteps < wpad through
    # the same split (margins stay wpad-wide)
    _check(n=64, ntime=10, mesh_shape=(2, 2), fuse_steps=4)


@pytest.mark.parametrize("n,fuse", [
    (16, 8),   # L = 8 = w: rim bands are the whole shard, interior empty
    (24, 8),   # w < L = 12 < 2w: bands overlap mid-shard, interior empty
    (32, 8),   # L = 16 = 2w exactly: interior empty, regions abut
])
def test_overlap_bitwise_tiny_shards(n, fuse):
    _check(n=n, ntime=8, mesh_shape=(2, 2), fuse_steps=fuse)


def test_overlap_matches_serial_oracle():
    cfg = config.HeatConfig(n=48, ntime=10, mesh_shape=(2, 2), fuse_steps=4,
                            dtype="float32", backend="sharded",
                            local_kernel="cuda", exchange="overlap")
    want = serial_solve(cfg.with_(backend="serial")).T.astype(np.float32)
    got = _check(n=48, ntime=10, mesh_shape=(2, 2), fuse_steps=4)
    np.testing.assert_allclose(got.T, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("ndim", [2, 3])
def test_overlap_bf16_bytes(ndim):
    """bf16 rounds at each pass boundary, so the overlap's bytes depend on
    the pass cuts of every region: the reference's overlap bytes."""
    if ndim == 2:
        _check(n=64, ntime=8, dtype="bfloat16", mesh_shape=(2, 2),
               fuse_steps=4)
    else:
        _check(n=32, ndim=3, ntime=6, dtype="bfloat16", sigma=0.15,
               bc="ghost", mesh_shape=(2, 2, 1), fuse_steps=3)


def test_overlap_staged_comm():
    # the HIP preset's staged (host round trip) exchange still composes
    _check(n=64, ntime=8, comm="staged", mesh_shape=(2, 2), fuse_steps=4)


@pytest.mark.parametrize("kw", [dict(local_kernel="torch"),
                                dict(dtype="float64"),
                                dict(dtype="float64", local_kernel="cuda"),
                                dict(local_kernel="auto")])
def test_overlap_requires_the_kernel(kw):
    """No quiet fallback: without the bounded kernel (the torch local
    kernel, f64, or ``auto`` off the card) overlap raises, naming it."""
    cfg = config.HeatConfig(**{"n": 64, "ntime": 4, "exchange": "overlap",
                               "dtype": "float32", "backend": "sharded",
                               **kw})
    with pytest.raises(ValueError, match="overlap"):
        _quiet(solve, cfg, device="cpu")


@pytest.mark.parametrize("shape,calls", [((24, 32, 48), 7),
                                         ((48, 24), 5),
                                         ((48, 64), 9)])
def test_overlap_regions(shape, calls):
    """1 + (3^nd - 1) kernel calls per shard and block, or 1 + 2 nd in the
    wide form (an owned extent below 2w): the interior first, every
    region's input 3w deep on its faces' axes and the owned span on the
    others."""
    w = 8
    regions = sharded.overlap_regions(shape, w)
    assert len(regions) == calls
    assert regions[0] == ((0,) * len(shape), tuple(s - 2 * w for s in shape))
    for sigma, got in regions[1:]:
        assert any(sigma)
        if calls == 1 + 2 * len(shape):
            assert got == tuple(3 * w if s else L for s, L in zip(sigma, shape))
        else:
            assert got == tuple(3 * w if s else L - 2 * w
                                for s, L in zip(sigma, shape))


@pytest.mark.parametrize("nd,n", [(2, 64), (3, 48), (2, 32)])
def test_overlap_kernel_calls_per_block(nd, n, monkeypatch):
    """A solve plans the bounded kernel's passes at exactly
    ``overlap_regions``' shapes, in its order, on every shard; the
    interior call steps the whole padded shard."""
    w = 8
    shards = 2 ** nd
    shape = (n // 2 + 2 * w,) * nd
    seen = []
    real = cs.ftcs_multistep_bounded_cuda
    monkeypatch.setattr(sharded, "ftcs_multistep_bounded_cuda",
                        lambda T, *a, **k: seen.append(
                            tuple(k.get("plan_shape") or T.shape))
                        or interior.append(tuple(T.shape) == shape
                                           and "out" in k)
                        or real(T, *a, **k))
    interior = []
    cfg = config.HeatConfig(n=n, ndim=nd, ntime=w, fuse_steps=w,
                            heartbeat_every=0, mesh_shape=(2,) * nd,
                            dtype="float32", backend="sharded",
                            local_kernel="cuda", exchange="overlap",
                            sigma=0.2 if nd == 2 else 0.15)
    _quiet(solve, cfg, device="cpu")
    # the warm-up block and the timed block
    block = [s for _, s in sharded.overlap_regions(shape, w)
             for _ in range(shards)]
    assert len(block) == shards * (1 + (3 ** nd - 1 if n // 2 >= 2 * w
                                        else 2 * nd))
    assert seen == block * 2
    assert interior == ([True] * shards + [False] * (len(block) - shards)) * 2
