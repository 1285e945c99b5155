"""The port's ``sharded`` backend against heat_tpu's, on the CPU.

heat_tpu's sharded solve runs on the 8 virtual CPU devices ``conftest.py``
provides; the port's runs its shards in this process (``LocalComm``,
``device="cpu"``). Held to:

- heat_tpu's ``local_kernel="pallas"`` (interpret mode): the port's
  ``local_kernel="cuda"`` (the kernels' plain bounded versions on CPU
  tensors), bytes, f32 and bf16, edges / ghost / periodic, 2D and 3D, an
  explicit and the auto fuse depth;
- the port's own unsharded ``torch`` backend: the port's ``torch`` local
  kernel, bytes; and heat_tpu's jitted ``xla`` local kernel, within the
  reference's tolerances (XLA contracts FMAs on the CPU at r != 0.25, so
  r is 0.2 / 0.1 in 2D and 1/6 / 0.15 in 3D);
- the reference's literal update-then-swap transcription for
  ``parity_order``; the reference's checkpoint files, byte for byte.
"""

import contextlib
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu.config as ref_config
from heat_tpu.backends import solve as ref_solve
from heat_tpu.backends.sharded import fuse_depth_sharded as ref_fuse_depth
from heat_tpu.grid import initial_condition
from heat_tpu.ops import pallas_stencil as ps
from heat_tpu_torch import config
from heat_tpu_torch.backends import sharded, solve
from heat_tpu_torch.ops import pass_schedule
from heat_tpu_torch.parallel import comm as port_comm
from test_parity_order import literal_mpi_update_then_swap

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parent.parent
_GEOMETRY = {2: dict(n=32, sigma=0.2, mesh_shape=(2, 4)),
             3: dict(n=16, sigma=0.15, mesh_shape=(2, 2, 2))}
# the reference's cross-backend tolerances (tests/test_backends.py)
_ATOL = {"float64": 1e-14, "float32": 5e-6, "bfloat16": 3e-2}


_REF_KERNEL = {"auto": "auto", "torch": "xla", "cuda": "pallas"}


def _pair(ndim, local_kernel="auto", **kw):
    """(heat_tpu config, port config): the same run, each package's
    counterpart of ``local_kernel``."""
    kw = {**_GEOMETRY[ndim], "ndim": ndim, "ntime": 11, "ic": "hat",
          "backend": "sharded", **kw}
    return (ref_config.HeatConfig(**kw, local_kernel=_REF_KERNEL[local_kernel]),
            config.HeatConfig(**kw, local_kernel=local_kernel))


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


# 2D: every (bc, dtype) at the auto and an explicit depth; 3D (the slower
# interpret-mode kernel): every (bc, dtype), f32 at an explicit depth
_PALLAS_CASES = ([(2, bc, dt, fuse) for bc in ("edges", "ghost", "periodic")
                  for dt in ("float32", "bfloat16") for fuse in (0, 3)]
                 + [(3, bc, dt, 3 if dt == "float32" else 0)
                    for bc in ("edges", "ghost", "periodic")
                    for dt in ("float32", "bfloat16")])


@pytest.mark.parametrize("ndim,bc,dtype,fuse", _PALLAS_CASES)
def test_cuda_local_kernel_matches_pallas_bytes(ndim, bc, dtype, fuse):
    ref_cfg, cfg = _pair(ndim, "cuda", bc=bc, dtype=dtype, fuse_steps=fuse,
                         report_sum=True)
    want = _quiet(ref_solve, ref_cfg)
    got = _quiet(solve, cfg, device="cpu")
    assert got.timing.kernel == f"ftcs{ndim}d plain version (cpu)"
    assert got.exchange["kf"] == ref_fuse_depth(ref_cfg, cfg.mesh_shape)
    np.testing.assert_array_equal(_bits(np.asarray(got.T, np.float32)),
                                  _bits(np.asarray(want.T, np.float32)))
    assert got.gsum == want.gsum and got.gsum_dtype == "float64"


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("bc", ["edges", "ghost", "periodic"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_torch_local_kernel(ndim, bc, dtype):
    """Bytes of the port's unsharded torch step; heat_tpu's jitted xla
    local kernel within the reference's tolerance."""
    ref_cfg, cfg = _pair(ndim, "torch", bc=bc, dtype=dtype)
    if ndim == 2:
        cfg, ref_cfg = cfg.with_(sigma=0.1), ref_cfg.with_(sigma=0.1)
    got = _quiet(solve, cfg, device="cpu")
    assert got.timing.kernel == "torch-step"
    plain = solve(cfg.with_(backend="torch", mesh_shape=None), device="cpu")
    np.testing.assert_array_equal(got.T, plain.T)
    want = _quiet(ref_solve, ref_cfg)
    np.testing.assert_allclose(got.T, np.asarray(want.T, got.T.dtype),
                               rtol=0, atol=_ATOL[dtype])


@pytest.mark.parametrize("form", ["seq", "indep"])
def test_formulations_and_comms_agree(form, monkeypatch):
    """staged = direct, bytes, with the host round trip of staged observed
    (``stage_to_host``) and absent from direct; ``seq`` runs the one
    exchange, the bytes of ``indep``."""
    calls = []
    real = port_comm.stage_to_host
    monkeypatch.setattr(port_comm, "stage_to_host",
                        lambda t: calls.append(1) or real(t))
    _, cfg = _pair(2, "cuda", bc="ghost", dtype="float32", exchange=form)
    direct = _quiet(solve, cfg, device="cpu")
    assert not calls
    staged = _quiet(solve, cfg.with_(comm="staged"), device="cpu")
    assert calls
    base = _quiet(solve, cfg.with_(exchange="indep"), device="cpu")
    np.testing.assert_array_equal(_bits(staged.T), _bits(direct.T))
    np.testing.assert_array_equal(_bits(direct.T), _bits(base.T))


@pytest.mark.parametrize("ndim", [2, 3])
def test_check_numerics_keeps_the_bytes(ndim):
    """A numerics-checked run (a finite check of the owned cells) gives
    the bytes of the unchecked run."""
    _, cfg = _pair(ndim, "cuda", bc="edges", dtype="bfloat16")
    fast = _quiet(solve, cfg, device="cpu")
    checked = _quiet(solve, cfg.with_(check_numerics=True), device="cpu")
    np.testing.assert_array_equal(checked.T, fast.T)


def test_check_numerics_catches_an_injected_nan():
    _, cfg = _pair(2, bc="ghost", dtype="float32", check_numerics=True,
                   inject="nan@4")
    with pytest.raises(FloatingPointError, match="step"):
        _quiet(solve, cfg, device="cpu")


def test_checkpoint_files_match_reference(tmp_path):
    """A checkpointed run's files are the reference's, byte for byte, and
    a resume from one finishes with the same field."""
    ref_cfg, cfg = _pair(2, "cuda", bc="edges", dtype="bfloat16", ntime=10,
                         checkpoint_every=5, async_io="off")
    _quiet(ref_solve, ref_cfg.with_(checkpoint_dir=str(tmp_path / "ref")))
    got = _quiet(solve, cfg.with_(checkpoint_dir=str(tmp_path / "port")),
                 device="cpu")
    for step in (5, 10):
        name = f"heat_step{step:08d}.npz"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    (tmp_path / "ref" / "heat_step00000010.npz").unlink()
    resumed = _quiet(solve, cfg.with_(checkpoint_dir=str(tmp_path / "ref")),
                     device="cpu")
    assert resumed.start_step == 5
    np.testing.assert_array_equal(resumed.T, got.T)


@pytest.mark.parametrize("seed_from_ic", [True, False])
def test_parity_order_matches_literal_transcription(seed_from_ic):
    cfg = config.HeatConfig(n=24, ntime=7, dtype="float64", backend="sharded",
                            bc="ghost", ic="uniform", parity_order=True,
                            mesh_shape=(4, 1))
    if seed_from_ic:
        T0, kw = initial_condition(ref_config.HeatConfig(n=24, ic="uniform",
                                                         dtype="float64")), {}
    else:
        T0 = np.random.default_rng(7).uniform(1.0, 2.0, size=(24, 24))
        kw = dict(T0=T0)
    want = literal_mpi_update_then_swap(T0, cfg.r, cfg.ntime, cfg.bc_value, 4,
                                        seed_from_ic=seed_from_ic)
    got = _quiet(solve, cfg, device="cpu", **kw)
    np.testing.assert_array_equal(got.T, want)
    default = _quiet(solve, cfg.with_(parity_order=False), device="cpu", **kw)
    assert np.array_equal(default.T, got.T) == seed_from_ic


def test_parity_order_matches_reference_2d_mesh():
    kw = dict(n=24, ntime=9, dtype="float32", backend="sharded", bc="edges",
              ic="hat", parity_order=True, mesh_shape=(2, 2), sigma=0.25)
    want = _quiet(ref_solve, ref_config.HeatConfig(**kw))
    got = _quiet(solve, config.HeatConfig(**kw), device="cpu")
    np.testing.assert_array_equal(got.T, np.asarray(want.T))
    with pytest.raises(ValueError, match="parity_order"):
        solve(config.HeatConfig(**kw, checkpoint_every=2), device="cpu")


_FUSE_CASES = [
    dict(n=32, ndim=2, dtype="float64", mesh=(8, 1)),
    dict(n=32, ndim=2, dtype="float64", mesh=(2, 2)),
    dict(n=32, ndim=2, dtype="float64", mesh=(2, 2), fuse_steps=3),
    dict(n=16384, ndim=2, dtype="float32", mesh=(1, 1)),
    dict(n=16384, ndim=2, dtype="float32", mesh=(1, 1), local_kernel="torch"),
    dict(n=16384, ndim=2, dtype="float64", mesh=(1, 1)),
    dict(n=16384, ndim=2, dtype="float32", mesh=(1, 1), fuse_steps=32),
    dict(n=4864, ndim=2, dtype="float32", mesh=(1, 1)),
    dict(n=32768, ndim=2, dtype="float32", mesh=(2, 2)),
    dict(n=32768, ndim=2, dtype="bfloat16", mesh=(2, 2)),
    dict(n=8192, ndim=2, dtype="float32", mesh=(2, 2)),
    dict(n=512, ndim=3, dtype="float32", mesh=(1, 1, 1)),
    dict(n=512, ndim=3, dtype="float32", mesh=(2, 2, 2)),
    dict(n=512, ndim=3, dtype="float32", mesh=(2, 2, 1)),
    dict(n=512, ndim=3, dtype="float32", mesh=(1, 1, 1), fuse_steps=16),
    dict(n=8, ndim=3, dtype="float32", mesh=(4, 4, 4)),
]


@pytest.mark.parametrize("case", _FUSE_CASES, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_fuse_depth_matches_reference(case):
    case = dict(case)
    mesh_shape = case.pop("mesh")
    lk = case.pop("local_kernel", "auto")
    ref_cfg = ref_config.HeatConfig(backend="sharded", **case,
                                    local_kernel="xla" if lk == "torch" else lk)
    cfg = config.HeatConfig(backend="sharded", **case, local_kernel=lk)
    assert (sharded.fuse_depth_sharded(cfg, mesh_shape)
            == ref_fuse_depth(ref_cfg, mesh_shape))


@pytest.mark.parametrize("shape", [(4928, 4928), (16448, 16448), (8256, 8256),
                                   (100, 500), (4160, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_effective_chunk_matches_reference(shape, dtype):
    for k in (None, 5, 16):
        assert (pass_schedule.effective_chunk_2d(shape, dtype, k)
                == ps.effective_chunk_2d(shape, dtype, k))


def test_refusals():
    """No path falls back quietly: overlap without the stencil kernel (the
    torch local kernel, or f64) raises, an f64 cuda local kernel raises, a
    mesh larger than the shards given raises."""
    _, cfg = _pair(2, dtype="float32")
    for kw in (dict(local_kernel="torch"), dict(dtype="float64"),
               dict(dtype="float64", local_kernel="cuda")):
        with pytest.raises(ValueError, match="overlap"):
            _quiet(solve, cfg.with_(exchange="overlap", **kw), device="cpu")
    with pytest.raises(ValueError, match="local_kernel='cuda'"):
        _quiet(solve, cfg.with_(dtype="float64", local_kernel="cuda"),
               device="cpu")
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        solve(cfg, device="cpu", virtual_devices=4)


def test_solve_without_device_raises_on_a_cpu_only_host():
    code = ("import heat_tpu_torch as h\n"
            "cfg = h.HeatConfig(n=8, ntime=2, backend='sharded')\n"
            "try:\n"
            "    h.solve(cfg)\n"
            "except RuntimeError as e:\n"
            "    print('raised', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised") and "device='cpu'" in out.stdout
