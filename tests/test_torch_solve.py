"""The port's solve path end to end on the CPU against heat_tpu's.

``solve(cfg, device="cpu")`` on the port's ``serial`` / ``torch`` / ``cuda``
backends against heat_tpu's ``serial`` / ``xla`` / ``pallas`` (the last in
Pallas interpret mode) on reference variants, at 40 steps: with the event
interval at 40 the cuda backend runs two 16-step fused passes and eight
one-step passes, the reference's own schedule. Bytes compared. The CLI
writes the same ``soln.dat`` as ``python -m heat_tpu run``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu.cli as ref_cli
import heat_tpu.config as ref_config
from heat_tpu.backends import solve as ref_solve
from heat_tpu_torch import config
from heat_tpu_torch.backends import solve
from heat_tpu_torch.backends.cuda import make_advance
from heat_tpu_torch.ops import cuda_stencil

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default of one thread per core in each worker starves the rest.
torch.set_num_threads(1)

_REF_BACKEND = {"serial": "serial", "torch": "xla", "cuda": "pallas"}
_REPO = Path(__file__).resolve().parent.parent

# (variant, dtype override): the variants of the run path
_VARIANTS = [("serial", None), ("cuda_kernel", "float32"), ("python_cuda", None)]


def _cfgs(variant, dtype, backend, **kw):
    over = dict(n=67, ntime=40, heartbeat_every=0, write_int=False)
    over.update(kw)
    if dtype:
        over["dtype"] = dtype
    port = config.variant_config(variant).with_(backend=backend, **over)
    ref = ref_config.variant_config(variant).with_(
        backend=_REF_BACKEND[backend], **over)
    return port, ref


@pytest.mark.parametrize("backend", ["serial", "torch", "cuda"])
@pytest.mark.parametrize("variant,dtype", _VARIANTS)
def test_solve_matches_reference_backend(variant, dtype, backend):
    port, ref = _cfgs(variant, dtype, backend)
    got = solve(port, device="cpu")
    want = ref_solve(ref)
    assert got.T.dtype == np.asarray(want.T).dtype
    np.testing.assert_array_equal(got.T, np.asarray(want.T))
    assert got.device == ("host" if backend == "serial" else "cpu")
    if backend == "cuda":
        kernel = ("torch-step (f64)" if port.dtype == "float64"
                  else "ftcs2d plain version (cpu)")
        assert got.timing.kernel == kernel


@pytest.mark.parametrize("bc", ["ghost", "periodic"])
def test_cuda_backend_other_bcs_match_pallas(bc):
    port, ref = _cfgs("python_cuda", None, "cuda", bc=bc, ic="hat", n=45)
    np.testing.assert_array_equal(solve(port, device="cpu").T,
                                  np.asarray(ref_solve(ref).T))


def test_cuda_backend_pass_schedule():
    """advance(T, 40) at fuse depth 16: two fused passes, then eight
    one-step passes (the wrapper's plain version runs on CPU tensors, so
    the pass sizes are seen through it)."""
    import torch

    port, _ = _cfgs("python_cuda", None, "cuda")
    seen = []
    real = cuda_stencil._pass

    def spy(T, r, k, bounds, out=None, plain=False):
        seen.append(k)
        return real(T, r, k, bounds, out=out, plain=plain)

    advance, _warm = make_advance(port)
    cuda_stencil._pass, saved = spy, cuda_stencil._pass
    try:
        advance(torch.full((8, 8), 2.0), 40)
    finally:
        cuda_stencil._pass = saved
    assert seen == [16, 16] + [1] * 8


def test_cuda_backend_refuses_paths_of_later_slices():
    port, _ = _cfgs("python_cuda", None, "cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve(port.with_(ndim=3, n=9), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve(port.with_(backend="sharded"), device="cpu")


def test_solve_defaults_to_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = _cfgs("python_cuda", None, "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(port)


@pytest.mark.parametrize("backend,ref_backend,dtype", [
    ("cuda", "pallas", "float32"), ("torch", "xla", "float64")])
def test_cli_run_writes_the_reference_soln(tmp_cwd, backend, ref_backend, dtype):
    Path("input.dat").write_text("40 0.25 0.05 2.0 40 1\n")
    out = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch", "run", "--device", "cpu",
         "--backend", backend, "--dtype", dtype, "--out", "port.dat",
         "--json"],
        capture_output=True, text=True, timeout=120, cwd=tmp_cwd,
        env={"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "simulation completed!!!!" in out.stdout
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["backend"] == backend
    assert ref_cli.main(["run", "--backend", ref_backend, "--dtype", dtype,
                         "--out", "ref.dat"]) == 0
    assert Path("port.dat").read_bytes() == Path("ref.dat").read_bytes()


def test_cli_info_and_missing_cuda(tmp_cwd):
    Path("input.dat").write_text("16 0.25 0.05 2.0 4 0\n")
    env = {"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    info = subprocess.run([sys.executable, "-m", "heat_tpu_torch", "info"],
                          capture_output=True, text=True, timeout=120, env=env)
    assert info.returncode == 0 and "cuda available: False" in info.stdout
    run = subprocess.run([sys.executable, "-m", "heat_tpu_torch", "run"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_cwd, env=env)
    assert run.returncode != 0 and "--device cpu" in run.stderr


@pytest.fixture
def _fresh_faults():
    from heat_tpu_torch.runtime import faults

    faults.reset()
    yield
    faults.reset()


@pytest.mark.parametrize("async_io", ["on", "off"])
def test_nan_rollback_ends_on_the_clean_field(tmp_cwd, _fresh_faults, async_io):
    port, _ = _cfgs("python_cuda", None, "cuda", n=33, heartbeat_every=8,
                    checkpoint_every=16, checkpoint_dir=str(tmp_cwd / "ck"),
                    async_io=async_io)
    clean = solve(port.with_(checkpoint_every=0), device="cpu").T
    got = solve(port.with_(check_numerics=True, on_nan="rollback",
                           inject="nan@20"), device="cpu")
    np.testing.assert_array_equal(got.T, clean)
    assert sorted(p.name for p in (tmp_cwd / "ck").iterdir()) == [
        "heat_step00000016.npz", "heat_step00000032.npz"]


def test_nan_abort_names_the_step(tmp_cwd, _fresh_faults):
    port, _ = _cfgs("python_cuda", None, "cuda", n=33, heartbeat_every=8)
    with pytest.raises(FloatingPointError, match="step 24"):
        solve(port.with_(check_numerics=True, async_io="off",
                         inject="nan@20"), device="cpu")


def test_transient_sink_errors_are_retried(tmp_cwd, _fresh_faults):
    port, _ = _cfgs("python_cuda", None, "torch", n=17, checkpoint_every=10,
                    checkpoint_dir=str(tmp_cwd / "ck"),
                    inject="sink-error@10:times=2")
    res = solve(port, device="cpu")
    assert res.timing.overlap_s is not None
    assert len(list((tmp_cwd / "ck").glob("heat_step*.npz"))) == 4


def test_corrupt_checkpoint_is_quarantined_on_resume(tmp_cwd, _fresh_faults):
    port, ref = _cfgs("python_cuda", None, "cuda", n=33, checkpoint_every=10,
                      checkpoint_dir=str(tmp_cwd / "ck"))
    solve(port.with_(ntime=20, inject="ckpt-corrupt@20"), device="cpu")
    res = solve(port, device="cpu")
    assert res.start_step == 10
    assert (tmp_cwd / "ck" / "heat_step00000020.npz.corrupt").exists()
    np.testing.assert_array_equal(res.T, np.asarray(
        ref_solve(ref.with_(checkpoint_every=0)).T))


@pytest.mark.parametrize("bc", ["edges", "ghost", "periodic"])
def test_one_step_wrappers_match_pallas(bc):
    import jax.numpy as jnp
    import torch

    from heat_tpu.ops import pallas_stencil as ps

    T = np.random.default_rng(29).uniform(1, 2, (37, 45)).astype(np.float32)
    r = 0.2
    got = {"edges": lambda t: cuda_stencil.ftcs_step_edges_cuda(t, r),
           "ghost": lambda t: cuda_stencil.ftcs_step_ghost_cuda(t, r, 1.0),
           "periodic": lambda t: cuda_stencil.ftcs_step_periodic_cuda(t, r),
           }[bc](torch.from_numpy(T))
    want = {"edges": lambda t: ps.ftcs_step_edges_pallas(t, r),
            "ghost": lambda t: ps.ftcs_step_ghost_pallas(t, r, 1.0),
            "periodic": lambda t: ps.ftcs_step_periodic_pallas(t, r),
            }[bc](jnp.asarray(T))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cuda_stencil.periodic_pad_width((37, 45), 5) == ps.periodic_pad_width(
        (37, 45), 5)
