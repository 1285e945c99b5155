"""``plan`` of heat_tpu_torch against ``heat_tpu plan``.

The reference's ``test_cli_plan_subcommand`` and stability cases through
both CLIs: the ``config:``, stability, ``topology:``, ``mesh:`` and
``halo:`` lines are the same arithmetic and must be equal line for line,
and so must the exit codes of the refusals. The ``kernel:`` line names the
port's kernel; its first pass is the reference's ``plan_summary``
"per-pass chunk" for the same config, and its launches per solve are the
passes the ``cuda`` backend runs. ``plan`` touches no device.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from heat_tpu.cli import main as ref_main
from heat_tpu_torch.backends import cuda as cuda_backend
from heat_tpu_torch.backends import solve
from heat_tpu_torch.cli import main
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.ops import cuda_stencil

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parent.parent
_SHARED = ("config:", "WARNING:", "topology:", "mesh:", "halo:")
# the port's names for the reference's backends and local kernels
_REF_NAMES = {"cuda": "pallas", "torch": "xla"}


def _ref_argv(argv):
    return [_REF_NAMES.get(a, a) for a in argv]


def _both(capsys, argv):
    rc = main(argv)
    cap = capsys.readouterr()
    ref_rc = ref_main(_ref_argv(argv))
    ref_cap = capsys.readouterr()
    return (rc, cap.out, cap.err), (ref_rc, ref_cap.out, ref_cap.err)


def _shared(out):
    """The lines both CLIs print, the port's backend named as the
    reference's."""
    lines = [ln for ln in out.splitlines() if ln.startswith(_SHARED)]
    return [re.sub(r"backend=(cuda|torch)$",
                   lambda m: f"backend={_REF_NAMES[m.group(1)]}", ln)
            for ln in lines]


def _chunk(line):
    m = re.search(r"per-pass chunk (\d+)", line)
    return int(m.group(1)) if m else None


def test_cli_plan_subcommand(tmp_cwd, capsys):
    """The reference's case, both CLIs: thin 2D at per-pass chunk 16, the
    4x4 mesh's 1024^2 blocks and width-23 halo, f64's fallback, and the
    run path's refusals."""
    (tmp_cwd / "input.dat").write_text("4096 0.25 0.05 2.0 100 0\n")
    (rc, out, _), (ref_rc, ref_out, _) = _both(
        capsys, ["plan", "--backend", "cuda", "--dtype", "float32"])
    assert rc == ref_rc == 0
    assert "thin-band 2D" in ref_out and "per-pass chunk 16" in ref_out
    assert "kernel: ftcs2d on 4096x4096 float32" in out
    assert "per-pass chunk 16" in out and "launches per solve" in out
    assert _shared(out) == _shared(ref_out)

    (rc, out, _), (ref_rc, ref_out, _) = _both(
        capsys, ["plan", "--backend", "sharded", "--dtype", "float32",
                 "--mesh", "4x4"])
    assert rc == ref_rc == 0
    assert "local block 1024x1024" in out and "halo: width 23" in out
    assert _shared(out) == _shared(ref_out)
    kline = [ln for ln in out.splitlines() if ln.startswith("kernel")][0]
    ref_kline = [ln for ln in ref_out.splitlines()
                 if ln.startswith("kernel")][0]
    assert "1070x1070" in kline
    assert _chunk(kline) == _chunk(ref_kline) == 23

    # f64 -> the plain step, where the reference reports its XLA fallback
    (rc, out, _), (ref_rc, ref_out, _) = _both(
        capsys, ["plan", "--variant", "cuda_kernel"])
    assert rc == ref_rc == 0
    assert "XLA fused stencil" in ref_out
    assert "kernel: torch-step (f64)" in out
    assert _shared(out) == _shared(ref_out)

    # run-path validation applies: bad mesh rank / divisibility
    for argv in (["plan", "--backend", "sharded", "--ndim", "3", "--mesh",
                  "4x2"],
                 ["plan", "--backend", "sharded", "--mesh", "3x3"]):
        (rc, out, err), (ref_rc, ref_out, ref_err) = _both(capsys, argv)
        assert rc == ref_rc == 2
        assert _shared(out) == _shared(ref_out)
        assert err == ref_err


def test_plan_refusals_match(tmp_cwd, capsys):
    """A missing input, and the local kernel asked for where none applies
    (f64 on ``sharded``): rc 2 in both."""
    (rc, _, err), (ref_rc, _, ref_err) = _both(capsys, ["plan"])
    assert rc == ref_rc == 2 and err == ref_err
    (tmp_cwd / "input.dat").write_text("64 0.25 0.05 2.0 10 0\n")
    (rc, _, err), (ref_rc, _, ref_err) = _both(
        capsys, ["plan", "--backend", "sharded", "--dtype", "float64",
                 "--local-kernel", "cuda", "--mesh", "2x2"])
    assert rc == ref_rc == 2
    assert "local_kernel='cuda'" in err and "local_kernel='pallas'" in ref_err


def test_plan_stability_warning(tmp_cwd, capsys):
    """plan warns as run does, without touching devices (the plan half of
    the reference's ``test_cfl_stability_warning``)."""
    (tmp_cwd / "input.dat").write_text("16 0.25 0.05 2.0 2 0\n")
    (rc, out, _), (ref_rc, ref_out, _) = _both(
        capsys, ["plan", "--backend", "serial", "--ndim", "3"])
    assert rc == ref_rc == 0
    assert "stability bound" in out
    assert out == ref_out
    (rc, out, _), (ref_rc, ref_out, _) = _both(
        capsys, ["plan", "--backend", "serial", "--ndim", "2"])
    assert "stability bound" not in out and out == ref_out
    (tmp_cwd / "input.dat").write_text("16 0.15 0.05 2.0 2 0\n")
    (rc, out, _), (ref_rc, ref_out, _) = _both(
        capsys, ["plan", "--backend", "serial", "--ndim", "3"])
    assert "stability bound" not in out and out == ref_out


_CASES = [
    ("4096 0.25 0.05 2.0 100 0", ["--backend", "cuda", "--dtype", "bfloat16"]),
    ("4096 0.25 0.05 2.0 100 0", ["--backend", "cuda", "--dtype", "float32",
                                  "--bc", "ghost"]),
    ("4096 0.25 0.05 2.0 100 0", ["--backend", "cuda", "--dtype", "bfloat16",
                                  "--bc", "periodic"]),
    ("32768 0.25 0.05 1.0 128 0", ["--backend", "cuda", "--dtype", "float32"]),
    ("32768 0.25 0.05 1.0 128 0", ["--backend", "cuda", "--dtype", "bfloat16",
                                   "--fuse-steps", "32"]),
    ("512 0.15 0.05 2.0 64 0", ["--backend", "cuda", "--ndim", "3",
                                "--dtype", "float32"]),
    ("512 0.15 0.05 2.0 64 0", ["--backend", "cuda", "--ndim", "3",
                                "--dtype", "bfloat16"]),
    ("1024 0.15 0.05 2.0 64 0", ["--backend", "cuda", "--ndim", "3",
                                 "--dtype", "float32", "--bc", "ghost"]),
    ("64 0.15 0.05 2.0 64 0", ["--backend", "cuda", "--ndim", "3",
                               "--dtype", "bfloat16", "--bc", "periodic",
                               "--fuse-steps", "8"]),
    ("32768 0.25 0.05 1.0 128 0", ["--backend", "sharded", "--dtype",
                                   "float32", "--mesh", "2x2"]),
    ("32768 0.25 0.05 1.0 128 0", ["--backend", "sharded", "--dtype",
                                   "bfloat16", "--mesh", "2x2", "--bc",
                                   "ghost", "--comm", "staged"]),
    ("512 0.15 0.05 2.0 64 0", ["--backend", "sharded", "--ndim", "3",
                                "--dtype", "float32", "--mesh", "2x2x1"]),
    ("512 0.15 0.05 2.0 64 0", ["--backend", "sharded", "--ndim", "3",
                                "--dtype", "bfloat16", "--fuse-steps", "6"]),
    ("4096 0.25 0.05 2.0 100 0", ["--backend", "sharded", "--dtype",
                                  "float32", "--local-kernel", "torch"]),
    ("4096 0.25 0.05 2.0 100 0", ["--backend", "torch", "--bc", "periodic"]),
]


@pytest.mark.parametrize("dat,args", _CASES,
                         ids=[" ".join(a) for _, a in _CASES])
def test_plan_lines_and_chunk_match_the_reference(tmp_cwd, capsys, dat, args):
    (tmp_cwd / "input.dat").write_text(dat + "\n")
    (rc, out, _), (ref_rc, ref_out, _) = _both(capsys, ["plan", *args])
    assert rc == ref_rc == 0
    assert _shared(out) == _shared(ref_out)
    klines = [ln for ln in out.splitlines() if ln.startswith("kernel")]
    ref_klines = [ln for ln in ref_out.splitlines() if ln.startswith("kernel")]
    assert len(klines) == len(ref_klines)
    if klines:
        assert _chunk(klines[0]) == _chunk(ref_klines[0])
        if _chunk(klines[0]) is None:
            assert "torch" in klines[0] and "XLA" in ref_klines[0]


def test_plan_touches_no_device(tmp_path):
    """With no CUDA device visible, and torch's CUDA initialisation made to
    fail, plan prints its kernel line and exits 0."""
    (tmp_path / "input.dat").write_text("512 0.15 0.05 2.0 64 0\n")
    code = ("import sys, torch\n"
            "def no(*a, **k): raise RuntimeError('CUDA touched')\n"
            "torch.cuda._lazy_init = no\n"
            "torch.cuda.init = no\n"
            "from heat_tpu_torch.cli import main\n"
            "sys.exit(main(['plan', '--backend', 'cuda', '--ndim', '3', "
            "'--dtype', 'bfloat16']) or main(['plan', '--backend', "
            "'sharded', '--mesh', '2x2x2', '--ndim', '3']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(_REPO), "PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert "kernel: ftcs3d on 512x512x512 bfloat16" in out.stdout
    assert "kernel (on the card" in out.stdout


@pytest.mark.parametrize("bc", ["edges", "ghost", "periodic"])
@pytest.mark.parametrize("ndim,n,dt,fuse,ntime,beat", [
    (2, 40, "float32", 16, 40, 0), (2, 40, "bfloat16", 7, 30, 4),
    (3, 20, "bfloat16", 16, 20, 0), (3, 18, "float32", 5, 12, 3)])
def test_launches_per_solve_are_the_passes_run(monkeypatch, bc, ndim, n, dt,
                                               fuse, ntime, beat):
    """``launches_per_solve`` (plan's count) against the passes a ``cuda``
    solve on the CPU runs outside its warm-up."""
    cfg = HeatConfig(n=n, ndim=ndim, dtype=dt, bc=bc, ntime=ntime,
                     fuse_steps=fuse, heartbeat_every=beat, backend="cuda",
                     sigma=0.15)
    counting = [False]
    seen = []
    real_pass = cuda_stencil._pass
    real_make = cuda_backend.make_advance

    def spy(*a, **kw):
        if counting[0]:
            seen.append(a[2])
        return real_pass(*a, **kw)

    def make(cfg_):
        advance, warm = real_make(cfg_)

        def counted(T, k):
            counting[0] = True
            try:
                return advance(T, k)
            finally:
                counting[0] = False

        return counted, warm

    monkeypatch.setattr(cuda_stencil, "_pass", spy)
    monkeypatch.setattr(cuda_backend, "make_advance", make)
    solve(cfg, device="cpu")
    assert len(seen) == cuda_backend.launches_per_solve(cfg)
    assert sum(seen) == ntime
