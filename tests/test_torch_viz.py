"""heat_tpu_torch.viz against heat_tpu.viz, and ``viz`` without matplotlib.

A ``.dat`` file written by the port's solve renders, through the port's
``viz``, to the pixels of the reference's render of the same file, in 2D
and as the 3D mid-plane slice. Where matplotlib is missing (the card's
host), ``viz`` exits non-zero naming it and writes nothing.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from heat_tpu.viz import render_dat as ref_render
from heat_tpu_torch.cli import main

_REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("ndim,dat", [(2, "24 0.25 0.05 2.0 5 1"),
                                      (3, "12 0.15 0.05 2.0 2 1")])
def test_render_matches_the_reference_pixels(tmp_cwd, ndim, dat):
    image = pytest.importorskip("matplotlib.image")
    (tmp_cwd / "input.dat").write_text(dat + "\n")
    assert main(["run", "--backend", "serial", "--dtype", "float64",
                 "--ndim", str(ndim)]) == 0
    assert main(["viz", "soln.dat", "--ndim", str(ndim), "--save",
                 "port.png"]) == 0
    ref_render("soln.dat", "ref.png", ndim=ndim)
    got, want = image.imread("port.png"), image.imread("ref.png")
    assert got.shape == want.shape and got.shape[0] > 100
    assert (got == want).all()


def test_viz_without_matplotlib_fails_naming_it(tmp_cwd):
    (tmp_cwd / "input.dat").write_text("16 0.25 0.05 2.0 2 1\n")
    assert main(["run", "--backend", "serial", "--dtype", "float64"]) == 0
    code = ("import runpy, sys\n"
            "sys.modules['matplotlib'] = None\n"
            "sys.argv = ['heat_tpu_torch', 'viz', 'soln.dat', '--save', "
            "'hidden.png']\n"
            "runpy.run_module('heat_tpu_torch', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_cwd,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(_REPO),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "matplotlib" in out.stderr and "Traceback" not in out.stderr
    assert not (tmp_cwd / "hidden.png").exists()
