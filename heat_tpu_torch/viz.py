"""Visualization: 3-D surface plots of .dat files.

Counterpart of ``heat_tpu/viz.py``, the one renderer standing in for the
reference's ``init.py``/``out.py`` copies: matplotlib ``plot_surface`` with
viridis, x,y over the file's axes, z in [1, 2.5] (fortran/serial/out.py:
37-41), saved to a file (the mpi variant's ``sol.eps``,
fortran/mpi+cuda/out.py:45) rather than shown. The 3D extension's
``x y z T`` files render as their mid-plane z-slice.

matplotlib is the one dependency outside the port's own; where it is
missing (the card's host has none), ``render_dat`` raises
``MissingDependency`` naming it, and ``viz`` exits non-zero without a file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .io import read_dat


class MissingDependency(RuntimeError):
    """A package the renderer needs is not installed."""


def _pyplot():
    try:
        import matplotlib
    except ModuleNotFoundError as e:
        raise MissingDependency(
            "viz needs matplotlib, which is not installed here; install "
            "matplotlib, or render the .dat file on a host that has it "
            "(the reference's out.py reads it too)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    return plt, cm


def render_dat(path, save="sol.png", ndim: int = 2, zlim=(1.0, 2.5)):
    """Render a .dat dump as the reference-style 3-D surface (for ``ndim``
    3, its mid-plane z-slice) into ``save``; returns the path written."""
    if ndim not in (2, 3):
        raise ValueError(f"render_dat supports ndim 2 or 3, got {ndim}")
    plt, cm = _pyplot()
    if ndim == 3:
        (x, y, _z), T3 = read_dat(path, ndim=3)
        T = T3[:, :, T3.shape[2] // 2]
    else:
        (x, y), T = read_dat(path, ndim=2)
    X, Y = np.meshgrid(x, y, indexing="ij")
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(X, Y, T, rstride=1, cstride=1, cmap=cm.viridis,
                    linewidth=0, antialiased=False)
    ax.set_xlim(float(x.min()), float(x.max()))
    ax.set_ylim(float(y.min()), float(y.max()))
    ax.set_zlim(*zlim)
    ax.set_xlabel("$x$")
    ax.set_ylabel("$y$")
    out = Path(save)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out
