"""Text dataset IO: the ``int.dat`` / ``soln.dat`` contract.

File format (fortran/serial/heat.f90:50-55, 77-83): one whitespace-separated
``x y T`` triplet per line (``x y z T`` quadruplet for the 3-D extension),
row-major — outer loop over the x index, inner over y — n^2 lines total.
The reference's viz scripts regex-split each line (fortran/serial/out.py:17-25),
so any whitespace/precision works; we write %.17g for f64 round-tripping.

A C++ fast path (``native/fastio.cpp``, loaded via ctypes) accelerates the
O(n^2)-line text dump; numpy is the always-available fallback. Both are the
same as ``heat_tpu.io``'s, so the two packages write identical bytes.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from .native import fast_write_triplets


def _triplet_table(axes: Tuple[np.ndarray, ...], T: np.ndarray) -> np.ndarray:
    """Flatten coords+field into an (N, ndim+1) float64 table in file order."""
    grids = np.meshgrid(*axes, indexing="ij")
    cols = [g.reshape(-1) for g in grids] + [np.asarray(T, np.float64).reshape(-1)]
    return np.column_stack([np.asarray(c, np.float64) for c in cols])


def write_dat(path, axes: Tuple[np.ndarray, ...], T: np.ndarray) -> None:
    table = _triplet_table(axes, T)
    if not fast_write_triplets(str(path), table):
        with open(path, "w") as f:
            np.savetxt(f, table, fmt="%.17g")


def write_int_dat(path, axes, T0) -> None:
    """Pre-solve dump (fortran/serial/heat.f90:50-55)."""
    write_dat(path, axes, T0)


def write_soln(path, axes, T) -> None:
    """Post-solve dump (fortran/serial/heat.f90:77-83)."""
    write_dat(path, axes, T)


def _write_block(directory: Path, prefix: str, axes, coords, mesh_shape,
                 local: np.ndarray) -> Path:
    rank = int(np.ravel_multi_index(tuple(coords), tuple(mesh_shape)))
    local_axes = tuple(ax[c * s:(c + 1) * s]
                       for ax, c, s in zip(axes, coords, local.shape))
    path = directory / f"{prefix}{rank:05d}.dat"
    write_dat(path, local_axes, local)
    return path


def write_soln_sharded(directory, axes, shards: Sequence[Tuple[int, np.ndarray]],
                       mesh_shape, prefix: str = "soln") -> list:
    """Per-shard solution files ``soln#####.dat`` of the shards this
    process holds, ``(linear mesh index, owned block)`` each
    (fortran/mpi+cuda/heat.F90:277-288): each rank of a multi-process run
    writes its own."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    return [_write_block(directory, prefix, axes,
                         np.unravel_index(rank, tuple(mesh_shape)),
                         mesh_shape, np.asarray(local))
            for rank, local in shards]


def write_soln_blocks(directory, axes, T: np.ndarray, mesh_shape,
                      prefix: str = "soln") -> list:
    """Per-shard solution files from the gathered host field: one
    ``soln#####.dat`` per mesh block, shard number = linear mesh index —
    the single-process form of the reference's per-rank dumps."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    local = [T.shape[d] // s for d, s in enumerate(mesh_shape)]
    return [_write_block(directory, prefix, axes, coords, mesh_shape,
                         T[tuple(slice(c * lp, (c + 1) * lp)
                                 for c, lp in zip(coords, local))])
            for coords in itertools.product(*[range(s) for s in mesh_shape])]


def read_dat(path, ndim: int = 2):
    """Read a .dat file back into (axes, T). Assumes the square row-major
    layout the writers produce (matches fortran/serial/out.py:27-36)."""
    table = np.loadtxt(path)
    ncols = table.shape[1]
    if ncols != ndim + 1:
        raise ValueError(f"{path}: expected {ndim + 1} columns, got {ncols}")
    npoints = table.shape[0]
    shape = tuple(len(np.unique(table[:, d])) for d in range(ndim))
    if int(np.prod(shape)) != npoints:
        raise ValueError(
            f"{path}: {npoints} lines inconsistent with inferred grid {shape}"
        )
    T = table[:, -1].reshape(shape)
    axes = []
    for d in range(ndim):
        col = table[:, d].reshape(shape)
        sl = [0] * ndim
        sl[d] = slice(None)
        axes.append(col[tuple(sl)])
    return tuple(axes), T
