"""The cartesian topology of the sharded backend: which shard owns which
block, and who its neighbours are.

Counterpart of ``heat_tpu.parallel.mesh`` and of the reference's MPI
topology setup (``fortran/mpi+cuda/heat.F90:87-103``): ``MPI_Dims_create``
is ``auto_mesh_shape``, ``mpi_cart_create``/``cart_shift`` are a
``RankMesh``: the shape over the spatial axes ``x, y, z``, each shard's
coordinates (row-major: shard ``i`` has ``numpy.unravel_index(i, shape)``),
and its neighbours on each axis. A ring closes when ``periodic`` is set;
otherwise a shard on a global edge has no neighbour there
(``mpi_proc_null``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

MESH_AXES = ("x", "y", "z")


def auto_mesh_shape(ndev: int, ndim: int) -> Tuple[int, ...]:
    """Balanced factorization of ``ndev`` into ``ndim`` factors, largest
    factors on the leading (most-contiguous) axes — MPI_Dims_create semantics
    (fortran/mpi+cuda/heat.F90:87-90)."""
    factors = [1] * ndim
    remaining = ndev
    # greedy: repeatedly give the largest prime factor to the smallest axis
    primes = []
    k = 2
    while remaining > 1:
        while remaining % k == 0:
            primes.append(k)
            remaining //= k
        k += 1
    for p in sorted(primes, reverse=True):
        i = int(np.argmin(factors))
        factors[i] *= p
    return tuple(sorted(factors, reverse=True))


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A mesh of ``prod(shape)`` shards over the first ``len(shape)``
    spatial axes."""

    shape: Tuple[int, ...]
    periodic: bool = False

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return MESH_AXES[:len(self.shape)]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def coords(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def rank_of(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def neighbors(self, rank: int, axis: int) -> Tuple[Optional[int], Optional[int]]:
        """(previous, next) shard on ``axis``; None at a global edge of a
        non-periodic mesh. On a periodic axis of size 1 both are ``rank``."""
        c = list(self.coords(rank))
        size = self.shape[axis]
        out = []
        for step in (-1, 1):
            j = c[axis] + step
            if not 0 <= j < size:
                if not self.periodic:
                    out.append(None)
                    continue
                j %= size
            out.append(self.rank_of(c[:axis] + [j] + c[axis + 1:]))
        return out[0], out[1]

    def block(self, rank: int, n: int) -> Tuple[slice, ...]:
        """The global index range shard ``rank`` owns on each axis."""
        return tuple(slice(c * (n // s), (c + 1) * (n // s))
                     for c, s in zip(self.coords(rank), self.shape))


def build_mesh(ndim: int, nshards: int, mesh_shape=None,
               periodic: bool = False) -> RankMesh:
    """The mesh over ``nshards`` shards: ``mesh_shape`` when given (it may
    use fewer), else ``auto_mesh_shape``. Callers announce ``mesh.shape``
    once per job, like the reference ('Automatic MPI decomposition',
    fortran/mpi+cuda/heat.F90:90)."""
    shape = (tuple(int(s) for s in mesh_shape) if mesh_shape
             else auto_mesh_shape(nshards, ndim))
    if len(shape) != ndim:
        raise ValueError(f"mesh_shape {shape} must have {ndim} dims")
    n_used = int(np.prod(shape))
    if n_used > nshards:
        raise ValueError(f"mesh {shape} needs {n_used} devices, have {nshards}")
    return RankMesh(shape, periodic)


def validate_divisible(n_interior: int, mesh: RankMesh) -> None:
    """The reference requires grids to divide evenly over ranks
    (``nx = n/nblocks(1)`` with integer division, fortran/mpi+cuda/heat.F90:92);
    we keep the constraint but fail loudly (SURVEY.md §5)."""
    for ax, sz in zip(mesh.axis_names, mesh.shape):
        if n_interior % sz != 0:
            raise ValueError(
                f"grid dim {n_interior} does not divide evenly over mesh axis "
                f"{ax!r} of size {sz} (reference constraint, kept & validated)"
            )
