"""Halo (ghost) exchange between the shards of a mesh.

Counterpart of ``heat_tpu.parallel.halo`` and of the reference's swap
machinery (``fortran/mpi+cuda/heat.F90:143-195``, the HIP pack/unpack
kernels ``fortran/hip/heat_kernel.cpp:63-150``): slabs of the owned edge
travel to the neighbours' ghost slots through a communicator
(``parallel.comm``); at a global domain edge, with no neighbour
(``mpi_proc_null``), the ghosts are pinned to the Dirichlet ``bc_value``
unless the mesh is periodic.

Each function takes the list of padded shards this process holds, of shape
``(nx+2w, ny+2w[, nz+2w])`` (owned cells inside a ``w``-cell ghost ring),
and writes their ghost rings in place. The exchange is the reference's
``indep`` formulation: every send slab cut from the array as it was before
the exchange, with the earlier axes' received corners stitched in
(``halo_recvs``), then all ghost writes (``apply_recvs``, later axes own
the corners). That gives in every cell the bytes of the reference's
``seq`` form (axes in sequence with full-extent slabs), so corner ghosts
hold true diagonal-neighbour data, what fused multi-step updates read;
``--exchange seq`` runs it too.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F


def _slab(nd: int, d: int, sl: slice) -> tuple:
    out = [slice(None)] * nd
    out[d] = sl
    return tuple(out)


def _or_bc(recv, like: torch.Tensor, bc_value) -> torch.Tensor:
    """The received slab, or ``bc_value`` where there is no neighbour."""
    return torch.full_like(like, bc_value) if recv is None else recv


def post_axis(padded: Sequence[torch.Tensor], recvs: Dict[int, List[tuple]],
              d: int, comm, bc_value, width: int = 1) -> Callable[[], list]:
    """Start axis ``d``'s exchange of the indep form; returns its finish,
    which gives ``[(from_prev, from_next) per local shard]``. The send
    slabs span the full padded extent of the other axes, with the earlier
    axes' received corners (``recvs[e]``, e < d) stitched in; a global
    edge's slab holds ``bc_value``."""
    nd = padded[0].dim()
    w = width
    lo_sl, hi_sl = slice(w, 2 * w), slice(-2 * w, -w)
    sends = []
    for i, p in enumerate(padded):
        send_lo = p[_slab(nd, d, lo_sl)]
        send_hi = p[_slab(nd, d, hi_sl)]
        if d:
            # corner forwarding: the earlier axes' margins of the send
            # slab get those axes' fresh ghosts (what the sequential
            # scheme reads from the written array)
            send_lo, send_hi = send_lo.clone(), send_hi.clone()
            for e in range(d):
                ep, en = recvs[e][i]
                send_lo[_slab(nd, e, slice(0, w))] = ep[_slab(nd, d, lo_sl)]
                send_lo[_slab(nd, e, slice(-w, None))] = en[_slab(nd, d, lo_sl)]
                send_hi[_slab(nd, e, slice(0, w))] = ep[_slab(nd, d, hi_sl)]
                send_hi[_slab(nd, e, slice(-w, None))] = en[_slab(nd, d, hi_sl)]
        sends.append((send_lo, send_hi))
    finish = comm.post(d, sends)

    def done() -> list:
        return [(_or_bc(fp, lo, bc_value), _or_bc(fn, hi, bc_value))
                for (lo, hi), (fp, fn) in zip(sends, finish())]

    return done


def halo_recvs(padded: Sequence[torch.Tensor], comm, bc_value,
               width: int = 1) -> Dict[int, List[tuple]]:
    """The receive half of the indep exchange: ``{d: [(from_prev,
    from_next) per local shard]}``, axis by axis (``post_axis``)."""
    recvs: Dict[int, List[tuple]] = {}
    for d in range(len(comm.mesh.shape)):
        recvs[d] = post_axis(padded, recvs, d, comm, bc_value, width)()
    return recvs


def apply_recvs(padded: Sequence[torch.Tensor], recvs: Dict[int, List[tuple]],
                width: int = 1) -> Sequence[torch.Tensor]:
    """Write the received slabs into the ghost margins (the write half of
    the indep exchange), axis by axis over all shards: later axes own the
    corners, and no shard's slab is read after an axis wrote into it."""
    w = width
    nd = padded[0].dim()
    for d in sorted(recvs):
        for p, (from_prev, from_next) in zip(padded, recvs[d]):
            p[_slab(nd, d, slice(0, w))] = from_prev
            p[_slab(nd, d, slice(-w, None))] = from_next
    return padded


def halo_exchange(padded: Sequence[torch.Tensor], comm, bc_value,
                  width: int = 1) -> Sequence[torch.Tensor]:
    """Refresh the ``width``-cell ghost ring of every local shard."""
    return apply_recvs(padded, halo_recvs(padded, comm, bc_value, width),
                       width)


def halo_pad(local: torch.Tensor, bc_value, width: int = 1) -> torch.Tensor:
    """Allocate the ghost ring around an owned shard (ghosts = bc_value)."""
    value = torch.tensor(bc_value, dtype=local.dtype).item()
    return F.pad(local, (width, width) * local.dim(), mode="constant",
                 value=value)
