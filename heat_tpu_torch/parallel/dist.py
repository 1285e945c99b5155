"""Joining a multi-process world: ``torch.distributed`` from the
environment.

Counterpart of ``heat_tpu.parallel.dist`` and of the reference's MPI world
setup (``mpi_init``/``comm_rank``/``comm_size`` and the per-node GPU
binding, fortran/mpi+cuda/heat.F90:60-70). The world is described by the
variables ``torchrun`` and ``heat_tpu_torch launch`` set: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` (``LOCAL_WORLD_SIZE``), ``MASTER_ADDR`` and
``MASTER_PORT``. Without them the process is alone and nothing is joined.

The card is bound before the group is made (``cudaSetDevice`` by node-local
rank, :64-70): ``torch.cuda.set_device(LOCAL_RANK % device_count)``. The
default group is NCCL for a ``direct`` exchange on the card and gloo
otherwise; ``host_group`` is a gloo group for everything that goes through
host memory (the staged exchange, the gather of the field, the flags).

A joined process leaves its groups at exit (``atexit``, the reference's
``mpi_finalize``): a gloo group still alive when the interpreter tears down
destroys its threads while they are joinable, and the rank then dies of
``std::terminate`` (SIGABRT) after its work is done, at random, failing
the whole world under ``torchrun``.
"""

from __future__ import annotations

import atexit
import os
from typing import Optional

import torch
import torch.distributed as dist

_HOST_GROUP = None


def world_from_env() -> Optional[tuple]:
    """(rank, world size, local rank, local world size) from the torchrun
    variables, or None when the process was not started into a world."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return rank, world, local, local_world


def init_distributed(device, comm: str = "direct") -> Optional[torch.device]:
    """Join the world the environment describes; a no-op (returning None)
    for a process started alone or already joined. Returns this rank's
    device.

    NCCL refuses two ranks on one GPU ("Duplicate GPU detected"), so a
    ``direct`` exchange with more ranks on this host than cards raises,
    naming what runs instead; it never switches to staging on its own."""
    global _HOST_GROUP
    env = world_from_env()
    if env is None:
        return None
    rank, world, local, local_world = env
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if comm == "direct" and local_world > count:
            raise ValueError(
                f"--comm direct needs one GPU per rank (NCCL cannot put two "
                f"ranks on one GPU), but {local_world} ranks share {count} "
                f"GPU(s) on this host; use --comm staged (gloo over host "
                f"memory) or --virtual-devices N (all shards in one process)")
        device = torch.device("cuda", local % count)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" and comm == "direct" else "gloo"
    dist.init_process_group(backend=backend, rank=rank, world_size=world)
    _HOST_GROUP = (dist.new_group(backend="gloo") if backend != "gloo"
                   else dist.group.WORLD)
    atexit.register(leave_world)
    return device


def leave_world() -> None:
    """Destroy this process's groups (every one, the default group last);
    a no-op when none is joined. Registered at exit by
    ``init_distributed``."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def host_group():
    """The gloo group of the world (host tensors)."""
    return _HOST_GROUP if _HOST_GROUP is not None else dist.group.WORLD


def is_master() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def describe() -> str:
    """One line on the process group, for ``info``."""
    if dist.is_initialized():
        return (f"process group: rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, backend {dist.get_backend()}")
    env = world_from_env()
    avail = (f"nccl {'available' if dist.is_nccl_available() else 'missing'}, "
             f"gloo {'available' if dist.is_gloo_available() else 'missing'}")
    if env is None:
        return f"process group: none (a single process; {avail})"
    return (f"process group: not joined yet, environment rank {env[0]} of "
            f"{env[1]} ({avail})")
