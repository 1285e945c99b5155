"""A world of ranks for a cell on several cards, started by the benchmark.

The process the benchmark was started as is rank 0; it starts ranks
1..W-1 as children running the same command with ``--rank``, on a free
localhost port, and each rank joins the world the way the port's own
``launch`` workers join it: the torchrun variables in the environment,
then ``heat_tpu_torch.parallel.dist.init_distributed`` (NCCL on the card
for the direct exchange, a gloo group beside it for host tensors). The
children write to standard error only, so the result line of rank 0 is
the last line of standard output. A watchdog ends the world when a child
fails (a rank blocked in a collective would wait forever), and rank 0
waits for every child before it exits.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional

import torch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


class World:
    """Rank 0's handle on the children it started."""

    def __init__(self, argv: List[str], world: int):
        self.port = free_port()
        self.children: List[subprocess.Popen] = []
        self._done = threading.Event()
        for rank in range(1, world):
            env = dict(os.environ, **world_env(rank, world, self.port))
            self.children.append(subprocess.Popen(
                [sys.executable, *argv, "--rank", str(rank)], env=env,
                stdin=subprocess.DEVNULL, stdout=sys.stderr, stderr=sys.stderr))
        os.environ.update(world_env(0, world, self.port))
        self._watch = threading.Thread(target=self._watchdog, daemon=True,
                                       name="cellbench-watchdog")
        self._watch.start()

    def _watchdog(self) -> None:
        while not self._done.wait(0.5):
            for rank, child in enumerate(self.children, 1):
                rc = child.poll()
                if rc not in (None, 0):
                    print(f"cellbench: rank {rank} exited rc={rc}; ending "
                          f"the world", file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(1)

    def kill(self) -> None:
        for child in self.children:
            if child.poll() is None:
                child.kill()
        for child in self.children:
            child.wait()

    def join(self, timeout: float = 120.0) -> int:
        """Wait for every child (rc 0 each); kill what is left at the
        timeout. Returns the first non-zero exit code, else 0."""
        self._done.set()
        deadline = time.monotonic() + timeout
        rc = 0
        for child in self.children:
            try:
                got = child.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                got = 124
            rc = rc or got
        self.kill()
        return rc


def join_world(device: str, comm: str) -> torch.device:
    """Join the world the environment describes (``init_distributed``);
    this rank's device."""
    from heat_tpu_torch.parallel.dist import init_distributed

    return init_distributed(device, comm=comm)


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def host_group():
    from heat_tpu_torch.parallel.dist import host_group as group

    return group()


def broadcast_int(value: Optional[int]) -> int:
    """Rank 0's integer on every rank (over the gloo group)."""
    import torch.distributed as dist

    if size() == 1:
        return int(value)
    t = torch.tensor([0 if value is None else int(value)], dtype=torch.int64)
    dist.broadcast(t, src=0, group=host_group())
    return int(t.item())


def gather_objects(obj) -> Optional[list]:
    """Every rank's ``obj`` on rank 0 (in rank order), None elsewhere."""
    import torch.distributed as dist

    if size() == 1:
        return [obj]
    out = [None] * size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0, group=host_group())
    return out


def barrier() -> None:
    import torch.distributed as dist

    if size() > 1:
        dist.barrier(group=host_group())


def gather_blocks(block: torch.Tensor, slices, n: int) -> Optional[torch.Tensor]:
    """The whole field on rank 0's device from every rank's owned ``block``
    at global ``slices``; None on the other ranks. The blocks travel as
    one batch of point-to-point operations on the world's default group
    (NCCL between cards, gloo on the host), in the communicator the
    program's exchange already made."""
    import torch.distributed as dist

    block = block.contiguous()
    if size() == 1:
        out = torch.empty((n,) * block.dim(), dtype=block.dtype,
                          device=block.device)
        out[tuple(slices)] = block
        return out
    on_host = dist.get_backend() == "gloo"
    wire = block.cpu() if on_host else block
    where = gather_objects([(s.start, s.stop) for s in slices])
    if rank() != 0:
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, wire, 0)]):
            req.wait()
        return None
    out = torch.empty((n,) * block.dim(), dtype=block.dtype,
                      device=block.device)
    out[tuple(slices)] = block
    bufs = {src: torch.empty([b - a for a, b in where[src]], dtype=block.dtype,
                             device=wire.device) for src in range(1, size())}
    ops = [dist.P2POp(dist.irecv, buf, src) for src, buf in bufs.items()]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for src, buf in bufs.items():
        out[tuple(slice(a, b) for a, b in where[src])] = buf.to(block.device)
    return out
