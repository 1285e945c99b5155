"""The communicators of the sharded backend: how a halo slab reaches the
neighbouring shard.

JAX's ``lax.ppermute`` moves every shard's slab at once inside one
program; here one interface does it for the shards this process holds, so
the halo code (``parallel.halo``) is written once:

- ``LocalComm`` holds every shard of the mesh in this process (the
  counterpart of a single-process JAX mesh, ``--virtual-devices N``):
  shard ``i`` lives on ``cuda:(i % device_count)``, or on the CPU. A
  ``direct`` exchange hands the halo code the neighbour's slab itself, and
  the ghost write is the one slice copy; ``staged`` sends every slab through
  host memory, D2H into a pinned buffer and H2D back (the NO_AWARE path of
  fortran/mpi+cuda/heat.F90:162-168, ``heat_tpu.parallel.halo``'s
  ``_stage_through_host``).
- ``DistComm`` holds one shard, that of this rank of a ``torch.distributed``
  world (``heat_tpu_torch launch``, ``torchrun``). ``direct`` sends device
  slabs point to point (``batch_isend_irecv``: NCCL on the card, gloo on
  the CPU); ``staged`` copies them to pinned host tensors and sends those
  over the world's gloo group.

A neighbour that is the shard itself (a periodic axis of size 1) gets a
local copy, never a send to self. Each communicator counts the exchanges
and the bytes its shards received (``stats``).

An exchange is split in two halves so that work can run while it flies
(``--exchange overlap``): ``post(axis, sends)`` starts it and returns its
finish, which gives each shard's received slabs. On the card the halves
leave the host free and order the card's streams: ``DistComm`` direct
posts NCCL's sends and receives (NCCL's stream waits on the work enqueued
before the post) and its finish makes the current stream wait; a staged
exchange copies the send slabs to the host on a side stream (after an
event on the field), so the host's gloo wait sits behind whatever the
current stream runs meanwhile; ``LocalComm`` staged runs its round trips
on a side stream, and its finish makes the current stream wait. Every
tensor used across streams is recorded on the stream that uses it
(``Tensor.record_stream``), so the caching allocator does not reuse its
memory early. On the CPU a post does the whole exchange.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import RankMesh

Pair = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]
Finish = Callable[[], List[Pair]]


def stage_to_host(t: torch.Tensor, non_blocking: bool = False) -> torch.Tensor:
    """A host copy of a slab: D2H into pinned memory from the card, a plain
    copy on the CPU. Every staged slab goes through here. With
    ``non_blocking`` the D2H is only enqueued on the current stream."""
    pin = t.device.type == "cuda"
    host = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=pin)
    host.copy_(t, non_blocking=non_blocking and pin)
    return host


@functools.lru_cache(maxsize=None)
def _side_stream(index: int) -> torch.cuda.Stream:
    """The side stream of card ``index`` in this process, made on first
    use."""
    return torch.cuda.Stream(index)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bf16 travels over gloo as its bytes (gloo takes no bf16 or int16)."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


class LocalComm:
    """Every shard of ``mesh`` in this process."""

    def __init__(self, mesh: RankMesh, device, staged: bool = False):
        device = torch.device(device)
        self.mesh = mesh
        self.staged = staged
        self.ranks = list(range(mesh.size))
        if device.type == "cuda":
            count = torch.cuda.device_count()
            self.devices = [torch.device("cuda", i % count) for i in self.ranks]
        else:
            self.devices = [device] * mesh.size
        self.stats = {"exchanges": 0, "bytes": 0}

    def _move(self, slab: torch.Tensor, device, side) -> torch.Tensor:
        """The slab on ``device``: itself where no copy is needed (direct,
        same device), a round trip through host memory on ``side`` (staged
        on the card), else a copy on the current streams."""
        self.stats["bytes"] += slab.numel() * slab.element_size()
        if not self.staged:
            return slab if slab.device == device else slab.to(device)
        if side is None or slab.device != device:
            return stage_to_host(slab).to(device)
        with torch.cuda.stream(side):
            slab.record_stream(side)
            got = stage_to_host(slab, non_blocking=True).to(device,
                                                            non_blocking=True)
        got.record_stream(torch.cuda.current_stream(device))
        return got

    def post(self, axis: int, sends: Sequence[Pair]) -> Finish:
        """Start the exchange of ``axis``. ``sends[i] = (send_lo,
        send_hi)`` of local shard i; the finish returns each shard's
        ``(from_prev, from_next)``: the previous neighbour's ``send_hi``
        and the next one's ``send_lo``, None at a global edge."""
        sides = set()
        out = []
        for i, rank in enumerate(self.ranks):
            dev = self.devices[i]
            side = None
            if self.staged and dev.type == "cuda":
                side = _side_stream(dev.index)
                if side not in sides:   # the sends are ready
                    side.wait_stream(torch.cuda.current_stream(dev))
                    sides.add(side)
            prev, nxt = self.mesh.neighbors(rank, axis)
            out.append(tuple(None if j is None
                             else self._move(sends[j][k], dev, side)
                             for j, k in ((prev, 1), (nxt, 0))))
        if axis == 0:
            self.stats["exchanges"] += 1

        def finish() -> List[Pair]:
            for side in sides:
                torch.cuda.current_stream(side.device).wait_stream(side)
            return out

        return finish

    def sync(self) -> None:
        for dev in sorted({d.index for d in self.devices if d.type == "cuda"}):
            torch.cuda.synchronize(dev)

    def gather(self, blocks: Sequence[torch.Tensor], n: int) -> torch.Tensor:
        """The global owned field on the host, from every shard's block."""
        shape = (n,) * blocks[0].dim()
        out = torch.empty(shape, dtype=blocks[0].dtype)
        for rank, b in zip(self.ranks, blocks):
            out[self.mesh.block(rank, n)] = b.cpu()
        return out

    def all_true(self, flag: bool) -> bool:
        return bool(flag)

    def broadcast(self, value):
        return value


class DistComm:
    """The one shard of this rank of the ``torch.distributed`` world."""

    def __init__(self, mesh: RankMesh, device, staged: bool = False):
        from .dist import host_group

        if mesh.size != dist.get_world_size():
            raise ValueError(
                f"mesh {mesh.shape} has {mesh.size} shards but the world has "
                f"{dist.get_world_size()} ranks (one shard per rank)")
        self.mesh = mesh
        self.staged = staged
        self.ranks = [dist.get_rank()]
        self.devices = [torch.device(device)]
        self.host = host_group()
        # slabs go over gloo when staged or on the CPU, else over NCCL
        self.group = (self.host if staged or self.devices[0].type == "cpu"
                      else dist.group.WORLD)
        self.stats = {"exchanges": 0, "bytes": 0}
        # every rank joins before the first exchange (NCCL's first call in a
        # group must be one all ranks make)
        dist.barrier()

    @property
    def rank(self) -> int:
        return self.ranks[0]

    def post(self, axis: int, sends: Sequence[Pair]) -> Finish:
        """Start the exchange of ``axis`` (see ``LocalComm.post``): direct
        posts the sends and receives now; staged enqueues the D2H of the
        send slabs on a side stream and sends them over gloo at the
        finish."""
        dev = self.devices[0]
        lo, hi = (s.contiguous() for s in sends[0])
        if not self.staged:
            return self._p2p(axis, lo, hi)
        if dev.type != "cuda":
            return self._p2p(axis, stage_to_host(lo), stage_to_host(hi))
        side = _side_stream(dev.index)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for t in (lo, hi):
                t.record_stream(side)
            lo, hi = (stage_to_host(t, non_blocking=True) for t in (lo, hi))
            staged = torch.cuda.Event()
            staged.record(side)

        def finish() -> List[Pair]:
            staged.synchronize()
            return self._p2p(axis, lo, hi)()

        return finish

    def _p2p(self, axis: int, lo: torch.Tensor, hi: torch.Tensor) -> Finish:
        """Post this rank's sends (hi to next, lo to prev) and receives;
        the finish waits for them and returns the received slabs on the
        card."""
        rank = self.rank
        dev = self.devices[0]
        prev, nxt = self.mesh.neighbors(rank, axis)
        gloo = self.group is self.host
        pin = self.staged and dev.type == "cuda"
        ops, recvs = [], {}
        # sends in the order (hi to next, lo to prev), receives in the order
        # (from prev, from next): with two messages between one pair of
        # ranks (a periodic axis of size 2) NCCL matches them in order,
        # gloo by tag
        for peer, t, tag in ((nxt, hi, 0), (prev, lo, 1)):
            if peer is not None and peer != rank:
                ops.append(dist.P2POp(dist.isend, _wire(t) if gloo else t,
                                      peer, self.group, tag))
        for key, peer, like, tag in (("prev", prev, hi, 0),
                                     ("next", nxt, lo, 1)):
            if peer is None:
                recvs[key] = None
            elif peer == rank:
                recvs[key] = (like if self.staged or like.device == dev
                              else like.to(dev)).clone()
            else:
                buf = torch.empty(like.shape, dtype=like.dtype,
                                  device=like.device, pin_memory=pin)
                recvs[key] = buf
                ops.append(dist.P2POp(dist.irecv, _wire(buf) if gloo else buf,
                                      peer, self.group, tag))
        reqs = dist.batch_isend_irecv(ops) if ops else []
        if axis == 0:
            self.stats["exchanges"] += 1

        def finish() -> List[Pair]:
            # on NCCL a wait makes the current stream wait; on gloo it
            # blocks the host
            for req in reqs:
                req.wait()
            out = []
            for key in ("prev", "next"):
                t = recvs[key]
                if t is not None:
                    self.stats["bytes"] += t.numel() * t.element_size()
                    if t.device != dev:
                        t = t.to(dev, non_blocking=pin)
                out.append(t)
            return [tuple(out)]

        return finish

    def sync(self) -> None:
        dev = self.devices[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    def gather(self, blocks: Sequence[torch.Tensor], n: int) -> Optional[torch.Tensor]:
        """The global owned field on rank 0's host (None on other ranks),
        gathered over the gloo group."""
        b = blocks[0].contiguous().cpu()
        if self.rank != 0:
            dist.gather(_wire(b), None, dst=0, group=self.host)
            return None
        parts = [torch.empty_like(b) for _ in range(self.mesh.size)]
        dist.gather(_wire(b), [_wire(p) for p in parts], dst=0,
                    group=self.host)
        out = torch.empty((n,) * b.dim(), dtype=b.dtype)
        for rank, p in enumerate(parts):
            out[self.mesh.block(rank, n)] = p
        return out

    def all_true(self, flag: bool) -> bool:
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.host)
        return bool(t.item())

    def broadcast(self, value):
        """Rank 0's float (or None) on every rank."""
        t = torch.tensor([value is None, 0.0 if value is None else value],
                         dtype=torch.float64)
        dist.broadcast(t, src=0, group=self.host)
        return None if t[0] else float(t[1])
