"""Page-locked host buffers for the drive loop's whole-field transfers.

A copy between the card and pageable host memory is staged by CUDA
through a bounce buffer, and a fetch into a freshly allocated array also
pays a page fault per page: a 4096² f32 field took 11–13 ms up and 34–38
ms down that way on an H100's host, against 1.7 and 1.6 ms by DMA from
page-locked memory. ``backends.common.upload_field`` and ``fetch_field``
take their buffers from :data:`POOL`; ``host_fetch`` and
``torch.tensor`` remain the pageable path where the pool declines.

The buffers come from PyTorch's caching host allocator
(``pin_memory=True``): a block goes back to it when the last reference to
the lent array, to a view of it or to a tensor ``torch.from_numpy`` made
of it is gone, so a result the caller still holds is never lent again and
never written, and the allocator keeps the block pinned for the next
request of its size. What the pool adds is the cap, and the rule that a
transfer takes the pageable path the first time its shape is asked for:
pinning a 4096² f32 field costs more than one pageable copy of it, so a
process that moves a field once never pins it.
"""

from __future__ import annotations

import collections
import math
import os
import weakref
from pathlib import Path, PurePosixPath
from typing import Callable, Optional

import numpy as np
import torch

from ..runtime import debug, trace

# The most page-locked memory the pool may have pinned: an eighth of the
# host's memory (the smaller of its physical memory and the limit of the
# process's cgroup, where one is set), and never less than 1 GiB. Memory
# pinned is taken from what the OS may page out, for the life of the
# process (the allocator keeps freed blocks cached), so it is a
# host-memory bound like ``async_io.DEFAULT_DEPTH`` is a device-memory
# bound, not a knob. A solve needs one staging buffer and one result
# buffer; the rest is what callers keep of earlier results. The bound is
# taken from the host, not counted in fields, because a field's size
# ranges over three orders: a fixed 1 GiB held 16 fields of 4096² f32 but
# only two of 512³ f32, fewer than a caller that keeps its last three
# results needs, and the transfers then went pinned or pageable by which
# results the caller happened to hold. An eighth of an H100 host's 96
# GiB holds 24 such fields.
MIN_CAP_BYTES = 1 << 30
CAP_SHARE = 8


def cgroup_limit_bytes(proc: str = "/proc/self/cgroup",
                       root: str = "/sys/fs/cgroup") -> Optional[int]:
    """The lowest memory limit set on this process's cgroups or their
    ancestors (v2 ``memory.max``, v1 ``memory.limit_in_bytes``), or None
    where none is set or none can be read."""
    limits = []
    try:
        lines = Path(proc).read_text().splitlines()
    except OSError:
        return None
    for line in lines:
        _, _, rest = line.partition(":")
        controllers, _, path = rest.partition(":")
        if controllers == "":
            base, name = Path(root), "memory.max"
        elif "memory" in controllers.split(","):
            base, name = Path(root, "memory"), "memory.limit_in_bytes"
        else:
            continue
        rel = PurePosixPath(path or "/")
        for d in (rel, *rel.parents):
            try:
                text = (base / d.relative_to("/") / name).read_text().strip()
            except (OSError, ValueError):
                continue
            if text.isdigit():
                limits.append(int(text))
    return min(limits) if limits else None


def host_memory_bytes() -> int:
    """The host memory this process may use: its physical memory, or its
    cgroup's limit where that is lower."""
    physical = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    limit = cgroup_limit_bytes()
    return physical if limit is None else min(physical, limit)


def host_cap_bytes(memory: Optional[int] = None) -> int:
    """The pool's cap for a host of ``memory`` bytes (default this one's,
    :func:`host_memory_bytes`): a :data:`CAP_SHARE`-th of it, at least
    :data:`MIN_CAP_BYTES`."""
    memory = host_memory_bytes() if memory is None else memory
    return max(MIN_CAP_BYTES, memory // CAP_SHARE)


CAP_BYTES = host_cap_bytes()

# Smaller fields take the pageable path: the pool is for the whole fields
# a card solves, which its cap counts in, not for small arrays.
MIN_BYTES = 1 << 20

# the paths a transfer takes, each a key of ``PinnedPool.tally`` and the
# name of the span around the copy
PATHS = tuple(trace.TRANSFER_PATHS)


def _pin(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def block_bytes(nbytes: int) -> int:
    """The bytes the caching host allocator pins for a request of
    ``nbytes``: rounded up to a power of two, the size class whose freed
    blocks serve later requests."""
    return 1 << max(nbytes - 1, 0).bit_length()


class PinnedPool:
    """Page-locked field buffers, lent as numpy arrays, at most
    ``cap_bytes`` of them pinned.

    ``lend(use, shape, dtype)`` hands out a buffer no one else holds, or
    None: on the first request of ``(use, shape, dtype)``, where the cap
    leaves no room, or where the allocator refuses. The allocator keeps
    each freed block cached for its size class, so the pool counts, for
    each size class, the most buffers of it lent at once, and that is what
    the cap bounds. ``alloc(shape, dtype)`` makes the host tensor (default:
    page-locked by PyTorch; tests give plain host tensors). ``device_type``
    is the device whose transfers the pool serves; ``tally`` counts the
    transfers by the path they took."""

    def __init__(self, cap_bytes: int = CAP_BYTES,
                 alloc: Callable = _pin, device_type: str = "cuda"):
        self.cap_bytes = cap_bytes
        self.device_type = device_type
        self._alloc = alloc
        # a leaf of its own rank: nothing is acquired under it
        self._lock = debug.make_lock("pinned:pool")
        self._asked: set = set()                  # (use, shape, dtype)
        self._lent = collections.Counter()        # block bytes -> lent now
        self._blocks = collections.Counter()      # block bytes -> most lent
        # block sizes given back, not yet counted: the last reference may
        # drop in any thread, under any lock, or in a garbage collection
        # that runs while this pool's own lock is held, so the return is a
        # lock-free append
        self._returned = collections.deque()
        self.tally = dict.fromkeys(PATHS, 0)

    def count(self, path: str) -> None:
        """One more transfer by ``path``, one of :data:`PATHS`."""
        with self._lock:
            self.tally[path] += 1

    @property
    def held_bytes(self) -> int:
        """Bytes the pool has had pinned, lent and cached."""
        with self._lock:
            return self._pinned()

    def _pinned(self) -> int:
        return sum(size * n for size, n in self._blocks.items())

    def lend(self, use: str, shape: tuple,
             dtype: torch.dtype) -> Optional[np.ndarray]:
        """An array of ``shape`` and ``dtype`` in a page-locked buffer that
        goes back when the last reference to the array, to a view of it
        or to a tensor ``torch.from_numpy`` made of it, is gone; None on
        the first request of ``(use, shape, dtype)``, where the cap leaves
        no room, or where the allocator refuses."""
        shape = tuple(int(s) for s in shape)
        size = block_bytes(math.prod(shape) * dtype.itemsize)
        with self._lock:
            while self._returned:
                self._lent[self._returned.popleft()] -= 1
            if (use, shape, dtype) not in self._asked:
                self._asked.add((use, shape, dtype))
                return None
            grown = max(self._lent[size] + 1 - self._blocks[size], 0)
            if self._pinned() + grown * size > self.cap_bytes:
                return None
            self._lent[size] += 1
            self._blocks[size] += grown
        try:
            arr = self._alloc(shape, dtype).numpy()
        except RuntimeError:
            # the allocator refused the pinned memory; PyTorch clears
            # CUDA's error as it raises, so the next launch is clean
            with self._lock:
                self._lent[size] -= 1
                self._blocks[size] = max(self._lent[size],
                                         self._blocks[size] - grown)
            return None
        # the array's base is the one tensor that owns the buffer
        weakref.finalize(arr.base, self._returned.append,
                         size).atexit = False
        return arr


# the drive loop's pool, and its tally, which ``run --trace`` prints
POOL = PinnedPool()
TALLY = POOL.tally
