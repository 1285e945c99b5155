"""Seeded initial fields, a function of the global index and the seed.

Every cell of a field gets ``lo + span * u`` with ``u`` in [0, 1) taken
from a 32-bit integer hash of the cell's global flat index, the seed and
the field's number. The value depends on nothing else: a shard of the
field built on its own device holds the same bytes as the same cells of
the whole field built anywhere else, so each rank makes its own shard and
the reference makes the whole field. The integer arithmetic is exact on
every device; ``u`` has 24 bits and the sum is formed in float64, then
rounded once to the field's dtype.

The configuration's ``ic`` is ``{"kind": "seeded_uniform", "lo": .., "span": ..}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
ROWS_PER_CHUNK = 1024


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def keys(seed: int, index: int) -> tuple:
    """Two 32-bit keys of field ``index`` under ``seed`` (any integer)."""
    h = _splitmix64(_splitmix64(int(seed) & _MASK64) ^ int(index))
    return h & _MASK32, (h >> 32) & _MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), without int64
    overflow: the constant goes in as two 16-bit halves."""
    hi = torch.bitwise_and(x * (c >> 16), 0xFFFF) << 16
    return torch.bitwise_and(hi + x * (c & 0xFFFF), _MASK32)


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift and multiply rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(g: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """[0, 1) in float64, 24 bits, from the global flat indices ``g``."""
    h = _hash32(_hash32(g ^ k0) ^ k1)
    return (h >> 8).to(torch.float64) * (1.0 / (1 << 24))


def field(ic: dict, seed: int, index: int, n: int, ndim: int,
          block: Optional[Sequence[slice]] = None, device="cpu",
          dtype=torch.float32) -> torch.Tensor:
    """Cells ``block`` (global slices per axis; default the whole field) of
    seeded field ``index`` of an ``n``-per-side ``ndim``-D field, on
    ``device``, built in chunks of leading rows so the int64 temporaries
    stay small."""
    if ic.get("kind") != "seeded_uniform":
        raise ValueError(f"unknown ic kind {ic.get('kind')!r}")
    if n ** ndim > 1 << 32:
        raise ValueError("the global flat index has to fit 32 bits")
    lo, span = float(ic["lo"]), float(ic["span"])
    k0, k1 = keys(seed, index)
    if block is None:
        block = (slice(0, n),) * ndim
    ranges = [range(n)[b] for b in block]
    out = torch.empty([len(r) for r in ranges], dtype=dtype, device=device)
    idx = [torch.arange(r.start, r.stop, r.step, dtype=torch.int64,
                        device=device) for r in ranges]
    # the flat index's stride of each axis
    strides = [n ** (ndim - 1 - d) for d in range(ndim)]
    tail = None
    for d in range(1, ndim):
        part = (idx[d] * strides[d]).view([-1 if e == d else 1
                                           for e in range(1, ndim)])
        tail = part if tail is None else tail + part
    for r0 in range(0, len(ranges[0]), ROWS_PER_CHUNK):
        rows = idx[0][r0:r0 + ROWS_PER_CHUNK] * strides[0]
        g = rows.view([-1] + [1] * (ndim - 1))
        if tail is not None:
            g = g + tail.unsqueeze(0)
        out[r0:r0 + ROWS_PER_CHUNK] = (lo + span * _uniform(g, k0, k1)).to(dtype)
    return out
