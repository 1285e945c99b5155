"""Stacked simulation lanes: the device half of the serving engine.

The counterpart of ``heat_tpu.serve.engine``: packed lanes, and the
mega-lane (``MegaLaneEngine``, at the end of this module) for a request that
overflows every bucket. One chunk steps up to ``L`` independent solve
requests at once.
The requests of one *bucket* (same ndim/dtype/BC, grid side <= the bucket
side ``B``) are stacked into a single ``(L, B+2, ..., B+2)`` tensor — each
lane carries its request's field in the ``[1 : 1+n]`` corner of a
one-cell-margined bucket buffer, plus per-lane scalars: the stencil
coefficient ``r`` (each request's own ``cfg.r``), the request side ``n``,
and the remaining step count. Every lane computes the full bucket every
step, and a per-lane/per-cell mask decides what is *kept*:

- cells outside the request region keep their old value, so padding never
  contaminates physics;
- a lane whose ``remaining`` counter has hit zero keeps its whole field, so
  lanes finish at exactly their own step count and idle until swapped.

``ghost`` BC holds because the loader fills the whole lane buffer (margin
and unused corner) with ``bc_value`` and the mask never updates it;
``edges`` freezes the request's outer ring. ``periodic`` has no
padded-bucket form: the scheduler rejects it per request.

The chunk has two interchangeable bodies (``make_lane_advance``):
``"cuda"``, the hand-written lane kernels (``ops/cuda_lanes.lane_chunk``:
``lanes2d``/``lanes3d`` with the mask, the countdown gate, the finite bit
and the numerics stats fused in), and ``"torch"``, their plain PyTorch
version (f64 buckets: the two-rounding ``torch`` step). Both write the
same ``(K_BOUNDARY, L)`` int32 boundary vector: row 0 the remaining
counts, row 1 the finite bits, rows 2-5 four float32 stats bitcast
(``pack_boundary``/``unpack_boundary``).

Dispatch never fences: ``dispatch_chunk`` enqueues the chunk, then a
non-blocking copy of its boundary vector into pinned host memory and an
event (``runtime/async_io.d2h_async``), and returns that handle;
``fetch_boundary`` waits on that event alone, while the chunks queued
behind it keep the card busy. There is no buffer donation in torch: the
chunk ping-pongs between two preallocated stacks, and each chunk's
boundary vector is a fresh tensor that lives until its fetch. A finished
lane is cloned on the card and copied the same way (``lane_snapshot``),
so only the writer thread waits for its bytes.

Restorable stacks (``keep_input=True``, the scheduler's
``--serve-on-nan rollback``): the reference keeps each chunk's undonated
input stack as the previous boundary's snapshot. Here a chunk of three or
more passes would overwrite its input, so a keep-input engine runs each
chunk in keep-input mode (``cuda_lanes.lane_chunk(keep=...)``: the first
pass reads the live stack, the later ones ping-pong two fresh stacks from
the caching allocator) and never writes a stack after its chunk: the
post-chunk stack IS that boundary's snapshot (``snapshot_stack``), with no
copy on the dispatch path. A stack is freed once no chunk in flight and
no lane's last good state holds it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_lanes
from ..runtime.async_io import PendingCopy, d2h_async, lane_snapshot
from ..utils import torch_dtype

# BC -> first request-interior offset that updates: ghost updates every
# request cell (offset 0), edges freezes the outermost request ring (1).
# periodic is absent by design (see module docstring).
_BC_LO = {"ghost": 0, "edges": 1}

# The per-lane boundary vector's row layout: rows 0-1 plain int32, rows 2-5
# float32 statistics bitcast into the int32 carrier, so ONE array — one
# copy — carries progress, health and solution quality per lane per chunk.
BOUNDARY_ROWS = ("remaining", "finite", "resid", "tmin", "tmax", "heat")
K_BOUNDARY = len(BOUNDARY_ROWS)
assert K_BOUNDARY == cuda_lanes.K_BOUNDARY


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a numpy array of their own. bfloat16 comes
    out as numpy's two-byte void type ``V2`` holding the bf16 bits — what
    numpy stores for a bfloat16 array when no bfloat16 type is installed,
    so a published npz carries the reference's bytes."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy().view(np.dtype("V2"))
    return t.numpy().copy()


def bf16_to_float32(a: np.ndarray) -> np.ndarray:
    """Widen a ``V2`` bfloat16 array (``host_fetch``, a published npz)
    to float32, exactly."""
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def host_fetch(x) -> np.ndarray:
    """The ONE device->host fetch seam of the serve hot path.

    Every boundary inspection and lane extraction funnels through here, so
    tests can monkeypatch it to count fetches per boundary. A ``PendingCopy``
    is waited on (its own event only); a tensor still on the card is copied
    synchronously (the ``--dispatch-depth off`` shape)."""
    if isinstance(x, PendingCopy):
        x = x.wait()
    if isinstance(x, torch.Tensor):
        # heat-tpu: allow[hot-path-purity] THE sanctioned D2H seam itself
        return _to_numpy(x.detach().cpu())
    # heat-tpu: allow[hot-path-purity] THE sanctioned D2H seam itself
    return np.asarray(x)


def pack_boundary(remaining: torch.Tensor, finite: torch.Tensor,
                  stats: torch.Tensor) -> torch.Tensor:
    """Device-side boundary assembly: the int32 remaining/finite rows over
    the ``(4, L)`` float32 stats block bitcast to int32 (no rounding:
    NaN/Inf payloads survive). The inverse is ``unpack_boundary``."""
    out = torch.empty((K_BOUNDARY, remaining.shape[0]), dtype=torch.int32,
                      device=remaining.device)
    return cuda_lanes.write_boundary(out, remaining, finite, stats)


def unpack_boundary(b: np.ndarray) -> np.ndarray:
    """Host-side view of a fetched ``(K_BOUNDARY, L)`` boundary vector's
    stats block: rows 2-5 reinterpreted as float32, (resid, tmin, tmax,
    heat). A bit-level view, not a conversion."""
    return np.ascontiguousarray(b[2:K_BOUNDARY]).view(np.float32)


def lane_tier(needed: int, cap: int) -> int:
    """Round a wave's lane need up to the next power-of-two tier, capped at
    the configured lane budget (waves of 3 then 5 under ``cap=4`` both
    land on tier 4)."""
    if needed < 1 or cap < 1:
        raise ValueError(f"needed/cap must be >= 1, got {needed}/{cap}")
    t = 1
    while t < needed:
        t <<= 1
    return min(cap, t)


def tail_size(chunk: int) -> Optional[int]:
    """Size of the tail chunk: a quarter chunk (>= 1). When every live
    lane's remaining count drops below ``chunk``, stepping
    ``ceil(rem / tail)`` tail chunks computes at most ``rem + tail - 1``
    masked steps instead of a full ``chunk``. ``None`` for chunk 1."""
    return chunk // 4 if chunk >= 4 else (1 if chunk > 1 else None)


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """What must match for two requests to share a stacked lane array."""

    ndim: int
    n: int        # bucket side: requests with side <= n fit
    dtype: str
    bc: str

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        """Per-lane buffer shape: bucket side + one-cell margin each side."""
        return (self.n + 2,) * self.ndim


def lane_buffer(key: BucketKey, field: np.ndarray, bc_value: float) -> np.ndarray:
    """Host-side lane image of one request: a bucket buffer filled with
    ``bc_value`` (the ghost-BC invariant; harmless fill for edges) with the
    request field written into the ``[1 : 1+n]`` corner. (The engine builds
    the same image on its device: ``LaneEngine.load_lane``.)"""
    n = field.shape[0]
    if field.shape != (n,) * key.ndim:
        raise ValueError(f"request field {field.shape} is not square/cubic")
    if n > key.n:
        raise ValueError(f"request side {n} exceeds bucket {key.n}")
    buf = np.full(key.padded_shape, bc_value, dtype=np.float64)
    buf[tuple(slice(1, 1 + n) for _ in range(key.ndim))] = np.asarray(
        field, np.float64)
    return buf


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The per-lane r's dtype: f32 for f32/bf16 stacks, else the storage's."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def make_lane_advance(key: BucketKey, kernel: str):
    """The chunk body for one bucket: ``advance(fields, spare, r, n,
    remaining, k)`` runs ``k`` masked steps over every lane and returns
    ``(fields, spare, remaining, boundary)`` — the post-chunk stack, the
    other stack (the next chunk's scratch), the post-chunk remaining counts
    and the ``(K_BOUNDARY, L)`` boundary vector. With ``keep=`` a third
    stack, ``fields`` is only read (``cuda_lanes.lane_chunk``'s keep-input
    mode) and the returned scratch is whichever of ``spare``/``keep`` the
    chunk did not end in.

    ``kernel`` picks the body: ``"cuda"`` — the hand-written lane kernels
    (on CPU tensors, as every wrapper of the port, their plain version);
    ``"torch"`` — the plain PyTorch lane step. Both give the same bytes
    and the same remaining-count algebra (``max(rem - k, 0)``); gate
    ``"cuda"`` on ``resolve_lane_kernel``."""
    if kernel not in ("cuda", "torch"):
        raise ValueError(f"kernel must be 'cuda' or 'torch', got {kernel!r}")
    bc_lo = _BC_LO[key.bc]
    plain = kernel == "torch"

    def advance(fields, spare, r, n, remaining, k: int, keep=None):
        rem_out = torch.empty_like(remaining)
        boundary = torch.empty((K_BOUNDARY, fields.shape[0]),
                               dtype=torch.int32, device=fields.device)
        out = cuda_lanes.lane_chunk(fields, spare, r, n, remaining, rem_out,
                                    boundary, k, bc_lo, plain=plain,
                                    keep=keep)
        other = fields if keep is None else keep
        return out, (spare if out is other else other), rem_out, boundary

    return advance


def _host_tensor(field, dtype: torch.dtype) -> torch.Tensor:
    """A host field (numpy, or a tensor) as a CPU tensor of ``dtype``; a
    ``V2`` array holds bf16 bits and is taken bit for bit."""
    if isinstance(field, torch.Tensor):
        return field.to(dtype)
    a = np.ascontiguousarray(field)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a).to(dtype)


def make_lane_loader(key: BucketKey):
    """The lane swap: install one request into lane ``lane`` of the stack,
    in place and on the stack's device — fill the lane buffer with
    ``bc_value``, copy the request field into its corner, set the lane's
    scalars. Every write is enqueued behind the chunks in flight (a host
    field goes through pinned memory, never a synchronous copy). A host
    ``V2`` array holds bf16 bits and is installed bit for bit."""
    nd = key.ndim

    def load(fields, r, n, remaining, lane: int, field, r_new: float,
             n_new: int, steps_new: int, bc_value: float) -> None:
        buf = fields[lane]
        buf.fill_(bc_value)
        corner = buf[(slice(1, 1 + n_new),) * nd]
        if isinstance(field, np.ndarray):
            # bf16 bits as stored (a checkpoint field, a cache entry) are
            # installed as they are, no rounding
            field = _host_tensor(field, buf.dtype)
            if buf.device.type == "cuda":
                field = field.pin_memory()
        corner.copy_(field, non_blocking=True)
        # fill_ on the device: an item assignment of a host scalar is a
        # synchronous copy to the card, a fence per admission
        r[lane].fill_(r_new)
        n[lane].fill_(n_new)
        remaining[lane].fill_(steps_new)

    return load


def resolve_lane_kernel(requested: str, key: BucketKey, device) -> tuple:
    """Resolve the ``--serve-lane-kernel`` knob for ONE bucket into the body
    a lane engine runs, plus a fallback reason when the resolution is a
    degradation the operator should hear about.

    Returns ``(kernel, reason)``: ``kernel`` in {"cuda", "torch"};
    ``reason`` None for a clean resolution, a human string when a
    requested/expected kernel does not exist for the bucket — the scheduler
    turns that into a structured ``lane_kernel_fallback`` record plus a
    counter, never an error. Rules: ``"torch"`` — always torch; ``"cuda"``
    — the kernels where the bucket has one (f32/bf16), loud torch fallback
    otherwise (f64); ``"auto"`` — the kernels on a CUDA device where the
    bucket has one (loud fallback where not), torch on the CPU (policy,
    not a fallback: on CPU tensors the kernels' wrappers run the plain
    version anyway)."""
    if requested == "torch" or key.bc not in _BC_LO:
        return "torch", None
    if cuda_lanes.lane_kernel_available(key.ndim, key.dtype):
        if requested == "auto" and torch.device(device).type != "cuda":
            return "torch", None
        return "cuda", None
    if requested == "auto" and torch.device(device).type != "cuda":
        return "torch", None
    return "torch", (f"{key.dtype} has no lane kernel (the lane kernels "
                     f"take float32/bfloat16, as the reference's Pallas "
                     f"lanes do)")


class LaneEngine:
    """Device-side lane state for ONE (bucket, lane-tier) combination.

    The scheduler owns admission, dispatch depth and swap policy; this class
    owns the tensors: two stacks ping-ponged by the chunks, and the
    per-lane ``r`` / ``n`` / ``remaining`` vectors, all on ``device`` —
    ``cuda`` unless the caller names the CPU (raises without a card, as
    every entry point of the port does). ``kernel`` ``"auto"`` resolves as
    ``resolve_lane_kernel`` does: the lane kernels on the card where the
    bucket has one.
    Nothing is compiled per bucket: the kernels are built once per
    checkout (``ops/_build``); ``compile_s`` is what loading them took.
    ``keep_input`` makes every post-chunk stack a stable boundary snapshot
    (see the module docstring)."""

    def __init__(self, key: BucketKey, lanes: int, chunk: int,
                 kernel: str = "auto", device=None, keep_input: bool = False):
        from ..backends import resolve_device

        if key.bc not in _BC_LO:
            raise ValueError(
                f"bc {key.bc!r} has no lane form (periodic wraparound would "
                f"wrap at the bucket edge); supported: {sorted(_BC_LO)}")
        if lanes < 1 or chunk < 1:
            raise ValueError(f"lanes/chunk must be >= 1, got {lanes}/{chunk}")
        if kernel not in ("auto", "cuda", "torch"):
            raise ValueError(f"kernel must be 'auto', 'cuda' or 'torch', got "
                             f"{kernel!r}")
        self.device = resolve_device(device)
        # "auto" as the scheduler resolves it; a fallback's reason is kept
        # for the caller (the scheduler resolves and records it itself)
        self.fallback_reason = None
        if kernel == "auto":
            kernel, self.fallback_reason = resolve_lane_kernel(
                kernel, key, self.device)
        self.key = key
        self.lanes = lanes
        self.chunk = chunk
        self.kernel = kernel
        self.keep_input = keep_input
        self.tail = tail_size(chunk)
        dt = torch_dtype(key.dtype)
        shape = (lanes,) + key.padded_shape
        self._fields = torch.zeros(shape, dtype=dt, device=self.device)
        # keep-input engines take each chunk's two stacks fresh instead
        self._spare = None if keep_input else torch.empty_like(self._fields)
        self._r = torch.zeros(lanes, dtype=_acc_dtype(dt), device=self.device)
        self._n = torch.ones(lanes, dtype=torch.int32, device=self.device)
        self._rem = torch.zeros(lanes, dtype=torch.int32, device=self.device)
        self._load = make_lane_loader(key)
        self._advance = make_lane_advance(key, kernel=kernel)
        self.compile_s = 0.0
        if kernel == "cuda" and self.device.type == "cuda":
            from ..ops import _build

            t0 = time.perf_counter()
            _build.load(cuda_lanes._KERNELS[key.ndim])
            self.compile_s = time.perf_counter() - t0

    # --- lane I/O ---------------------------------------------------------
    def load_lane(self, lane: int, field, r: float, steps: int,
                  bc_value: float) -> None:
        """Install one request into ``lane``: its field (a tensor on the
        engine's device, or a host array) in the corner of a
        ``bc_value``-filled lane buffer, and its scalars."""
        n = field.shape[0]
        if tuple(field.shape) != (n,) * self.key.ndim or n > self.key.n:
            raise ValueError(f"request field {tuple(field.shape)} does not "
                             f"fit bucket {self.key}")
        self._load(self._fields, self._r, self._n, self._rem, lane, field,
                   float(r), n, int(steps), float(bc_value))

    def snapshot_lane(self, lane: int, n: int):
        """The request region of ``lane`` as a one-lane copy enqueued behind
        the chunks in flight (``async_io.lane_snapshot``): stepping resumes
        at once and the writer thread fetches at its leisure."""
        region = (slice(None),) + (slice(1, 1 + n),) * self.key.ndim
        return lane_snapshot(self._fields[region], lane)

    @staticmethod
    def extract(snap) -> np.ndarray:
        """The host field of a lane snapshot: the D2H wait that the
        dispatch-ahead scheduler leaves to the writer thread."""
        return host_fetch(snap)

    def extract_lane(self, lane: int, n: int) -> np.ndarray:
        """Synchronous one-lane fetch (the --dispatch-depth off shape)."""
        return self.extract(self.snapshot_lane(lane, n))

    # --- stepping ---------------------------------------------------------
    def dispatch_chunk(self, k: Optional[int] = None):
        """Enqueue one k-step chunk (default: the steady chunk) over every
        lane and return the handle of its boundary vector's host copy — no
        fence. The handle stays valid under later dispatches: each chunk
        writes a boundary vector of its own."""
        k = self.chunk if k is None else k
        if self.keep_input:
            # two fresh stacks from the caching allocator: the live stack
            # is only read, and stays the previous boundary's snapshot
            self._fields, _, self._rem, boundary = self._advance(
                self._fields, torch.empty_like(self._fields), self._r,
                self._n, self._rem, k, keep=torch.empty_like(self._fields))
        else:
            self._fields, self._spare, self._rem, boundary = self._advance(
                self._fields, self._spare, self._r, self._n, self._rem, k)
        return d2h_async(boundary)

    def fetch_remaining(self, handle, timeout_s: Optional[float] = None,
                        plan=None, fetch_index: int = 0) -> np.ndarray:
        """The boundary D2H (``fetch_boundary``): row 0 remaining steps,
        row 1 finite bits, rows 2-5 the bitcast numerics stats. ``plan``
        is the active fault plan: ``fetch-hang`` sleeps inside the
        watched fetch."""
        return fetch_boundary(handle, timeout_s=timeout_s, plan=plan,
                              fetch_index=fetch_index)

    def remaining(self) -> np.ndarray:
        return host_fetch(self._rem)

    # --- per-lane fault domains -------------------------------------------
    def _chaos_stack(self) -> torch.Tensor:
        """The stack a chaos write may land in: the live stack, or in a
        keep-input engine a fresh copy of it (the live stack is the newest
        chunk's boundary snapshot, which a lane's rollback may restore
        from; a fault written there would be restored too). Only the chaos
        paths pay for that copy."""
        if self.keep_input:
            self._fields = self._fields.clone()
        return self._fields

    def poison_lane(self, lane: int, n: int) -> None:
        """Chaos only (``lane-nan``): flip the centre cell of ``lane``'s
        request region to NaN, enqueued after the chunks already in
        flight; never reached without an active fault plan."""
        self._chaos_stack()[(lane,) + (1 + n // 2,) * self.key.ndim] = \
            float("nan")

    def perturb_lane(self, lane: int, n: int, eps: float) -> None:
        """Chaos only (``perturb``): add a finite bump ``eps`` (in the
        stack's dtype) to the centre cell of ``lane``'s request region —
        the finite bit holds, but the maximum-principle witnesses leave
        their envelope; never reached without an active fault plan."""
        f = self._chaos_stack()
        idx = (lane,) + (1 + n // 2,) * self.key.ndim
        f[idx] = f[idx] + torch.tensor(eps, dtype=f.dtype, device=f.device)

    def snapshot_stack(self) -> torch.Tensor:
        """The post-chunk lane stack as a restorable boundary snapshot: a
        lane judged finite at that boundary can later be restored from its
        row. The live stack itself, with no copy: in a keep-input engine no
        later chunk writes it (a ping-pong engine's next chunks would, so
        it has no snapshots)."""
        if not self.keep_input:
            raise RuntimeError("boundary snapshots need a keep_input engine")
        return self._fields

    def restore_lane(self, lane: int, buf: torch.Tensor, r: float, n: int,
                     steps: int) -> None:
        """Roll ONE lane back to a verified-finite boundary: its whole lane
        buffer from ``buf`` (a snapshot's row, on the card; no H2D) and its
        scalars; every other lane untouched. ``buf`` is only read, so the
        same snapshot row survives a second rollback."""
        self._fields[lane].copy_(buf)
        self._r[lane].fill_(float(r))
        self._n[lane].fill_(int(n))
        self._rem[lane].fill_(int(steps))


def fetch_boundary(handle, timeout_s: Optional[float] = None, plan=None,
                   fetch_index: int = 0) -> np.ndarray:
    """The ONE watchdogged boundary-D2H path: wait for a boundary handle's
    host copy, optionally under the ``bounded_call`` watchdog (a wedged
    device becomes ``BoundedFetchTimeout``), with the ``fetch-hang`` fault
    firing INSIDE the watched region either way."""
    def fetch():
        if plan is not None:
            plan.maybe_fetch_hang(fetch_index)
        # heat-tpu: allow[hot-path-purity] the watchdogged boundary D2H
        return host_fetch(handle)

    if timeout_s is None:
        return fetch()
    from ..runtime.async_io import bounded_call

    return bounded_call(fetch, timeout_s, "serve boundary fetch")


class MegaLaneEngine:
    """Device half of ONE mega-lane occupant: a request that overflows
    every bucket runs over ``nshards`` shards (a ``LocalComm`` from
    ``backends/sharded.make_comm``, on the engine's device: one shard per
    card, or several time-sharing one) through the sharded padded-carry
    advance, in the dispatch contract ``LaneEngine`` gives packed lanes:
    ``dispatch_chunk(k)`` enqueues one k-step chunk and returns the handle
    of its ``(K_BOUNDARY, 1)`` boundary vector's host copy (remaining
    steps, the owned cells' finite bit, the numerics stats) with no host
    round trip; ``fetch_boundary`` is the only wait. One mega-lane is a
    bucket group of one lane whose "bucket" is the mesh.

    Its bytes are the machinery's (``sharded.make_mega_machinery``): the
    initial state is the device-built IC of each shard's block, seeded as
    the solo sharded drive seeds it, and in f32/f64 owned cells do not
    depend on where a chunk is cut, so the field equals a solo sharded or
    single-device run of the same config.

    The machinery is built once per (config geometry, mesh, exchange,
    comm, local kernel, fuse depth) and cached engine-wide in ``cache``;
    ``on_compile(seconds)`` fires for each build, so re-admitting the same
    oversized config builds nothing. Nothing is compiled per chunk size:
    the kernels are built once per checkout."""

    def __init__(self, cfg, nshards: int, chunk: int, device=None,
                 cache: Optional[dict] = None, on_compile=None):
        from ..backends import resolve_device
        from ..backends.sharded import make_comm

        self.cfg = cfg
        self.chunk = chunk
        device = resolve_device(device)
        # the mega mesh spans the shards, whatever mesh the request names
        comm = make_comm(cfg.with_(mesh_shape=None), device,
                         virtual_devices=nshards)
        self._cache = cache if cache is not None else {}
        self._ckey = ("mega", cfg.ndim, cfg.n, cfg.dtype, cfg.bc,
                      repr(cfg.bc_value), repr(float(cfg.r)),
                      tuple(comm.mesh.shape), cfg.exchange, cfg.comm,
                      cfg.local_kernel, cfg.fuse_steps, str(device))
        m = self._cache.get(self._ckey)
        if m is None:
            from ..backends.sharded import make_mega_machinery
            from ..runtime import prof

            t0 = time.perf_counter()
            seed, advance, crop, kf, kernel = make_mega_machinery(cfg, comm)
            m = {"comm": comm, "seed": seed, "advance": advance,
                 "crop": crop, "kf": kf, "kernel": kernel}
            if kernel == "cuda" and device.type == "cuda":
                from ..ops import _build

                _build.load("ftcs2d" if cfg.ndim == 2 else "ftcs3d")
            spent = time.perf_counter() - t0
            self._cache[self._ckey] = m
            prof.compile_log().note(
                f"mega {cfg.ndim}d n{cfg.n} {cfg.dtype} {cfg.bc} mesh "
                f"{'x'.join(map(str, comm.mesh.shape))} machinery", 0, spent)
            if on_compile is not None:
                on_compile(spent)
        self.comm = m["comm"]
        self.kf = m["kf"]
        self.kernel = m["kernel"]
        self._seed, self._advance, self._crop = (m["seed"], m["advance"],
                                                 m["crop"])
        self._head = self.comm.devices[0]
        self.reload()

    def _countdown(self, steps: int) -> torch.Tensor:
        return torch.full((1,), int(steps), dtype=torch.int32,
                          device=self._head)

    def _blocks(self):
        mesh = self.comm.mesh
        return [mesh.block(rank, self.cfg.n) for rank in self.comm.ranks]

    # --- state lifecycle --------------------------------------------------
    def reload(self) -> None:
        """(Re)build the carried state from the initial condition, each
        shard's block built on its device — admission, and a rollback with
        no verified boundary yet."""
        from ..grid import initial_condition_device

        self._F = self._seed([initial_condition_device(self.cfg, dev, blk)
                              for dev, blk in zip(self.comm.devices,
                                                  self._blocks())])
        self._rem = self._countdown(self.cfg.ntime)

    def load(self, T, steps_left: int) -> None:
        """Seed the carried state from a host field with ``steps_left``
        steps to go (engine-checkpoint resume, a solve-cache prefix): the
        continuation at a chunk boundary is byte-equal to an uninterrupted
        run, as owned cells do not depend on where a chunk is cut."""
        T = _host_tensor(T, torch_dtype(self.cfg.dtype))
        self._F = self._seed([T[blk].to(dev)
                              for dev, blk in zip(self.comm.devices,
                                                  self._blocks())])
        self._rem = self._countdown(steps_left)

    def dispatch_chunk(self, k: int):
        """Enqueue one k-step chunk over every shard and return the handle
        of its boundary vector's host copy — no fence."""
        self._F, self._rem, boundary = self._advance(self._F, self._rem, k)
        return d2h_async(boundary)

    def _hold(self, F):
        """``F``'s shards, restorable (rollback bookkeeping). Every block
        writes fresh output tensors, and the exchange before a block
        refills every margin from owned cells, so nothing writes a held
        shard's owned cells (the chaos writes copy their shard first): the
        shards are held by reference. ``--exchange overlap`` is the
        exception: its blocks write into the input of the block before, so
        there the shards are copied."""
        if self.cfg.exchange == "overlap":
            return F.clone()
        return type(F)(list(F.shards), F.comm, F.n, F.margin)

    def snapshot_state(self):
        """The carried shards at this boundary (rollback mode only)."""
        return self._hold(self._F)

    def restore(self, snap, steps_left: int) -> None:
        """Roll back to a verified-finite boundary."""
        self._F = self._hold(snap)
        self._rem = self._countdown(steps_left)

    def final_snapshot(self):
        """The owned global field, assembled on the first shard's device
        behind the chunks in flight, and its copy to the host started; the
        writer thread waits for it (``extract``)."""
        return d2h_async(self._crop(self._F))

    @staticmethod
    def extract(snap) -> np.ndarray:
        """The host field of a ``final_snapshot`` (writer thread). Static,
        so a writeback closure holds the cropped field, never the padded
        shards."""
        return host_fetch(snap)

    def _centre(self):
        """(shard, its padded index) of the owned centre cell. The shard is
        a copy of the live one put in its place, so that a chaos write
        never reaches a held snapshot (``_hold``)."""
        F, mesh = self._F, self.comm.mesh
        idx = (self.cfg.n // 2,) * self.cfg.ndim
        for i, (rank, s) in enumerate(zip(self.comm.ranks, F.shards)):
            blk = mesh.block(rank, self.cfg.n)
            if all(b.start <= j < b.stop for b, j in zip(blk, idx)):
                F.shards[i] = s = s.clone()
                return s, tuple(j - b.start + F.margin
                                for b, j in zip(blk, idx))
        raise AssertionError("no shard owns the centre cell")

    def poison_center(self) -> None:
        """Chaos only (``lane-nan`` on a mega request): the owned centre
        cell becomes NaN, enqueued after the chunks in flight."""
        s, idx = self._centre()
        s[idx] = float("nan")

    def perturb_center(self, eps: float) -> None:
        """Chaos only (``perturb`` on a mega request): add a finite bump
        (in the field's dtype) to the owned centre cell."""
        s, idx = self._centre()
        s[idx] = s[idx] + torch.tensor(eps, dtype=s.dtype, device=s.device)


def lane_state_from_reference(fields: np.ndarray, r, n, rem, key: BucketKey):
    """The reference engine's lane state as the port's tensors: ``fields``
    (numpy) in the reference's XLA layout ``(L,) + (B+2,)*nd`` or its
    Pallas layout ``(L,) + lane_state_shape`` (the bucket buffer in the
    ``[0 : B+2]`` corner of an alignment-padded slab) is cropped to the
    port's layout. bfloat16 arrays (the reference's, or ``V2``) are read
    as their bits. Returns ``(fields, r, n, rem)`` as CPU tensors."""
    fields = np.asarray(fields)
    crop = (slice(None),) + tuple(slice(0, s) for s in key.padded_shape)
    cropped = np.array(fields[crop])     # a writable copy of its own
    if cropped.shape[1:] != key.padded_shape:
        raise ValueError(f"lane stack {fields.shape} is smaller than bucket "
                         f"{key}'s buffer {key.padded_shape}")
    dt = torch_dtype(key.dtype)
    if dt == torch.bfloat16:
        t = torch.from_numpy(cropped.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(cropped.astype(np.dtype(key.dtype)))
    return (t, torch.tensor(np.asarray(r), dtype=_acc_dtype(dt)),
            torch.tensor(np.asarray(n), dtype=torch.int32),
            torch.tensor(np.asarray(rem), dtype=torch.int32))


def wall_clock() -> float:
    """Seam for tests; the scheduler stamps queue/serve waits with this."""
    return time.perf_counter()
