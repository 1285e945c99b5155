"""The ``sharded`` backend: the field decomposed over a mesh of shards, a
halo exchange between them, the stencil kernel on every shard.

Counterpart of heat_tpu's ``sharded`` backend, the rebuild of the
reference's decomposed variants (``fortran/mpi+cuda/heat.F90``, CUDA-aware
and staged MPI, and ``fortran/hip``, always staged). The global field is
cut into equal blocks, one per shard of a ``RankMesh``; every fused block
of ``kf`` steps is one width-``kf`` halo exchange (``parallel.halo``)
followed by ``kf`` steps on each shard, the communication-avoiding scheme:
ghost layer L is valid for the first ``kf - L`` steps, exactly when it is
read, so owned cells get the bytes of an every-step exchange.

The shards are held by a communicator (``parallel.comm``): ``LocalComm``,
every shard in this process (on ``cuda:(i % device_count)`` or the CPU),
or ``DistComm``, one shard per rank of a ``torch.distributed`` world.
``comm="direct"`` moves device slabs, ``"staged"`` sends every slab
through host memory.

Each shard steps through ``ops.cuda_stencil.ftcs_multistep_bounded_cuda``
(``local_kernel="cuda"``, heat_tpu's ``pallas``: ``ftcs2d``/``ftcs3d``, or
their plain versions on CPU tensors) with per-shard bounds, or through the
plain PyTorch step with a pinned mask (``"torch"``, heat_tpu's ``xla``).
``"auto"`` is the kernel on a CUDA shard where one applies, else torch.

Step order and boundary semantics are the reference's (see
``heat_tpu.backends.sharded``): swap-then-update by default;
``parity_order`` carries the width-1 padded field and runs the literal
update-then-swap (fortran/mpi+cuda/heat.F90:206-219). ``ghost`` pins the
global-edge ghosts at ``bc_value``; ``edges`` also freezes the global
boundary ring; ``periodic`` closes the rings and pins nothing.

Two solve paths: the padded-carry state (each shard carried as owned +
2*kf cells, margins garbage between exchanges; checkpoints, numerics
checks and injected faults read and write the owned cells through
``ShardField``), and the parity path.
"""

from __future__ import annotations

import functools
import itertools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import HeatConfig
from ..ops.cuda_stencil import (_NO_FREEZE, ftcs_multistep_bounded_cuda,
                                kernel_available)
from ..ops.pass_schedule import KMAX_2D, KMAX_3D, effective_chunk_2d
from ..ops.stencil import accum_dtype_for, laplacian_interior
from ..parallel.comm import DistComm, LocalComm
from ..parallel.halo import halo_exchange, halo_pad, post_axis
from ..parallel.mesh import build_mesh, validate_divisible
from ..runtime.logging import master_print
from ..utils import torch_dtype
from . import SolveResult, register
from .common import FieldOps, drive, load_or_init, resume_from_shards

class ShardField:
    """This process's shards of the field: each the owned block inside a
    ``margin``-cell ring (``kf`` on the padded-carry path, 1 on the parity
    path; margins are ghosts or garbage). Indexing one cell takes its
    global index."""

    def __init__(self, shards: List[torch.Tensor], comm, n: int, margin: int):
        self.shards = shards
        self.comm = comm
        self.n = n
        self.margin = margin

    def clone(self) -> "ShardField":
        return ShardField([s.clone() for s in self.shards], self.comm, self.n,
                          self.margin)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def shape(self) -> tuple:
        return (self.n,) * self.shards[0].dim()

    def owned(self) -> List[torch.Tensor]:
        m = self.margin
        return [s[(slice(m, -m),) * s.dim()] for s in self.shards]

    def __setitem__(self, idx, value) -> None:
        for rank, s in zip(self.comm.ranks, self.shards):
            blk = self.comm.mesh.block(rank, self.n)
            if all(b.start <= i < b.stop for b, i in zip(blk, idx)):
                s[tuple(i - b.start + self.margin for b, i in zip(blk, idx))] = value


def _all_finite(F: ShardField) -> bool:
    return F.comm.all_true(all(bool(torch.isfinite(o).all())
                               for o in F.owned()))


def _saves_shards(comm) -> bool:
    """A world of several ranks checkpoints per-rank shard files; shards
    in one process write the global file."""
    return isinstance(comm, DistComm) and comm.mesh.size > 1


def _shard_blocks(F: ShardField):
    """This rank's owned blocks with their global start offsets, on the
    host, where the run saves shard files; else None."""
    if not _saves_shards(F.comm):
        return None
    return [(tuple(b.start for b in F.comm.mesh.block(rank, F.n)),
             o.contiguous().cpu())
            for rank, o in zip(F.comm.ranks, F.owned())]


SHARD_OPS = FieldOps(sync=lambda F: F.comm.sync(), finite_flag=_all_finite,
                     gather=lambda F: F.comm.gather(F.owned(), F.n),
                     shard_blocks=_shard_blocks)


def resolve_local_kernel(cfg: HeatConfig, comm, padded_shape) -> str:
    """``cuda`` or ``torch`` for this run's shards (see the module
    docstring); an explicit ``cuda`` without a kernel raises, and an
    ``auto`` that runs the plain step on the card says why. The overlap
    exchange is built on the bounded kernel: without it, it raises."""
    available = kernel_available(padded_shape, torch_dtype(cfg.dtype))
    on_card = all(d.type == "cuda" for d in comm.devices)
    why = ("the stencil kernels have no f64 path" if cfg.dtype == "float64"
           else f"no kernel plan for the shard shape {tuple(padded_shape)}")
    if cfg.exchange == "overlap" and not (
            available and (cfg.local_kernel == "cuda"
                           or cfg.local_kernel == "auto" and on_card)):
        raise ValueError(
            f"exchange='overlap' requires the stencil kernel (the interior/"
            f"rim split is built on the bounded multistep kernel; here "
            f"local_kernel={cfg.local_kernel!r}"
            + ("" if available else f", {why}")
            + "); use local_kernel='cuda', or exchange='indep'")
    if cfg.local_kernel == "torch":
        return "torch"
    if available:
        return "cuda" if cfg.local_kernel == "cuda" or on_card else "torch"
    if cfg.local_kernel == "cuda":
        raise ValueError(
            f"local_kernel='cuda' does not support dtype={cfg.dtype!r} at "
            f"this size ({why}); use local_kernel='torch' or 'auto'")
    if comm.devices[0].type == "cuda":
        master_print(f"local kernel: the plain torch step on the card ({why}; "
                     f"local_kernel=auto)")
    return "torch"


def _edge_pad(p: torch.Tensor) -> torch.Tensor:
    """``jnp.pad(p, 1, mode="edge")``."""
    for d in range(p.dim()):
        size = p.shape[d]
        p = torch.cat([p.narrow(d, 0, 1), p, p.narrow(d, size - 1, 1)], dim=d)
    return p


def _global_masks(coords, shape, base_off, n: int, edges: bool):
    """Per-axis broadcastable masks of the cells outside the global field
    (and, with ``edges``, on its boundary ring), for a shard at ``coords``
    whose padded array starts ``base_off`` cells before its block."""
    nd = len(shape)
    pinned = None
    for d, (c, m) in enumerate(zip(coords, shape)):
        g = c * (m - 2 * base_off) - base_off + torch.arange(m)
        axis = (g < 0) | (g > n - 1)
        if edges:
            axis = axis | (g == 0) | (g == n - 1)
        axis = axis.view([-1 if e == d else 1 for e in range(nd)])
        pinned = axis if pinned is None else pinned | axis
    return pinned


def shard_bounds(bc: str, coords, mesh_shape, padded_shape, wpad: int) -> list:
    """Per-axis (lo, hi) freeze bounds of the shard at ``coords``, in its
    padded coordinates: only global-domain edges freeze (the Dirichlet
    ghosts, plus the boundary ring under "edges"); an inner side is open
    (-1 / M), its wpad-cell margin owns the array-edge garbage; a periodic
    mesh freezes nothing."""
    edges = 1 if bc == "edges" else 0
    bounds = []
    for c, size, M in zip(coords, mesh_shape, padded_shape):
        if bc == "periodic":
            bounds += [-_NO_FREEZE, _NO_FREEZE]
            continue
        bounds.append(wpad - 1 + edges if c == 0 else -1)
        bounds.append(M - wpad - edges if c == size - 1 else M)
    return bounds


def _span(s: int, w: int, size: int) -> slice:
    """On one axis of a padded shard of extent ``size``, the cells region
    side ``s`` reads: within ``3w`` of the low (-1) or high (+1) array
    edge, or the owned span (0)."""
    return (slice(w, size - w) if s == 0 else slice(0, 3 * w) if s < 0
            else slice(size - 3 * w, size))


def overlap_regions(padded_shape, w: int) -> list:
    """``(sigma, shape)`` of every kernel call of one overlap block on a
    shard of ``padded_shape``, the shape its passes are planned at: the
    interior first (sigma all 0; the owned block's passes), then the
    ``3^nd - 1`` boundary regions (their inputs' shapes), faces before
    edges and corners within each highest axis; a tiny shard (owned extent
    < 2w on an axis) takes the wide form, one 3w-deep band per face."""
    nd = len(padded_shape)
    owned = tuple(s - 2 * w for s in padded_shape)
    out = [((0,) * nd, owned)]
    if min(owned) < 2 * w:
        for d in range(nd):
            for s in (-1, 1):
                out.append((tuple(s if e == d else 0 for e in range(nd)),
                            tuple(3 * w if e == d else padded_shape[e]
                                  for e in range(nd))))
        return out
    for top in range(nd):
        for sigma in sorted((sg for sg in itertools.product((-1, 0, 1),
                                                            repeat=nd)
                             if any(sg) and max(d for d in range(nd)
                                                if sg[d]) == top),
                            key=lambda sg: sum(map(abs, sg))):
            out.append((sigma, tuple(L - 2 * w if s == 0 else 3 * w
                                     for s, L in zip(sigma, padded_shape))))
    return out


def make_overlap_multistep(cfg: HeatConfig, comm):
    """``padded_multi`` (see ``make_local_multistep``) with the exchange in
    flight while the shards compute: ``padded_multi_overlap`` and
    ``_overlap_wide`` of heat_tpu's sharded backend, the same bytes.

    Per fused block of ``ksteps <= w`` steps on each padded shard:

    1. **Interior**: the owned cells at least ``w`` from every shard edge
       read, within ``ksteps`` steps, only owned cells, so they step from
       the PRE-exchange field with bounds that freeze nothing: one kernel
       call on the whole padded shard, written straight into the output,
       cut into the passes of the owned block. Axis 0's exchange is posted
       before these kernels are enqueued (NCCL's stream waits on the work
       before the post), so it flies under them.
    2. **Exchange**: the per-face receive slabs of the indep form
       (``parallel.halo.post_axis``), never written into one array. Axis
       d + 1 is posted once axis d's slabs have landed, as its sends stitch
       in axis d's corners.
    3. **Regions**: the ``3^nd - 1`` boundary regions (the cells within w
       of the faces ``sigma`` marks). Each region's input is the
       pre-exchange data plus only its own faces' slabs, written in axis
       order (later axes own the corners); the kernel runs on it with the
       shard's bounds shifted to its origin, and its w-deep kept part goes
       to the output. A region runs as soon as its highest axis's slabs
       have landed, inside the next axis's flight window.

    Shards with an owned extent below 2w take the wide form: the whole
    exchange, written into the margins, then one 3w-deep band per face
    sliced from the written array (earlier axes' bands own the corners).

    Every kernel call is planned by ``pass_schedule`` at its own input
    shape, as the reference plans each, so bf16 rounds where the
    reference's overlap rounds. The output of each shard goes into a
    second buffer, swapped with the input at the next block: slabs of a
    direct ``LocalComm`` are views of the neighbours' padded arrays, so no
    input is written while a region may still read it."""
    r = cfg.r
    bc_value = cfg.bc_value
    mesh = comm.mesh
    coords = [mesh.coords(rank) for rank in comm.ranks]
    spare: dict = {}

    def out_buffer(i: int, p: torch.Tensor) -> torch.Tensor:
        """Shard i's output: the input of the block before (its margins
        are garbage by contract, as every block's output margins are)."""
        b = spare.get(i)
        if (b is None or b.shape != p.shape or b.dtype != p.dtype
                or b.device != p.device or b.data_ptr() == p.data_ptr()):
            b = torch.empty_like(p)
        spare[i] = p
        return b

    def region_input(p, recv, sigma, w):
        Lp = p.shape
        nd = p.dim()
        inp = p[tuple(_span(s, w, L) for s, L in zip(sigma, Lp))].clone(
            memory_format=torch.contiguous_format)
        for d, s in enumerate(sigma):
            if s == 0:
                continue
            slab = recv[d][0 if s < 0 else 1]
            dst = [slice(None)] * nd
            dst[d] = slice(0, w) if s < 0 else slice(2 * w, 3 * w)
            inp[tuple(dst)] = slab[tuple(
                slice(None) if e == d else _span(se, w, Lp[e])
                for e, se in enumerate(sigma))]
        return inp

    def run_region(out, inp, origin, bounds, ksteps, keep, dst) -> None:
        """The kernel on one region's input (the shard's bounds shifted to
        the input's ``origin``), ``out[dst] = band[keep]``."""
        bnd = [b - origin[j // 2] for j, b in enumerate(bounds)]
        _put(out, dst, ftcs_multistep_bounded_cuda(inp, r, ksteps, bnd), keep)

    def padded_multi(shards: Sequence[torch.Tensor], w: int,
                     ksteps: int) -> List[torch.Tensor]:
        nd = shards[0].dim()
        Lp = tuple(shards[0].shape)
        regions = overlap_regions(Lp, w)
        wide = min(Lp) - 2 * w < 2 * w
        recvs: dict = {}
        pending = (None if wide
                   else post_axis(shards, recvs, 0, comm, bc_value, w))
        # 1) the interior, from the PRE-exchange field: the kernel on the
        # whole padded shard, straight into the output, in the passes of
        # the owned block (the reference steps the owned block alone).
        # Its kept cells, 2w and more from the array edge, reach within
        # ksteps <= w steps only owned cells, so they are the bytes of the
        # owned block's call; the rest of the output is overwritten by the
        # regions or is margin
        nofreeze = [-_NO_FREEZE, _NO_FREEZE] * nd
        outs = [ftcs_multistep_bounded_cuda(p, r, ksteps, nofreeze,
                                            out=out_buffer(i, p),
                                            plan_shape=regions[0][1])
                for i, p in enumerate(shards)]
        bounds = [shard_bounds(cfg.bc, c, mesh.shape, Lp, w) for c in coords]

        def rim(s: int, L: int) -> tuple:
            """The w-deep owned rim of face ``s``: its place in a 3w-deep
            input and in the shard."""
            return (slice(w, 2 * w), slice(w, 2 * w) if s < 0
                    else slice(L - 2 * w, L - w))

        if wide:
            # the whole exchange into the margins (the interior above read
            # owned cells only), then one band per face
            halo_exchange(shards, comm, bc_value, width=w)
            for sigma, _ in regions[1:]:
                d = next(e for e, s in enumerate(sigma) if s)
                src = [slice(None)] * nd
                src[d] = _span(sigma[d], w, Lp[d])
                origin = [0] * nd
                origin[d] = src[d].start
                # earlier axes' bands own the corners
                keep = [slice(2 * w, L - 2 * w) if e < d else slice(w, L - w)
                        for e, L in enumerate(Lp)]
                dst = list(keep)
                keep[d], dst[d] = rim(sigma[d], Lp[d])
                for i, p in enumerate(shards):
                    run_region(outs[i], p[tuple(src)], origin, bounds[i],
                               ksteps, keep, dst)
            return outs
        # 2) + 3) each axis's slabs, then the regions whose highest axis
        # it is, in the next axis's flight window
        for d in range(nd):
            recvs[d] = pending()
            if d + 1 < nd:
                pending = post_axis(shards, recvs, d + 1, comm, bc_value, w)
            for sigma, _ in regions[1:]:
                if max(e for e, s in enumerate(sigma) if s) != d:
                    continue
                origin = [_span(s, w, L).start for s, L in zip(sigma, Lp)]
                keep = [rim(s, L)[0] if s else slice(w, L - 3 * w)
                        for s, L in zip(sigma, Lp)]
                dst = [rim(s, L)[1] if s else slice(2 * w, L - 2 * w)
                       for s, L in zip(sigma, Lp)]
                for i, p in enumerate(shards):
                    recv = {e: recvs[e][i] for e in range(d + 1)}
                    run_region(outs[i], region_input(p, recv, sigma, w),
                               origin, bounds[i], ksteps, keep, dst)
        return outs

    return padded_multi


def _put(out, dst, src, keep) -> None:
    """``out[dst] = src[keep]``, skipping an empty span (tiny shards)."""
    if any(s.stop <= s.start for s in dst):
        return
    out[tuple(dst)] = src[tuple(keep)]


def make_local_multistep(cfg: HeatConfig, comm, kernel: str):
    """``padded_multi(shards, wpad, ksteps)`` over the shards of ``comm``:
    exchanges the width-``wpad`` ghost rings, then runs ``ksteps <= wpad``
    fused steps on each padded shard (input and output padded; the
    output's margins are garbage). With ``--exchange overlap`` the
    exchange flies while the shards compute
    (``make_overlap_multistep``)."""
    if cfg.exchange == "overlap":
        return make_overlap_multistep(cfg, comm)
    r = cfg.r
    bc_value = cfg.bc_value
    periodic = cfg.bc == "periodic"
    edges = cfg.bc == "edges"
    n = cfg.n
    mesh = comm.mesh
    coords = [mesh.coords(rank) for rank in comm.ranks]

    @functools.lru_cache(maxsize=None)
    def pinned_mask(i: int, shape: tuple, wpad: int, device):
        return _global_masks(coords[i], shape, wpad, n, edges).to(device)

    def padded_multi(shards: Sequence[torch.Tensor], wpad: int,
                     ksteps: int) -> List[torch.Tensor]:
        halo_exchange(shards, comm, bc_value, width=wpad)
        if kernel == "cuda":
            return [ftcs_multistep_bounded_cuda(
                        p, r, ksteps,
                        shard_bounds(cfg.bc, c, mesh.shape, p.shape, wpad))
                    for c, p in zip(coords, shards)]
        out = []
        for i, p0 in enumerate(shards):
            acc_dt = accum_dtype_for(p0.dtype)
            rr = torch.tensor(r, dtype=acc_dt, device=p0.device)
            pinned = (None if periodic
                      else pinned_mask(i, tuple(p0.shape), wpad, p0.device))
            p = p0
            for _ in range(ksteps):
                # clamp-pad so the outermost ring has *some* neighbour
                # value; its update is garbage but sits beyond every layer
                # a valid cell reads afterwards
                new = (p.to(acc_dt) + rr * laplacian_interior(_edge_pad(p))
                       ).to(p.dtype)
                p = new if pinned is None else torch.where(pinned, p0, new)
            out.append(p)
        return out

    return padded_multi


def fuse_depth_sharded(cfg: HeatConfig, axis_sizes) -> int:
    """Halo width per exchange: the requested fuse depth capped by the
    smallest local extent (a shard can't lend deeper halo than it owns);
    the auto depth is ``sqrt(L/d)`` (per-exchange overhead against margin
    work), capped at the kernel's per-pass depth: 8 in 3D, in 2D the
    depth the reference's planner gives the ghost-padded shard. The cap
    keys on the CONFIGURED kernel, as in the reference: a configured
    ``torch`` kernel (and f64, which never runs the kernel) keeps the
    plain sqrt form; ``auto`` keeps the cap wherever it resolves."""
    kmax = KMAX_2D if cfg.ndim == 2 else KMAX_3D
    local_min = min(cfg.n // s for s in axis_sizes)
    want = cfg.fuse_steps
    if not want:
        want = max(1, min(kmax, round((local_min / cfg.ndim) ** 0.5)))
        if (cfg.ndim == 2 and cfg.local_kernel != "torch"
                and cfg.dtype != "float64"):
            want = min(want, _auto_chunk_2d(cfg, axis_sizes))
    return max(1, min(want, local_min))


def launches_per_solve(cfg: HeatConfig, axis_sizes) -> int:
    """Kernel launches of one solve of ``cfg`` from step 0 with the kernel
    on every shard of a mesh of ``axis_sizes`` and the indep exchange, the
    warm-up not counted: the drive loop's chunks, each cut into blocks of
    ``kf`` steps and a remainder block, each block's call on the padded
    shard cut into the reference's passes."""
    from ..ops import pass_schedule
    from .common import event_interval

    kf = fuse_depth_sharded(cfg, axis_sizes)
    padded = tuple(cfg.n // s + 2 * kf for s in axis_sizes)
    dt = torch_dtype(cfg.dtype)

    def advance(k: int) -> int:
        n_fused, rem = divmod(k, kf)
        return (n_fused * len(pass_schedule.passes(padded, dt, kf))
                + (len(pass_schedule.passes(padded, dt, rem)) if rem else 0))

    chunk = min(event_interval(cfg), max(cfg.ntime, 1))
    full, rem = divmod(cfg.ntime, chunk)
    return int(np.prod(axis_sizes)) * (full * advance(chunk)
                                       + (advance(rem) if rem else 0))


def _auto_chunk_2d(cfg: HeatConfig, axis_sizes) -> int:
    """Per-pass depth of the 2D kernel at the ghost-padded shard shape of
    the deepest candidate halo (``_auto_chunk_2d``, sharded.py:1060)."""
    rows = cfg.n // axis_sizes[0] + 2 * KMAX_2D
    cols = cfg.n // axis_sizes[-1] + 2 * KMAX_2D
    return effective_chunk_2d((rows, cols), cfg.dtype)


def _chunked_advance(step, kf: int):
    """``(advance, warm)``: fused blocks of ``kf`` steps and one remainder
    block, ``step(shards, nsteps)`` each; ``warm`` makes each distinct
    block once."""

    def advance(F: ShardField, k: int) -> ShardField:
        n_fused, rem = divmod(k, kf)
        for _ in range(n_fused):
            F.shards = step(F.shards, kf)
        if rem:
            F.shards = step(F.shards, rem)
        return F

    def warm(F: ShardField, k: int) -> None:
        n_fused, rem = divmod(k, kf)
        if n_fused:
            F.shards = step(F.shards, kf)
        if rem:
            step(F.shards, rem)

    return advance, warm


def make_mega_machinery(cfg: HeatConfig, comm):
    """``(seed, advance, crop, kf, kernel)``: the padded-carry machinery in
    the serve dispatch contract (``serve/engine.MegaLaneEngine``), one
    request spanning every shard of ``comm`` as a *mega-lane*.

    ``seed(owned)`` pads each owned block at width ``kf`` into a
    ``ShardField``. ``advance(F, rem, k)`` runs ``k`` steps and returns
    ``(F', rem', boundary)``:

    - the blocks are cut as the reference's mega chunk cuts them:
      ``divmod(k - 1, kf)`` fused blocks of ``kf`` steps, the remainder
      block, then the chunk's final step as a block of its own, so the
      owned cells from before it are at hand for the residual. Owned cells
      do not depend on where a chunk is cut in f32 and f64; in bf16 every
      block (and every pass inside one, planned at the padded shard shape)
      is a rounding point, so a bf16 mega field is the reference's
      mega-lane's, not the solo drive's;
    - ``rem`` is a ``(1,)`` int32 countdown on the first shard's device,
      ``rem' = max(rem - k, 0)``;
    - ``boundary`` is the ``(K_BOUNDARY, 1)`` int32 vector of
      ``serve/engine.pack_boundary``: the finite bit over every shard's
      OWNED cells (the garbage margins never vote), and the float32 stats
      ``max |own - prev_own|``, ``min``, ``max`` and ``sum`` per shard,
      merged across shards by max / min / max / sum. They are torch
      reductions, as the reference takes them in XLA outside its kernels.

    Every block's output is a fresh tensor (the exchange writes only the
    input's margins), so the owned cells before the final step stay intact
    while it runs. ``crop(F)`` assembles the owned global field on the
    first shard's device. ``kernel`` is the resolved local kernel."""
    from ..serve.engine import pack_boundary

    mesh = comm.mesh
    validate_divisible(cfg.n, mesh)
    kf = fuse_depth_sharded(cfg, mesh.shape)
    nd = cfg.ndim
    kernel = resolve_local_kernel(
        cfg, comm, [cfg.n // s + 2 * kf for s in mesh.shape])
    padded_multi = make_local_multistep(cfg, comm, kernel)
    ctr = (slice(kf, -kf),) * nd
    head = comm.devices[0]

    def seed(owned: Sequence[torch.Tensor]) -> ShardField:
        return ShardField([halo_pad(s, cfg.bc_value, kf) for s in owned],
                          comm, cfg.n, kf)

    def advance(F: ShardField, rem: torch.Tensor, k: int):
        shards = F.shards
        if k > 1:
            n_fused, r_ = divmod(k - 1, kf)
            for _ in range(n_fused):
                shards = padded_multi(shards, kf, kf)
            if r_:
                shards = padded_multi(shards, kf, r_)
        prev = shards
        shards = padded_multi(shards, kf, 1)
        fins, stats = [], []
        for p, q in zip(shards, prev):
            own = p[ctr]
            o32 = own.float()
            fins.append(torch.isfinite(own).all())
            lo, hi = torch.aminmax(o32)
            stats.append(torch.stack([
                torch.sub(o32, q[ctr].float()).abs_().amax(), lo, hi,
                o32.sum()]).to(head))
        del prev
        F.shards = shards
        per = torch.stack(stats, dim=1)
        merged = torch.stack([per[0].amax(), per[1].amin(), per[2].amax(),
                              per[3].sum()]).reshape(4, 1)
        finite = torch.stack([f.to(head) for f in fins]).all().reshape(1)
        rem2 = torch.clamp(rem - k, min=0)
        return F, rem2, pack_boundary(rem2, finite.to(torch.int32), merged)

    def crop(F: ShardField) -> torch.Tensor:
        out = torch.empty((cfg.n,) * nd, dtype=F.shards[0].dtype,
                          device=head)
        for rank, o in zip(comm.ranks, F.owned()):
            out[mesh.block(rank, cfg.n)] = o
        return out

    return seed, advance, crop, kf, kernel


def make_parity_machinery(cfg: HeatConfig, comm):
    """``(seed, step)`` of the literal update-then-swap order: the carried
    state is the width-1 padded field; every step updates all owned cells
    against the ghosts as they are, then swaps. An IC start seeds the
    ghosts by one exchange (the reference's IC fills the whole padded
    array); an explicit T0 seeds them with ``bc_value`` only, and the
    first step reads stale ghosts, as a raw restart of the reference
    would."""
    r = cfg.r
    bc_value = cfg.bc_value
    n = cfg.n
    coords = [comm.mesh.coords(rank) for rank in comm.ranks]
    masks = {}

    def seed(owned: Sequence[torch.Tensor], from_ic: bool) -> List[torch.Tensor]:
        padded = [halo_pad(s, bc_value, 1) for s in owned]
        if from_ic:
            halo_exchange(padded, comm, bc_value, width=1)
        return padded

    def step(padded: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for i, p in enumerate(padded):
            if i not in masks:  # the ghost ring (+ the boundary ring)
                masks[i] = _global_masks(coords[i], tuple(p.shape), 1, n,
                                         cfg.bc == "edges").to(p.device)
            acc_dt = accum_dtype_for(p.dtype)
            rr = torch.tensor(r, dtype=acc_dt, device=p.device)
            new = p.to(acc_dt, copy=True)
            new[(slice(1, -1),) * p.dim()] += rr * laplacian_interior(p)
            out.append(torch.where(masks[i], p, new.to(p.dtype)))
        # ghost update AFTER the stencil — the literal :218 ``call swap()``
        return list(halo_exchange(out, comm, bc_value, width=1))

    return seed, step


def make_comm(cfg: HeatConfig, device, virtual_devices: Optional[int] = None):
    """The communicator of this run: ``DistComm`` inside a
    ``torch.distributed`` world, else ``LocalComm`` over
    ``virtual_devices`` shards (default: the mesh's, else one per card, or
    one on the CPU)."""
    device = torch.device(device)
    staged = cfg.comm == "staged"
    periodic = cfg.bc == "periodic"
    if dist.is_available() and dist.is_initialized():
        if virtual_devices:
            raise ValueError(
                "--virtual-devices N runs N shards in one process; a "
                "multi-process world runs one shard per rank")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = build_mesh(cfg.ndim, dist.get_world_size(), cfg.mesh_shape,
                          periodic)
        return DistComm(mesh, device, staged)
    if virtual_devices:
        nshards = virtual_devices
    elif cfg.mesh_shape:
        nshards = int(np.prod(cfg.mesh_shape))
    else:
        nshards = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = build_mesh(cfg.ndim, nshards, cfg.mesh_shape, periodic)
    return LocalComm(mesh, device, staged)


def _initial_shards(cfg: HeatConfig, T0, comm):
    """(owned shards, start_step): explicit T0 > checkpoint (a world of
    several ranks: this rank's shard file at the agreed step, unless a
    newer global file exists; host arrays, each shard's block copied over)
    > each shard's block of the IC built on its device."""
    from ..grid import initial_condition_device

    blocks = [comm.mesh.block(rank, cfg.n) for rank in comm.ranks]
    dt = torch_dtype(cfg.dtype)
    if T0 is None and cfg.checkpoint_every and _saves_shards(comm):
        saved = resume_from_shards(cfg)
        if saved is not None:
            by_start = dict(saved[0])
            return [torch.tensor(by_start[tuple(b.start for b in blk)],
                                 device=dev).to(dt)
                    for dev, blk in zip(comm.devices, blocks)], saved[1]
    T0_host, start_step = load_or_init(cfg, T0, default_ic=False)
    if T0_host is None:
        return [initial_condition_device(cfg, dev, blk)
                for dev, blk in zip(comm.devices, blocks)], start_step
    T0_host = np.asarray(T0_host)
    return [torch.tensor(T0_host[blk], device=dev).to(dt)
            for dev, blk in zip(comm.devices, blocks)], start_step


def _kernel_label(kernel: str, cfg: HeatConfig, comm) -> str:
    if kernel == "torch":
        return "torch-step"
    name = "ftcs2d" if cfg.ndim == 2 else "ftcs3d"
    if comm.devices[0].type == "cuda":
        return f"cuda {name}"
    return f"{name} plain version (cpu)"


def _announce(cfg: HeatConfig, comm) -> None:
    """The reference's per-rank announcements (mesh decomposition, local
    nx/ny at mpi+cuda/heat.F90:239-240, rank -> GPU at :69), master-only."""
    mesh = comm.mesh
    master_print(f"Automatic mesh decomposition: "
                 f"{dict(zip(mesh.axis_names, mesh.shape))}")
    master_print("local block: " + " x ".join(
        str(cfg.n // s) for s in mesh.shape))
    if isinstance(comm, DistComm):
        where = [None] * mesh.size
        dist.all_gather_object(where, (str(comm.devices[0]), comm.rank),
                               group=comm.host)
    else:
        where = [(str(d), 0) for d in comm.devices]
    for rank, (dev, proc) in list(enumerate(where))[:32]:
        master_print(f"  mesh {mesh.coords(rank)} -> device {dev} "
                     f"(process {proc})")
    if mesh.size > 32:
        master_print(f"  ... ({mesh.size - 32} more shards)")
    if cfg.checkpoint_every:
        master_print("checkpoint I/O: "
                     + ("async snapshot-and-continue (bounded queue depth "
                        "2; --async-io off for the sync fallback)"
                        if cfg.use_async_io() else "sync (--async-io off)"))


@register("sharded")
def solve(cfg: HeatConfig, T0: Optional[np.ndarray] = None, device=None,
          comm=None, virtual_devices: Optional[int] = None,
          fetch: bool = True, warm_exec: bool = False,
          two_point_repeats: int = 0, **_) -> SolveResult:
    comm = comm or make_comm(cfg, device, virtual_devices)
    mesh = comm.mesh
    validate_divisible(cfg.n, mesh)
    kf = fuse_depth_sharded(cfg, mesh.shape)
    padded_shape = [cfg.n // s + 2 * kf for s in mesh.shape]
    _announce(cfg, comm)

    if cfg.parity_order:
        if cfg.checkpoint_every:
            raise ValueError(
                "parity_order is a bit-parity experiment mode and does not "
                "support checkpointing (the carried state is the padded field)")
        master_print("step ordering: update-then-swap "
                     "(reference parity, mpi+cuda/heat.F90:206-219)")
        owned, start_step = _initial_shards(cfg, T0, comm)
        seed, one_step = make_parity_machinery(cfg, comm)
        state = ShardField(seed(owned, from_ic=T0 is None), comm, cfg.n, 1)
        advance, warm = _chunked_advance(lambda shards, _: one_step(shards), 1)
        kernel = "torch"
        label = "torch-step (parity order)"
    else:
        kernel = resolve_local_kernel(cfg, comm, padded_shape)
        padded_multi = make_local_multistep(cfg, comm, kernel)
        owned, start_step = _initial_shards(cfg, T0, comm)
        state = ShardField([halo_pad(s, cfg.bc_value, kf) for s in owned],
                           comm, cfg.n, kf)
        del owned
        # margins stay width kf; only the step count shrinks on the
        # remainder block
        advance, warm = _chunked_advance(
            lambda shards, k: padded_multi(shards, kf, k), kf)
        label = _kernel_label(kernel, cfg, comm)

    res = drive(cfg, state, advance, warm, start_step=start_step,
                kernel=label, ops=SHARD_OPS, fetch=fetch,
                warm_exec=warm_exec, two_point_repeats=two_point_repeats)
    res.gsum = comm.broadcast(res.gsum)
    if res.gsum is not None:
        res.gsum_dtype = "float64"
    res.mesh_shape = tuple(mesh.shape)
    res.mesh = mesh
    res.exchange = dict(comm.stats, kf=kf, local_kernel=kernel)
    return res
