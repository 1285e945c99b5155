"""The hand-written multi-lane serving kernels and their plain PyTorch versions.

Counterpart of ``heat_tpu.ops.pallas_stencil``'s lane surface
(``pallas_stencil.py:882-1365``). The serving engine (``serve/engine.py``)
steps up to ``L`` independent requests as one stacked ``(L,) + (B+2,)*nd``
array: lane ``l`` holds its request in the ``[1 : 1+n_l]`` corner of a
one-cell-margined bucket buffer, with its own stencil coefficient ``r_l``,
side ``n_l`` and countdown ``rem_l``. There two Pallas kernels step it, K4
``_lane_pallas_2d`` and K5 ``_lane_pallas_3d``; here ``csrc/lanes2d.cu``
and ``csrc/lanes3d.cu``. The TPU's alignment padding (``lane_state_shape``)
does not come across: both kernels step the engine's own layout.

Per cell and mini-step ``s`` of a chunk (global index ``g = offset + s``)::

    live = every buffer coordinate b satisfies bc_lo < b < n_l + 1 - bc_lo
           (bc_lo = 0 for ghost, 1 for edges; pallas_stencil.py:1076-1078)
    keep = live and g < rem_l                          (pallas_stencil.py:1095)
    2D:  s   = ((row+1 + col+1) + row-1) + col-1       (laplacian_interior's
         lap = s + (-4)*c                               order: +1 neighbours in
    3D:  s   = ((((row+1 + mid+1) + col+1)              axis order, then -1)
                 + row-1) + mid-1) + col-1
         lap = fma(-6, c, s)                            ONE rounding
         u   = fma(r_l, lap, c)                         ONE rounding
         u   = round(u) to the storage dtype            EVERY step (bf16: RNE;
                                                        f32: NaN as 0x7fc00000)
    c'   = keep ? u : c                                 select, never multiply

The reference's jitted XLA lane program (``serve/engine.py:356-382``) and
its interpret-mode Pallas lane kernels agree with this form byte for byte
and with no other (``tests/test_torch_lane_kernels.py`` pins the forms);
the select keeps a NaN in its own lane and frozen cells' bytes unchanged.
Because every step rounds, a pass boundary is not a rounding point: the
kernels pick their own depth per pass, with rows streamed through the
block and the steps pipelined in registers (``lanes2d`` up to ``PASS_2D``
steps, of the 16 its kernel takes, its launch geometry mirrored by
``lanes2d_geometry``; ``lanes3d`` up to ``PASS_3D``, of the 8 its kernel
takes, mirrored by ``lanes3d_geometry``).

Fused into the chunk's last pass, per lane: the finite bit (AND over the
whole slab, margin included) and four float32 stats over the request
region (buffer coordinates ``[1, n_l]`` on every axis, the Dirichlet ring
included): resid = max|out - pre-final-step| over the chunk's final
mini-step, tmin, tmax, and heat = sum. A non-finite value cannot become
finite again under the update (NaN propagates; a live Inf cell turns NaN;
a kept cell keeps its value), so the finite bit of the last pass equals
the AND over every pass that the reference takes. The kernels reduce
across blocks with atomics: resid/tmin/tmax are order-free (exact on
finite lanes), heat is a float32 sum in another order (a tolerance).

They write the engine's ``(6, L)`` int32 boundary vector directly (rows:
remaining after the chunk, finite, then the four stats bitcast; the
layout of ``serve/engine.BOUNDARY_ROWS``), and the post-chunk countdown
``max(rem - k, 0)`` into a second vector, so a chunk on the card is its
kernel launches and nothing else.

f64 has no kernel (as in the reference, which serves f64 through its XLA
program): the plain versions then take the port's ``torch`` step
arithmetic, ``c + r*lap`` with ``lap = s + (-2*nd)*c``, each operation
rounded, which is the serial oracle's.

Every wrapper takes tensors on the card or on the CPU: on a CUDA tensor it
launches the kernel (or raises); on a CPU tensor, or with ``plain=True``,
it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .cuda_stencil import _fma_f32

# rows of the per-chunk boundary vector (serve/engine.BOUNDARY_ROWS)
K_BOUNDARY = 6

# steps per lanes2d launch: at most 16 (csrc/lanes2d.cu LANE_KMAX); a
# chunk launches at most 8 at a time (PERF.md: two 8-step launches beat
# one 16-step launch at every bucket on the H100, most at the small ones,
# whose 16-row halo would dwarf their segments)
KMAX_2D = 16
PASS_2D = 8
# steps per lanes3d launch: at most 8 (csrc/lanes3d.cu LANE_KMAX); a chunk
# launches at most 4 at a time (PERF.md: the depth sweep at 8 x 258^3 on
# the H100)
KMAX_3D = 8
PASS_3D = 4

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {2: "lanes2d", 3: "lanes3d"}

# Launches of each kernel in this process (plain-version passes are not
# counted): a run can show that its main path went through the kernel.
launches = {"lanes2d": 0, "lanes3d": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _as_torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}[str(dtype)]


class Lanes2dGeometry(NamedTuple):
    """A ``lanes2d`` launch: each warp streams a region ``region`` cells
    wide whose middle ``out_cols`` columns it writes; a block's warps write
    ``block_cols`` adjacent columns of one segment of ``seg_rows`` rows; the
    grid is (column blocks, segments, lanes)."""

    region: int
    out_cols: int
    block_cols: int
    seg_rows: int
    grid: Tuple[int, int, int]


# csrc/stencil2d_stream.cuh at k <= 16: 4 cells a thread, a warp a region,
# four warps a block; segments of 8 (lanes2d.cu LANE_LZMIN) to 256 rows, at
# most 65535 of them
_REGION_2D = 128
_WARPS_2D = 4
_SEG_ROWS_2D = (8, 256)
_MAX_GRID_Y = 65535


def lanes2d_geometry(L: int, m: int, k: int, slots: int) -> Lanes2dGeometry:
    """``lanes2d``'s launch geometry for ``L`` lanes of ``m x m`` at depth
    ``k`` on a card that holds ``slots`` of its blocks at once (the mirror of
    ``stream2_lz`` and ``lanes2d_geo`` in ``csrc/``): the segment length of
    8..256 rows whose grid, counted in waves of ``slots`` blocks, costs the
    fewest row-times (waves x (rows + 2k)), the longest of equals."""
    if not (1 <= k <= KMAX_2D and m >= 3 and 1 <= L <= 65535 and slots >= 1):
        raise ValueError(f"no lanes2d launch for L={L}, m={m}, k={k}, "
                         f"slots={slots}")
    out_cols = _REGION_2D - 2 * k
    block_cols = _WARPS_2D * out_cols
    gx = -(-m // block_cols)
    best, lz = None, 0
    for rows in range(_SEG_ROWS_2D[0], _SEG_ROWS_2D[1] + 1):
        segs = -(-m // rows)
        if segs > _MAX_GRID_Y:
            continue
        cost = -(-(gx * L * segs) // slots) * (rows + 2 * k)
        if best is None or cost <= best:
            best, lz = cost, rows
    if best is None:
        raise ValueError(f"m={m} needs over {_MAX_GRID_Y} segments")
    return Lanes2dGeometry(_REGION_2D, out_cols, block_cols, lz,
                           (gx, -(-m // lz), L))


class Lanes3dGeometry(NamedTuple):
    """A ``lanes3d`` launch: a block owns a ``tile x tile`` (mid, col)
    output tile (at most ``tile_max``, the compiled region's, on a side) and
    a segment of ``seg_rows`` rows of one lane, with ``threads`` threads;
    the grid is (column tiles x lanes, mid tiles, segments)."""

    tile_max: int
    tile: int
    seg_rows: int
    threads: int
    grid: Tuple[int, int, int]


# csrc/lanes3d.cu: tiles of at most 48 cells a side at k <= 4, 32 above;
# segments of 8 (LANE_LZMIN) to 1024 (LANE_LZMAX) rows
_SEG_ROWS_3D = (8, 1024)


def _lane_tile_3d(k: int) -> int:
    return 48 if k <= 4 else 32


def _stream3_threads(k: int, tile: int) -> int:
    """Threads of a block of ``stencil3d_stream.cuh``'s ``Stream<k, tile,
    tile>``: one per 4 cells of the (tile + 2k)-square region, rows padded
    to 4 cells, rounded up to whole warps."""
    side = tile + 2 * k
    groups = side * (-(-side // 4))
    return -(-groups // 32) * 32


def lanes3d_geometry(L: int, m: int, k: int, slots: int) -> Lanes3dGeometry:
    """``lanes3d``'s launch geometry for ``L`` lanes of ``m^3`` at depth
    ``k`` on a card that holds ``slots`` of its blocks at once (the mirror of
    ``lanes3d_geo`` in ``csrc/lanes3d.cu``): ``ceil(m / tile_max)`` tiles a
    side, cut to ``ceil(m / tiles)`` cells, and the segment length of
    ``min(8, m)..min(1024, m)`` rows whose grid, counted in waves of
    ``slots`` blocks, costs the fewest row-times (waves x (rows + 2k)), the
    longest of equals."""
    if not (1 <= k <= KMAX_3D and 3 <= m <= 46341 and 1 <= L <= 65535
            and slots >= 1):
        raise ValueError(f"no lanes3d launch for L={L}, m={m}, k={k}, "
                         f"slots={slots}")
    tile_max = _lane_tile_3d(k)
    tiles = -(-m // tile_max)
    blocks = tiles * tiles * L
    best, lz = None, 0
    for rows in range(min(_SEG_ROWS_3D[0], m), min(_SEG_ROWS_3D[1], m) + 1):
        segs = -(-m // rows)
        if segs > _MAX_GRID_Y:
            continue
        cost = -(-(blocks * segs) // slots) * (rows + 2 * k)
        if best is None or cost <= best:
            best, lz = cost, rows
    return Lanes3dGeometry(tile_max, -(-m // tiles), lz,
                           _stream3_threads(k, tile_max),
                           (tiles * L, tiles, -(-m // lz)))


def lane_kernel_available(ndim: int, dtype) -> bool:
    """True where a lane kernel serves the bucket: f32 and bf16, 2D and 3D
    (the counterpart of the reference's ``lane_kernel_available``; every
    f32/bf16 bucket has one here, f64 none)."""
    return ndim in _KERNELS and _as_torch_dtype(dtype) in _KERNEL_DTYPES


def passes(ndim: int, ksteps: int, depth: int = 0) -> list:
    """Steps of each kernel launch in a ``ksteps``-step chunk: up to
    ``depth`` per launch, by default ``PASS_2D`` (8) in 2D and ``PASS_3D``
    (4) in 3D."""
    cap = depth or (PASS_2D if ndim == 2 else PASS_3D)
    return [min(cap, ksteps - d) for d in range(0, ksteps, cap)]


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------


def _axis_view(v: torch.Tensor, nd: int, d: int) -> torch.Tensor:
    """(L, k) per-lane axis vector shaped to broadcast along axis ``d``."""
    shape = [v.shape[0]] + [1] * nd
    shape[d + 1] = v.shape[1]
    return v.view(shape)


def _region_masks(L: int, m: int, n: torch.Tensor, bc_lo: int, nd: int):
    """(live on the interior, request region on the whole buffer), each
    (L,) + spatial, per lane."""
    inner = torch.arange(1, m - 1, device=n.device)
    full = torch.arange(m, device=n.device)
    nl = n.view(L, 1).to(torch.int64)
    live_ax = (inner > bc_lo) & (inner < nl + 1 - bc_lo)
    region_ax = (full >= 1) & (full <= nl)
    live = region = None
    for d in range(nd):
        a = _axis_view(live_ax, nd, d)
        b = _axis_view(region_ax, nd, d)
        live = a if live is None else live & a
        region = b if region is None else region & b
    return live, region


def _qnan(device) -> torch.Tensor:
    """The f32 quiet NaN 0x7fc00000, by its bits (filled on the device: no
    host-to-device copy, which would fence the stream)."""
    return torch.full((), 0x7FC00000, dtype=torch.int32,
                      device=device).view(torch.float32)


def _lane_step(T: torch.Tensor, r: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """One masked lane step of the stack ``T``; ``keep`` is (L,)+interior.
    f32/bf16: the kernels' arithmetic (FMA update, per-step storage
    rounding); f64: two roundings, the serial oracle's."""
    nd = T.dim() - 1
    acc = torch.float32 if T.dtype in _KERNEL_DTYPES else T.dtype
    Tc = T.to(acc)
    ctr = (slice(None),) + (slice(1, -1),) * nd
    s = None
    for off in (slice(2, None), slice(0, -2)):
        for d in range(nd):
            sl = list(ctr)
            sl[d + 1] = off
            s = Tc[tuple(sl)] if s is None else s + Tc[tuple(sl)]
    c = Tc[ctr]
    rr = r.to(acc).view((-1,) + (1,) * nd)
    if acc == torch.float32:
        lap = s + (-4.0) * c if nd == 2 else _fma_f32(-6.0, c, s)
        u = _fma_f32(rr.expand_as(c), lap, c)
        if T.dtype == torch.float32:
            # the kernels write every f32 NaN they compute as 0x7fc00000
            u = torch.where(u.isnan(), _qnan(u.device), u)
    else:
        u = c + rr * (s + (-2.0 * nd) * c)
    out = T.clone()
    out[ctr] = torch.where(keep, u.to(T.dtype), T[ctr])
    return out


def _lane_multistep_plain(fields: torch.Tensor, r: torch.Tensor,
                          n: torch.Tensor, rem: torch.Tensor, ksteps: int,
                          bc_lo: int) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """``ksteps`` masked, countdown-gated steps over the lane stack;
    returns (fields, finite (L,) bool, stats (4, L) float32)."""
    if ksteps < 1:
        raise ValueError(f"a lane chunk runs >= 1 steps, got {ksteps}")
    L, m = fields.shape[0], fields.shape[1]
    nd = fields.dim() - 1
    live, region = _region_masks(L, m, n, bc_lo, nd)
    lane_rem = rem.view((L,) + (1,) * nd)
    prev = T = fields
    for s in range(ksteps):
        prev = T
        T = _lane_step(T, r, live & (s < lane_rem))
    finite = torch.isfinite(T).reshape(L, -1).all(dim=1)
    return T, finite, lane_stats(prev, T, region)


def lane_stats(prev: torch.Tensor, fields: torch.Tensor,
               region: torch.Tensor) -> torch.Tensor:
    """Per-lane float32 (resid, tmin, tmax, heat) of the post-chunk stack
    over the request ``region`` (the reference's ``serve/engine._lane_stats``):
    max |fields - prev|, min, max and sum, each reduced in float32."""
    axes = tuple(range(1, fields.dim()))
    out32, prev32 = fields.float(), prev.float()
    inf = torch.full((), float("inf"), device=fields.device)
    zero = torch.zeros((), device=fields.device)
    return torch.stack([
        torch.where(region, (out32 - prev32).abs(), zero).amax(dim=axes),
        torch.where(region, out32, inf).amin(dim=axes),
        torch.where(region, out32, -inf).amax(dim=axes),
        torch.where(region, out32, zero).sum(dim=axes)])


def lane_multistep_2d_plain(fields, r, n, rem, ksteps: int, bc_lo: int):
    """``lanes2d``'s plain PyTorch version (any number of steps)."""
    if fields.dim() != 3:
        raise ValueError(f"2D lane stack is (L, m, m), got {tuple(fields.shape)}")
    return _lane_multistep_plain(fields, r, n, rem, ksteps, bc_lo)


def lane_multistep_3d_plain(fields, r, n, rem, ksteps: int, bc_lo: int):
    """``lanes3d``'s plain PyTorch version (any number of steps)."""
    if fields.dim() != 4:
        raise ValueError(f"3D lane stack is (L, m, m, m), got {tuple(fields.shape)}")
    return _lane_multistep_plain(fields, r, n, rem, ksteps, bc_lo)


_PLAIN = {2: lane_multistep_2d_plain, 3: lane_multistep_3d_plain}


def write_boundary(boundary: torch.Tensor, remaining: torch.Tensor,
                   finite: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Fill a ``(6, L)`` int32 boundary vector in place: remaining, the
    finite bits, and the float32 stats bitcast (no rounding: NaN/Inf
    payloads survive)."""
    boundary[0].copy_(remaining)
    boundary[1].copy_(finite)
    boundary[2:K_BOUNDARY].view(torch.float32).copy_(stats)
    return boundary


# --------------------------------------------------------------------------
# the kernels' wrapper
# --------------------------------------------------------------------------


def _kernel_fn(name: str, export: str = ""):
    """``heat_<name>`` (or ``export``, an export of the same signature: the
    earlier designs ``heat_lanes2d_band`` and ``heat_lanes3d_step``) from the
    built library, with its C signature."""
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_heat_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # dtype, in, out, L, m, r, n, rem, k, offset, bc_lo, rem_out,
        # boundary, ktotal, stream
        for fn_name in (f"heat_{name}", "heat_lanes2d_band",
                        "heat_lanes3d_step"):
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = [i, p, p, i, i, p, p, p, i, i, i, p, p, i, p]
        for fn_name in ("heat_lanes2d_geometry", "heat_lanes3d_geometry"):
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = [i, i, i, i, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int64)]
        lib.heat_cuda_error_string.restype = ctypes.c_char_p
        lib.heat_cuda_error_string.argtypes = [i]
        lib._heat_typed = True
    return lib, getattr(lib, export or f"heat_{name}")


def compiled_lanes2d_geometry(dtype, L: int, m: int,
                              k: int) -> Tuple[Lanes2dGeometry, int]:
    """The geometry ``heat_lanes2d`` launches with (its C export
    ``heat_lanes2d_geometry``) and the card's resident blocks of the
    instance it was sized for. Needs the card's build; ``chip_smoke.py``
    holds ``lanes2d_geometry`` to it."""
    lib, _ = _kernel_fn("lanes2d")
    geo = (ctypes.c_int64 * 8)()
    err = lib.heat_lanes2d_geometry(_KERNEL_DTYPES[_as_torch_dtype(dtype)], L,
                                    m, k, 0, geo)
    if err:
        raise RuntimeError(f"heat_lanes2d_geometry: "
                           f"{lib.heat_cuda_error_string(err).decode()}")
    v = list(geo)
    return Lanes2dGeometry(v[0], v[1], v[2], v[3], (v[4], v[5], v[6])), v[7]


def compiled_lanes3d_geometry(dtype, L: int, m: int,
                              k: int) -> Tuple[Lanes3dGeometry, int]:
    """The geometry ``heat_lanes3d`` launches with (its C export
    ``heat_lanes3d_geometry``) and the card's resident blocks of the
    instance it was sized for. Needs the card's build; ``chip_smoke.py``
    holds ``lanes3d_geometry`` to it."""
    lib, _ = _kernel_fn("lanes3d")
    geo = (ctypes.c_int64 * 8)()
    err = lib.heat_lanes3d_geometry(_KERNEL_DTYPES[_as_torch_dtype(dtype)], L,
                                    m, k, 0, geo)
    if err:
        raise RuntimeError(f"heat_lanes3d_geometry: "
                           f"{lib.heat_cuda_error_string(err).decode()}")
    v = list(geo)
    return Lanes3dGeometry(v[0], v[1], v[2], v[3], (v[4], v[5], v[6])), v[7]


def _launch_passes(lib, fn, label: str, fields, spare, r, n, rem, rem_out,
                   boundary, ksteps: int, bc_lo: int, count: bool,
                   depth: int = 0, keep=None):
    """The chunk's kernel passes through ``fn`` (``passes()``' depths, up to
    ``depth`` steps a launch), ping-ponging ``fields`` and ``spare``;
    returns the post-chunk stack. With a third stack ``keep``, the input is
    kept: the first pass reads ``fields`` and writes ``spare``, the later
    passes ping-pong ``spare`` and ``keep``, and ``fields`` is never
    written (every kernel takes distinct in and out stacks, so this costs
    no copy). Adds one to ``launches[label]`` per launch where ``count``."""
    nd = fields.dim() - 1
    L, m = fields.shape[0], fields.shape[1]
    src, dst = fields, spare
    other = fields if keep is None else keep
    offset = 0
    schedule = passes(nd, ksteps, depth)
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream(fields.device).cuda_stream
        for i, k in enumerate(schedule):
            last = i == len(schedule) - 1
            err = fn(_KERNEL_DTYPES[fields.dtype], src.data_ptr(),
                     dst.data_ptr(), L, m, r.data_ptr(), n.data_ptr(),
                     rem.data_ptr(), k, offset, bc_lo,
                     rem_out.data_ptr() if last else None,
                     boundary.data_ptr() if last else None, ksteps, stream)
            if err:
                raise RuntimeError(
                    f"{label} launch failed: "
                    f"{lib.heat_cuda_error_string(err).decode()} (stack "
                    f"{tuple(fields.shape)}, {fields.dtype}, k={k})")
            if count:
                launches[label] += 1
            offset += k
            src, dst = dst, (other if i == 0 else src)
    return src


def _check_lane_vectors(fields, r, n, rem, rem_out, boundary) -> None:
    L = fields.shape[0]
    # r lives in the accumulation dtype: f32 for f32/bf16 stacks, f64 for f64
    r_dtype = torch.float32 if fields.dtype in _KERNEL_DTYPES else fields.dtype
    for name, v, dt, shape in (("r", r, r_dtype, (L,)),
                               ("n", n, torch.int32, (L,)),
                               ("rem", rem, torch.int32, (L,)),
                               ("rem_out", rem_out, torch.int32, (L,)),
                               ("boundary", boundary, torch.int32,
                                (K_BOUNDARY, L))):
        if (v.dtype != dt or tuple(v.shape) != shape or v.device != fields.device
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} {shape} tensor "
                             f"on {fields.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if rem_out.data_ptr() == rem.data_ptr():
        raise ValueError("rem_out must not alias rem (the last pass reads "
                         "the chunk-start countdown)")


def lane_chunk(fields: torch.Tensor, spare: torch.Tensor, r: torch.Tensor,
               n: torch.Tensor, rem: torch.Tensor, rem_out: torch.Tensor,
               boundary: torch.Tensor, ksteps: int, bc_lo: int, *,
               plain: bool = False, keep=None) -> torch.Tensor:
    """One serving chunk of ``ksteps`` steps over the lane stack: the
    engine's entry. Writes ``rem_out`` = max(rem - ksteps, 0) and the
    ``(6, L)`` ``boundary`` vector, and returns the post-chunk stack —
    ``fields`` or ``spare``: the passes ping-pong between the two
    preallocated stacks, so both are the caller's scratch (a chunk of
    three or more passes overwrites ``fields``). Given a third stack
    ``keep`` (keep-input mode), ``fields`` is only read: the passes
    ping-pong ``spare`` and ``keep``, and the post-chunk stack is one of
    those two. On a CUDA tensor the kernel runs, on a CPU tensor (or with
    ``plain=True``) the plain version (which never writes ``fields``)."""
    nd = fields.dim() - 1
    if nd not in _KERNELS:
        raise ValueError(f"lane stacks are (L,)+(m,)*nd with nd 2 or 3, got "
                         f"{tuple(fields.shape)}")
    if ksteps < 1:
        raise ValueError(f"a lane chunk runs >= 1 steps, got {ksteps}")
    if (spare.shape != fields.shape or spare.dtype != fields.dtype
            or spare.device != fields.device
            or spare.data_ptr() == fields.data_ptr()):
        raise ValueError("spare must be a distinct stack of fields' shape, "
                         "dtype and device")
    if keep is not None and (
            keep.shape != fields.shape or keep.dtype != fields.dtype
            or keep.device != fields.device
            or keep.data_ptr() in (fields.data_ptr(), spare.data_ptr())):
        raise ValueError("keep must be a third distinct stack of fields' "
                         "shape, dtype and device")
    _check_lane_vectors(fields, r, n, rem, rem_out, boundary)
    if plain or fields.device.type == "cpu":
        out, finite, stats = _PLAIN[nd](fields, r, n, rem, ksteps, bc_lo)
        spare.copy_(out)
        rem_out.copy_(torch.clamp(rem - ksteps, min=0))
        write_boundary(boundary, rem_out, finite, stats)
        return spare
    if fields.device.type != "cuda":
        raise ValueError(f"the lane kernels run on CUDA or CPU tensors, got "
                         f"{fields.device}")
    if fields.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the lane kernels take float32/bfloat16 stacks, got "
                         f"{fields.dtype} (gate on lane_kernel_available)")
    if not (fields.is_contiguous() and spare.is_contiguous()
            and (keep is None or keep.is_contiguous())):
        raise ValueError("lane stacks must be contiguous")
    name = _KERNELS[nd]
    lib, fn = _kernel_fn(name)
    return _launch_passes(lib, fn, name, fields, spare, r, n, rem, rem_out,
                          boundary, ksteps, bc_lo, count=True, keep=keep)


def lane_multistep(fields: torch.Tensor, r: torch.Tensor, n: torch.Tensor,
                   rem: torch.Tensor, ksteps: int, bc_lo: int, *,
                   plain: bool = False):
    """``ksteps`` masked, countdown-gated FTCS steps over a stacked lane
    array, the finite bit and the numerics stats fused in (the reference's
    ``pallas_stencil.lane_multistep``). ``r`` (L,) float32, ``n``/``rem``
    (L,) int32. Returns ``(fields, finite, stats)``: ``finite`` a per-lane
    bool, False iff that lane's post-chunk slab holds a non-finite value;
    ``stats`` (4, L) float32 (resid, tmin, tmax, heat)."""
    if plain or fields.device.type == "cpu":
        return _PLAIN[fields.dim() - 1](fields, r, n, rem, ksteps, bc_lo)
    L = fields.shape[0]
    boundary = torch.empty((K_BOUNDARY, L), dtype=torch.int32,
                           device=fields.device)
    # the caller's stack is an input: keep-input passes never write it
    fields = fields.contiguous()
    out = lane_chunk(fields, torch.empty_like(fields), r, n, rem,
                     torch.empty_like(rem), boundary, ksteps, bc_lo,
                     keep=torch.empty_like(fields))
    return out, boundary[1] != 0, boundary[2:K_BOUNDARY].view(torch.float32)
