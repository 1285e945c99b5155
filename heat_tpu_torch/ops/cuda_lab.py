"""The kernel lab's candidate stencil kernels on Hopper, and their plain
PyTorch versions.

Counterpart of the five Pallas kernels of ``benchmarks/kernel_lab.py``,
the bench on which the JAX package chose its solo kernels' bodies: the
neighbour order, a hoisted decay constant, per-step bf16 rounding and the
tile geometry, each a candidate measured against the shipped form. Here
they are the candidate bodies of the Hopper kernels (``csrc/lab2d.cu``,
``csrc/lab3d.cu``), each an instance of one templated kernel per
dimension, the one the shipped kernels instantiate too:

==========================  ==========  ==============================
function (JAX line)         variant     arithmetic
==========================  ==========  ==============================
L1 ``lab_3d_tiled`` (:171)  --          3D order "l1", update "lap"
L2 ``lab_3d_rolled`` (:279) f32         3D order "l2", update "lap"
                            fma         3D order "l2", update "decay"
L3 ``lab_thin2d_variant``   shrink,     2D order "k1", update "lap"
(:474)                      rolled
                            rolledfma   2D order "k1", update "decay"
                            bf16native  2D order "k1", "lap", every step
L4 ``lab_2d_coltiled``      --          2D order "l4", update "lap"
(:628)
L5 ``lab_2d_coltiled_       f32         2D order "k1", update "lap"
rolled`` (:744)             fma         2D order "k1", update "decay"
                            bf16native  2D order "k1", "lap", every step
                            bf16fma     2D order "k1", "decay", every step
==========================  ==========  ==============================

Per cell and mini-step, on an f32 band (``c`` the cell, ``m`` = 0 where
the bounds freeze it, else ``r`` rounded to f32; ``fma`` one rounding)::

    2D "k1":  s = ((row-1 + row+1) + col-1) + col+1     (K1's order)
    2D "l4":  s = ((row+1 + row-1) + col+1) + col-1
    3D "l1":  s = ((((row+1 + row-1) + mid+1) + mid-1) + col-1) + col+1
                                                        (K3's order)
    3D "l2":  s = ((((row-1 + row+1) + mid-1) + mid+1) + col-1) + col+1
    "lap":    2D c' = fma(m, s - 4c, c)
              3D c' = fma(m, fma(-6, c, s), c)
    "decay":  c' = fma(decay, c, m*s),  decay = 1 - 4m in 2D (4m exact),
                                        decay = fma(-6, m, 1) in 3D

and the band is rounded to the storage dtype once at the end of the call,
or, for "every step", after each mini-step as well. These are the forms
the interpret-mode Pallas kernels compute (their compiled bodies contract
``a*b + c`` into fused multiply-adds, including the hoisted 3D decay);
``tests/test_torch_lab_kernels.py`` holds each plain version to them byte
for byte and shows that each other form differs. The shipped kernels
(``cuda_stencil``'s ``ftcs2d`` / ``ftcs3d``) are instances of the same
kernel bodies (``csrc/stencil2d_stream.cuh``,
``csrc/stencil3d_stream.cuh``):
L1, L3 shrink/rolled and L5 f32 at the first tile of ``BLOCKS_2D`` /
``BLOCKS_3D`` are the shipped kernels, so an A/B on the card compares like
with like.

The JAX signatures are kept, so that the tests feed both packages the same
padded arrays: ``Tp`` is the padded field, ``logical`` its true extent,
and the TPU geometry (row/mid/column tiles and halo depths) is validated as
the JAX asserts do but changes no byte. The Hopper tile is the kernels' own
``block`` argument, one of a few compiled instances (``BLOCKS_2D``,
``BLOCKS_3D``, whose first 3D tile is the streamed design the shipped
``ftcs3d`` has, the others the band design it had before, so the lab times
both on one field); a depth or a tile that cannot launch raises a
``ValueError`` naming the limit before anything launches. ``bounds`` must
freeze every edge of the padded array (``0 <= lo`` and ``hi <= size - 1``
per axis), so that no cell that updates reads across it: outside the array
the kernels load zeros, the plain versions wrap and the TPU kernels read
clamped blocks, and only frozen cells see those values. Frozen cells are
kept by the multiply-mask (``c + 0*lap``), as in the Pallas bodies, so a
NaN that reaches them spreads into them.

Like ``cuda_stencil``: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises, and ``plain=True`` runs the plain version on
any device (the yardstick on the card). ``launches`` counts kernel launches
by function and variant.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from .cuda_stencil import _KERNEL_DTYPES, _fma_f32, _maskr


class Form(NamedTuple):
    """The arithmetic of one (function, variant): neighbour order, update
    form, and whether the band is rounded to storage after every step."""

    ndim: int
    order: str
    update: str
    every_step: bool


FORMS = {
    ("lab_3d_tiled", None): Form(3, "l1", "lap", False),
    ("lab_3d_rolled", "f32"): Form(3, "l2", "lap", False),
    ("lab_3d_rolled", "fma"): Form(3, "l2", "decay", False),
    ("lab_thin2d_variant", "shrink"): Form(2, "k1", "lap", False),
    ("lab_thin2d_variant", "rolled"): Form(2, "k1", "lap", False),
    ("lab_thin2d_variant", "rolledfma"): Form(2, "k1", "decay", False),
    ("lab_thin2d_variant", "bf16native"): Form(2, "k1", "lap", True),
    ("lab_2d_coltiled", None): Form(2, "l4", "lap", False),
    ("lab_2d_coltiled_rolled", "f32"): Form(2, "k1", "lap", False),
    ("lab_2d_coltiled_rolled", "fma"): Form(2, "k1", "decay", False),
    ("lab_2d_coltiled_rolled", "bf16native"): Form(2, "k1", "lap", True),
    ("lab_2d_coltiled_rolled", "bf16fma"): Form(2, "k1", "decay", True),
}

# the C interface's codes (csrc/lab2d.cu, csrc/lab3d.cu)
_ORDER_CODE = {"k1": 0, "l4": 1, "l1": 0, "l2": 1}
_UPDATE_CODE = {"lap": 0, "decay": 1}
_SOURCES = {2: "lab2d", 3: "lab3d"}

# the compiled Hopper tiles, (rows, cols) and (rows, mids, cols); the first
# of each is the shipped kernel's (csrc/ftcs2d.cu, csrc/ftcs3d.cu), the
# streamed design's, the others output tiles of the band design, the
# shipped kernel's earlier one. In 2D the streamed tile
# (csrc/stencil2d_stream.cuh) is segments of up to 256 rows (as many as
# fill whole waves of the card: stream2_lz) of a region
# 128 cells wide (one warp of 4-cell threads, 128 - 2k output columns) up
# to 16 steps, and 256 wide (four warps of 2-cell threads) at 17..32; the
# band tiles
# (csrc/stencil2d.cuh) ping-pong two f32 bands. In 3D the streamed tile
# (csrc/stencil3d_stream.cuh) is 256-row segments of a 32 x 32 (mid, col)
# output tile; the band (csrc/stencil3d.cuh) is updated in place
STREAM_2D = (256, 128)
# the depths csrc/lab2d.cu compiles the streamed tile at (an instance per
# depth, form and dtype): those the lab's checks, benches and chip_smoke.py
# run; the band tiles take every depth 1..KMAX_2D
STREAM_2D_DEPTHS = (1, 5, 6, 16, 32)
BLOCKS_2D = (STREAM_2D, (64, 96), (32, 192))
STREAM_3D = (256, 32, 32)
BLOCKS_3D = (STREAM_3D, (16, 16, 32), (8, 16, 64))
KMAX_2D = 32                    # halo width of the widest 2D instance
KMAX_3D = 8
SMEM_LIMIT = 232448             # bytes of shared memory a block may opt into

# f32 operations per updated cell-step: 2D "lap" 3 adds, the exact 4c, the
# subtract and the FMA as 2; "decay" 3 adds, m*s and the FMA; 3D "lap" 5
# adds and two FMAs; "decay" 5 adds, m*s and the FMA
OPS_PER_CELL_STEP = {(2, "lap"): 7, (2, "decay"): 6,
                     (3, "lap"): 9, (3, "decay"): 8}


def key(name: str, variant: Optional[str]) -> str:
    """The label of a (function, variant): ``launches``' key."""
    return name if variant is None else f"{name}:{variant}"


# Kernel launches in this process by function and variant (plain-version
# calls are not counted): a run can show that it went through the kernels.
launches = {key(n, v): 0 for n, v in FORMS}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def ops_per_cell_step(name: str, variant: Optional[str]) -> int:
    form = FORMS[(name, variant)]
    return OPS_PER_CELL_STEP[(form.ndim, form.update)]


def smem_bytes(block: Sequence[int], ksteps: int) -> int:
    """Shared memory of one launch: two f32 bands of the tile and its
    ``ksteps`` halo in 2D (ping-pong), or for the streamed tile none up to
    16 steps (one warp spans its region) and the edge values its four warps
    hand each other beyond (three rotation phases, each of the first
    ``ksteps`` steps, two sides, four warps); in 3D one band, updated in place, or for
    the streamed tile two f32 planes of the (mid, col) tile and its halo
    for each of the first ``ksteps`` steps (one written, one read), each
    with a guard."""
    block = tuple(block)
    if block == STREAM_2D:
        # csrc/stencil2d_stream.cuh's Stream2::EDGES f32 at Stream2Shape's
        # NW: [three phases][step][two sides][four warps] edge values
        return 0 if ksteps <= 16 else 4 * 3 * ksteps * 2 * 4
    if len(block) == 2:
        return 2 * 4 * (block[0] + 2 * ksteps) * (block[1] + 2 * ksteps)
    if block == STREAM_3D:
        # csrc/stencil3d_stream.cuh's Stream: rows padded to 4 cells, one
        # thread per 4 cells in whole warps, a guard of a row + 4 each side
        rows, row = block[1] + 2 * ksteps, (block[2] + 2 * ksteps + 3) // 4 * 4
        threads = -(-(rows * row // 4) // 32) * 32
        return ksteps * 2 * 4 * (4 * threads + 2 * (row + 4))
    return 4 * (block[0] + 2 * ksteps) * (block[1] + 2 * ksteps) * (
        block[2] + 2 * ksteps)


def check_launch(ndim: int, block: Sequence[int], ksteps: int) -> tuple:
    """Raise a ValueError naming the limit if the kernel of ``ndim`` cannot
    run ``ksteps`` steps per launch with the Hopper tile ``block``; returns
    the tile as a tuple."""
    block = tuple(int(b) for b in block)
    blocks = BLOCKS_2D if ndim == 2 else BLOCKS_3D
    kmax = KMAX_2D if ndim == 2 else KMAX_3D
    if block not in blocks:
        raise ValueError(f"lab{ndim}d has no compiled tile {block}; the "
                         f"tiles are {blocks}")
    if not 1 <= ksteps <= kmax:
        raise ValueError(f"lab{ndim}d runs 1..{kmax} steps per launch (its "
                         f"halo width), got {ksteps}")
    if block == STREAM_2D and ksteps not in STREAM_2D_DEPTHS:
        raise ValueError(f"lab2d compiles its streamed tile {block} at the "
                         f"depths {STREAM_2D_DEPTHS}, got {ksteps}")
    smem = smem_bytes(block, ksteps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"lab{ndim}d tile {block} at {ksteps} steps needs "
                         f"{smem} bytes of shared memory, over the "
                         f"{SMEM_LIMIT} a block may have")
    return block


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------


def _plain_2d(T: torch.Tensor, r: float, ksteps: int, bounds, form: Form
              ) -> torch.Tensor:
    band = T.to(torch.float32)
    maskr = _maskr(T.shape, bounds, r, T.device)
    decay = 1.0 - 4.0 * maskr if form.update == "decay" else None
    for _ in range(ksteps):
        if form.order == "k1":
            s = torch.roll(band, 1, 0)            # row-1
            s += torch.roll(band, -1, 0)          # row+1
            s += torch.roll(band, 1, 1)           # col-1
            s += torch.roll(band, -1, 1)          # col+1
        else:
            s = torch.roll(band, -1, 0)           # row+1
            s += torch.roll(band, 1, 0)           # row-1
            s += torch.roll(band, -1, 1)          # col+1
            s += torch.roll(band, 1, 1)           # col-1
        if form.update == "lap":
            s -= 4.0 * band
            band = _fma_f32(maskr, s, band)
        else:
            s *= maskr
            band = _fma_f32(decay, band, s)
        del s
        if form.every_step:
            band = band.to(T.dtype).to(torch.float32)
    return band.to(T.dtype)


def _plain_3d(T: torch.Tensor, r: float, ksteps: int, bounds, form: Form
              ) -> torch.Tensor:
    band = T.to(torch.float32)
    maskr = _maskr(T.shape, bounds, r, T.device)
    decay = (_fma_f32(-6.0, maskr, torch.ones_like(maskr))
             if form.update == "decay" else None)
    first, second = (-1, 1) if form.order == "l1" else (1, -1)
    for _ in range(ksteps):
        s = torch.roll(band, first, 0)            # l1: row+1, l2: row-1
        s += torch.roll(band, second, 0)
        s += torch.roll(band, first, 1)           # l1: mid+1, l2: mid-1
        s += torch.roll(band, second, 1)
        s += torch.roll(band, 1, 2)               # col-1
        s += torch.roll(band, -1, 2)              # col+1
        if form.update == "lap":
            lap = _fma_f32(-6.0, band, s)
            del s
            band = _fma_f32(maskr, lap, band)
            del lap
        else:
            s *= maskr
            band = _fma_f32(decay, band, s)
            del s
        if form.every_step:
            band = band.to(T.dtype).to(torch.float32)
    return band.to(T.dtype)


def plain(name: str, variant: Optional[str], T: torch.Tensor, r: float,
          ksteps: int, bounds: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version of (``name``, ``variant``) on T's device."""
    form = FORMS[(name, variant)]
    fn = _plain_2d if form.ndim == 2 else _plain_3d
    return fn(T, r, ksteps, bounds, form)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _kernel_fn(ndim: int):
    """``heat_lab{2,3}d`` from the built library, with its C signature."""
    from . import _build

    name = _SOURCES[ndim]
    lib = _build.load(name)
    if not getattr(lib, "_heat_typed", False):
        fn = getattr(lib, f"heat_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * (5 if ndim == 2 else 4)
                       + [ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int64] * ndim + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_int] * (2 * ndim) + [ctypes.c_void_p])
        lib.heat_cuda_error_string.restype = ctypes.c_char_p
        lib.heat_cuda_error_string.argtypes = [ctypes.c_int]
        lib._heat_typed = True
    return lib, getattr(lib, f"heat_{name}")


def compiled_geometry(block: Sequence[int], ksteps: int) -> Optional[tuple]:
    """What ``csrc/lab2d.cu`` compiled for the 2D tile ``block`` at
    ``ksteps`` steps: (rows, cols, shared memory bytes of a launch), the
    streamed tile's rows and region width and its instance's static shared
    memory as compiled; None where it compiled no instance. Needs the
    card's build; ``chip_smoke.py`` holds ``smem_bytes`` and ``STREAM_2D``
    to it."""
    lib, _ = _kernel_fn(2)
    fn = lib.heat_lab2d_geometry
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    geo = (ctypes.c_int * 3)()
    rc = fn(BLOCKS_2D.index(tuple(block)), ksteps, geo)
    if rc == 1:                     # cudaErrorInvalidValue: not compiled
        return None
    if rc:
        raise RuntimeError(f"heat_lab2d_geometry: "
                           f"{lib.heat_cuda_error_string(rc).decode()}")
    return tuple(geo)


def _launch(name: str, variant: Optional[str], T: torch.Tensor, r: float,
            ksteps: int, bounds, block, out: Optional[torch.Tensor]
            ) -> torch.Tensor:
    form = FORMS[(name, variant)]
    block = check_launch(form.ndim, block, ksteps)
    T = T.contiguous()
    if out is None:
        out = torch.empty_like(T)
    elif (out.shape != T.shape or out.dtype != T.dtype or out.device != T.device
          or not out.is_contiguous() or out.data_ptr() == T.data_ptr()):
        raise ValueError("out must be a distinct contiguous tensor of Tp's "
                         "shape, dtype and device")
    lib, fn = _kernel_fn(form.ndim)
    blocks = BLOCKS_2D if form.ndim == 2 else BLOCKS_3D
    codes = [_KERNEL_DTYPES[T.dtype], _ORDER_CODE[form.order],
             _UPDATE_CODE[form.update]]
    if form.ndim == 2:
        codes.append(int(form.every_step))
    codes.append(blocks.index(block))
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = fn(*codes, T.data_ptr(), out.data_ptr(), *T.shape, float(r),
                 ksteps, *bounds, stream)
    if err:
        raise RuntimeError(f"{_SOURCES[form.ndim]} launch failed for "
                           f"{key(name, variant)}: "
                           f"{lib.heat_cuda_error_string(err).decode()} "
                           f"(shape {tuple(T.shape)}, {T.dtype}, k={ksteps}, "
                           f"tile {block})")
    launches[key(name, variant)] += 1
    return out


def _run(name: str, variant: Optional[str], T: torch.Tensor, r: float,
         ksteps: int, bounds, block, out, plain_: bool) -> torch.Tensor:
    if T.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the lab kernels take float32 or bfloat16, got "
                         f"{T.dtype}")
    if plain_ or T.device.type == "cpu":
        res = plain(name, variant, T, r, ksteps, bounds)
        if out is None:
            return res
        out.copy_(res)
        return out
    if T.device.type != "cuda":
        raise ValueError(f"the lab kernels run on CUDA or CPU tensors, got "
                         f"{T.device}")
    if block is None:
        block = (BLOCKS_2D if T.dim() == 2 else BLOCKS_3D)[0]
    return _launch(name, variant, T, r, ksteps, bounds, block, out)


def _check_variant(name: str, variant) -> None:
    if (name, variant) not in FORMS:
        raise ValueError(f"{name} has no variant {variant!r}; it has "
                         f"{sorted(v for n, v in FORMS if n == name)}")


def _bounds(Tp: torch.Tensor, logical: Sequence[int], bounds) -> tuple:
    """The frozen-cell bounds, ``(lo, hi)`` per axis: the logical field's
    edges by default. Raises unless they freeze every edge of Tp."""
    if len(logical) != Tp.dim() or any(
            not 1 <= int(l) <= s for l, s in zip(logical, Tp.shape)):
        raise ValueError(f"logical extent {tuple(logical)} does not fit the "
                         f"padded shape {tuple(Tp.shape)}")
    if bounds is None:
        bounds = tuple(v for l in logical for v in (0, int(l) - 1))
    bounds = tuple(int(b) for b in (bounds.reshape(-1).tolist()
                                    if isinstance(bounds, torch.Tensor)
                                    else bounds))
    if len(bounds) != 2 * Tp.dim():
        raise ValueError(f"{Tp.dim()}D bounds are {2 * Tp.dim()} values, got "
                         f"{len(bounds)}")
    for d, size in enumerate(Tp.shape):
        if bounds[2 * d] < 0 or bounds[2 * d + 1] > size - 1:
            raise ValueError(f"bounds {bounds} must freeze every edge of the "
                             f"padded array {tuple(Tp.shape)} (0 <= lo, "
                             f"hi <= size - 1 on each axis)")
    return bounds


def _check_tiles(Tp: torch.Tensor, nd: int, ksteps: int, tiles, halos) -> None:
    """The JAX function's asserts on its TPU geometry: each padded extent a
    multiple of its tile, each tile a multiple of its halo, and
    1 <= ksteps <= the smallest halo."""
    if Tp.dim() != nd:
        raise ValueError(f"expected a {nd}D padded field, got {Tp.dim()}D")
    for size, tile, halo in zip(Tp.shape, tiles, halos):
        if tile < 1 or halo < 1 or size % tile or tile % halo:
            raise ValueError(f"TPU geometry: padded {tuple(Tp.shape)}, tiles "
                             f"{tuple(tiles)}, halos {tuple(halos)} (each "
                             f"extent a multiple of its tile, each tile of "
                             f"its halo)")
    if not 1 <= ksteps <= min(halos):
        raise ValueError(f"ksteps {ksteps} must be in 1..{min(halos)} (the "
                         f"smallest halo)")


def lab_3d_tiled(Tp: torch.Tensor, r: float, ksteps: int, R: int, M: int,
                 k: int, km: int, logical: Sequence[int], bounds=None, *,
                 block=None, out=None, plain: bool = False) -> torch.Tensor:
    """L1, ``pallas_3d_tiled`` (kernel_lab.py:171): ``ksteps`` masked 3D
    steps in K3's arithmetic."""
    _check_tiles(Tp, 3, ksteps, (R, M), (k, km))
    return _run("lab_3d_tiled", None, Tp, r, ksteps,
                _bounds(Tp, logical, bounds), block, out, plain)


def lab_3d_rolled(Tp: torch.Tensor, r: float, ksteps: int, R: int, M: int,
                  k: int, km: int, logical: Sequence[int], bounds=None,
                  variant: str = "f32", *, block=None, out=None,
                  plain: bool = False) -> torch.Tensor:
    """L2, ``pallas_3d_rolled`` (kernel_lab.py:279), variants f32 / fma."""
    _check_variant("lab_3d_rolled", variant)
    _check_tiles(Tp, 3, ksteps, (R, M), (k, km))
    return _run("lab_3d_rolled", variant, Tp, r, ksteps,
                _bounds(Tp, logical, bounds), block, out, plain)


def lab_thin2d_variant(Tp: torch.Tensor, r: float, ksteps: int, tile: int,
                       kpad: int, variant: str, logical: Sequence[int], *,
                       block=None, out=None, plain: bool = False
                       ) -> torch.Tensor:
    """L3, ``pallas_thin2d_variant`` (kernel_lab.py:474), variants shrink /
    rolled / rolledfma / bf16native; bounds are the logical edges."""
    _check_variant("lab_thin2d_variant", variant)
    _check_tiles(Tp, 2, ksteps, (tile,), (kpad,))
    return _run("lab_thin2d_variant", variant, Tp, r, ksteps,
                _bounds(Tp, logical, None), block, out, plain)


def lab_2d_coltiled(Tp: torch.Tensor, r: float, ksteps: int, R: int, C: int,
                    kr: int, kc: int, logical: Sequence[int], bounds=None, *,
                    block=None, out=None, plain: bool = False) -> torch.Tensor:
    """L4, ``pallas_2d_coltiled`` (kernel_lab.py:628)."""
    _check_tiles(Tp, 2, ksteps, (R, C), (kr, kc))
    return _run("lab_2d_coltiled", None, Tp, r, ksteps,
                _bounds(Tp, logical, bounds), block, out, plain)


def lab_2d_coltiled_rolled(Tp: torch.Tensor, r: float, ksteps: int, R: int,
                           C: int, kr: int, kc: int, logical: Sequence[int],
                           bounds=None, variant: str = "f32", *, block=None,
                           out=None, plain: bool = False) -> torch.Tensor:
    """L5, ``pallas_2d_coltiled_rolled`` (kernel_lab.py:744), variants f32 /
    fma / bf16native / bf16fma."""
    _check_variant("lab_2d_coltiled_rolled", variant)
    _check_tiles(Tp, 2, ksteps, (R, C), (kr, kc))
    return _run("lab_2d_coltiled_rolled", variant, Tp, r, ksteps,
                _bounds(Tp, logical, bounds), block, out, plain)
