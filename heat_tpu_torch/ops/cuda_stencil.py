"""The hand-written Hopper stencil kernels and their plain PyTorch versions.

Counterpart of ``heat_tpu.ops.pallas_stencil``'s solo surface. There, three
Pallas kernels compute one function per dimension: ``k`` masked FTCS steps
per pass on an f32 band, rounded to the storage dtype once per pass. In 2D
they are K1 ``_pallas_2d`` (full-width row bands) and K2
``_pallas_2d_coltiled`` (row x column tiles), picked by a VMEM planner;
here one tiled CUDA kernel, ``csrc/ftcs2d.cu``, computes it for every
width. In 3D it is K3 ``_pallas_3d_aligned`` ((row, mid) tiles, lane axis
whole); here ``csrc/ftcs3d.cu``.

The per-pass arithmetic, in the Pallas bodies' order::

    maskr = where(frozen, 0, f32(r))      frozen: global index <= lo or >= hi
    2D (pallas_stencil.py:239-249):
      lap  = ((up + dn) + lf) + rt - 4*band
      band = fma(maskr, lap, band)        ONE rounding
    3D (pallas_stencil.py:470-479):
      s    = ((((row+1 + row-1) + mid+1) + mid-1) + col-1) + col+1
      lap  = fma(-6, band, s)             ONE rounding
      band = fma(maskr, lap, band)        ONE rounding

The single roundings matter: the compiled Pallas bodies contract
``band + maskr*lap`` into one fused multiply-add (where the XLA step,
``ops.stencil``, rounds twice), and in 3D also ``s - 6*band``. At the
shipped 2D sigma=0.25, r is exactly 0.25 and 4*band is exact, so any order
agrees there; in 3D (r = 1/6 or 0.15, and 6*band inexact) every other form
differs in the last bit.

How ``k`` steps are cut into passes is ``pass_schedule``: the reference's
own planners, so that bf16, which rounds at each pass boundary, rounds
where the reference rounds.

``bounds`` is ``(lo, hi)`` per axis, flattened: cells whose global index
on any axis is ``<= lo`` or ``>= hi`` are frozen. For a plain solve that is
the boundary ring ``(0, m-1, 0, n-1)`` (3D: six values). Cells that
``bounds`` does not freeze at the array edge read neighbours from outside
it (zeros in the kernels, wrapped values in the plain versions), so a
caller with custom bounds owns a discard margin of at least ``k`` cells on
every unfrozen side.

Every wrapper takes a tensor on the card or on the CPU. On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs the plain version,
``ftcs_multistep_{2d,3d}_plain``, which follows the Pallas body literally
and is what the CPU tests hold against the reference. ``plain=True`` runs
the plain version on any device: the yardstick the kernel is compared with
on the card. f64, and 3D shapes where the reference's planner finds no
plan, have no kernel: like the reference's Pallas wrappers, the edges /
ghost / periodic wrappers then take the plain PyTorch step
(``ops.stencil``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import pass_schedule
from .stencil import ftcs_step_edges, ftcs_step_ghost, ftcs_step_periodic

# steps per kernel launch, at most (csrc/ftcs2d.cu KMAX, csrc/ftcs3d.cu KMAX)
_KMAX_2D = pass_schedule.KMAX_2D
_KMAX_3D = pass_schedule.KMAX_3D

# periodic runs freeze nothing: bounds no cell index can satisfy
_NO_FREEZE = 2**30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {2: "ftcs2d", 3: "ftcs3d"}

# Launches of each kernel in this process (plain-version passes are not
# counted): a run can show that its main path went through the kernel.
launches = {"ftcs2d": 0, "ftcs3d": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def kernel_available(shape: Sequence[int], dtype: torch.dtype) -> bool:
    """True where a kernel applies: f32/bf16 fields in 2D, and in 3D where
    the reference's planner has a plan (``pallas_available``). f64 has no
    kernel (see the module docstring for what it does instead)."""
    shape = tuple(shape)
    if dtype not in _KERNEL_DTYPES or len(shape) not in _KERNELS:
        return False
    return (len(shape) == 2
            or pass_schedule.passes(shape, dtype, _KMAX_3D) is not None)


def _default_bounds(shape) -> tuple:
    return tuple(v for s in shape for v in (0, s - 1))


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------

# elements per block of the single-rounding update's f64 temporaries
_FMA_BLOCK = 1 << 24


def _fma_f32(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` on f32 tensors with ONE rounding to f32 (an exact fma).
    ``a`` is a tensor of ``c``'s shape or a float that f32 holds exactly.

    The product of two f32 values is exact in f64. The f64 sum rounds, so
    its error is recovered exactly (TwoSum) and the sum is rounded to odd
    (stepped one f64 ulp towards the exact value when inexact and even);
    rounding that to f32 is then the correctly rounded result, because f64
    carries at least two more bits than f32. (A plain f64 sum rounded to f32
    rounds twice and differs from an fma in rare cases.) The elements go
    through in blocks so the f64 temporaries stay small at full size."""
    out = torch.empty_like(c)
    flat_out, flat_b, flat_c = out.view(-1), b.reshape(-1), c.reshape(-1)
    flat_a = a.reshape(-1) if isinstance(a, torch.Tensor) else None
    for lo in range(0, flat_c.numel(), _FMA_BLOCK):
        sl = slice(lo, lo + _FMA_BLOCK)
        p = flat_b[sl].double() * (a if flat_a is None else flat_a[sl].double())
        q = flat_c[sl].double()
        s = p + q
        bb = s - p
        err = (p - (s - bb)) + (q - bb)
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, float("inf"), float("-inf")).double()
        s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
        flat_out[sl] = s.float()
    return out


def _maskr(shape, bounds, r: float, device) -> torch.Tensor:
    """f32 ``r`` where a cell updates, 0 where ``bounds`` freezes it."""
    nd = len(shape)
    frozen = None
    for d, size in enumerate(shape):
        idx = torch.arange(size, device=device)
        axis = (idx <= bounds[2 * d]) | (idx >= bounds[2 * d + 1])
        axis = axis.view([-1 if e == d else 1 for e in range(nd)])
        frozen = axis if frozen is None else frozen | axis
    return torch.where(frozen, torch.zeros((), device=device),
                       torch.full((), r, dtype=torch.float32, device=device))


def ftcs_multistep_2d_plain(T: torch.Tensor, r: float, ksteps: int,
                            bounds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``ksteps`` masked FTCS steps in one pass, as the 2D Pallas bodies
    compute them: neighbours by wrap-rotate (``torch.roll``) of an f32 band,
    the multiply-mask, the single-rounding update, and one rounding back to
    the storage dtype at the end. ``ftcs2d``'s plain PyTorch version."""
    bounds = _default_bounds(T.shape) if bounds is None else bounds
    band = T.to(torch.float32)
    maskr = _maskr(T.shape, bounds, r, T.device)
    for _ in range(ksteps):
        lap = torch.roll(band, 1, 0)              # up: row i-1
        lap += torch.roll(band, -1, 0)            # dn: row i+1
        lap += torch.roll(band, 1, 1)             # lf: col j-1
        lap += torch.roll(band, -1, 1)            # rt: col j+1
        lap -= 4.0 * band
        band = _fma_f32(maskr, lap, band)
        del lap
    return band.to(T.dtype)


def ftcs_multistep_3d_plain(T: torch.Tensor, r: float, ksteps: int,
                            bounds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``ksteps`` masked 7-point FTCS steps in one pass, as K3's body
    (``_make_kernel_3d``) computes them: the six neighbours of an f32 band
    summed in the body's order, ``lap = fma(-6, band, s)`` and
    ``band = fma(maskr, lap, band)``, each rounded once, and one rounding
    back to the storage dtype at the end. ``ftcs3d``'s plain PyTorch
    version."""
    bounds = _default_bounds(T.shape) if bounds is None else bounds
    band = T.to(torch.float32)
    maskr = _maskr(T.shape, bounds, r, T.device)
    for _ in range(ksteps):
        s = torch.roll(band, -1, 0)               # row+1
        s += torch.roll(band, 1, 0)               # row-1
        s += torch.roll(band, -1, 1)              # mid+1
        s += torch.roll(band, 1, 1)               # mid-1
        s += torch.roll(band, 1, 2)               # col-1
        s += torch.roll(band, -1, 2)              # col+1
        lap = _fma_f32(-6.0, band, s)
        del s
        band = _fma_f32(maskr, lap, band)
        del lap
    return band.to(T.dtype)


_PLAIN = {2: ftcs_multistep_2d_plain, 3: ftcs_multistep_3d_plain}


# --------------------------------------------------------------------------
# the kernels' wrapper
# --------------------------------------------------------------------------


def _kernel_fn(name: str):
    """``heat_<name>`` from the built library, with its C signature."""
    from . import _build

    lib = _build.load(name)
    if not getattr(lib, "_heat_typed", False):
        nd = 2 if name == "ftcs2d" else 3
        fn = getattr(lib, f"heat_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int64] * nd + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_int] * (2 * nd) + [ctypes.c_void_p])
        lib.heat_cuda_error_string.restype = ctypes.c_char_p
        lib.heat_cuda_error_string.argtypes = [ctypes.c_int]
        lib._heat_typed = True
    return lib, getattr(lib, f"heat_{name}")


def _launch(T: torch.Tensor, r: float, ksteps: int, bounds,
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """One kernel pass ``T -> out`` on T's device and current stream."""
    nd = T.dim()
    if nd not in _KERNELS or T.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the stencil kernels take a 2D or 3D float32/"
                         f"bfloat16 tensor, got {nd}D {T.dtype}")
    name = _KERNELS[nd]
    kmax = _KMAX_2D if nd == 2 else _KMAX_3D
    if not 1 <= ksteps <= kmax:
        raise ValueError(f"{name} runs 1..{kmax} steps per pass, got {ksteps}")
    bounds = tuple(int(b) for b in bounds)
    if len(bounds) != 2 * nd:
        raise ValueError(f"{name} takes {2 * nd} bounds, got {len(bounds)}")
    T = T.contiguous()
    if out is None:
        out = torch.empty_like(T)
    elif (out.shape != T.shape or out.dtype != T.dtype or out.device != T.device
          or not out.is_contiguous() or out.data_ptr() == T.data_ptr()):
        raise ValueError("out must be a distinct contiguous tensor of T's "
                         "shape, dtype and device")
    lib, fn = _kernel_fn(name)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = fn(_KERNEL_DTYPES[T.dtype], T.data_ptr(), out.data_ptr(),
                 *T.shape, float(r), ksteps, *bounds, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.heat_cuda_error_string(err).decode()} "
                           f"(shape {tuple(T.shape)}, {T.dtype}, k={ksteps})")
    launches[name] += 1
    return out


def _pass(T: torch.Tensor, r: float, ksteps: int, bounds, out=None,
          plain: bool = False) -> torch.Tensor:
    """One pass of ``ksteps`` fused steps: the kernel on a CUDA tensor, the
    plain version on a CPU tensor or when asked for."""
    if plain or T.device.type == "cpu":
        res = _PLAIN[T.dim()](T, r, ksteps, bounds)
        if out is None:
            return res
        out.copy_(res)
        return out
    if T.device.type != "cuda":
        raise ValueError(f"the stencil kernels run on CUDA or CPU tensors, "
                         f"got {T.device}")
    return _launch(T, r, ksteps, bounds, out)


def _multistep(T: torch.Tensor, r: float, ksteps: int, bounds=None,
               out: Optional[torch.Tensor] = None,
               plain: bool = False, plan_shape=None) -> torch.Tensor:
    """``ksteps`` fused steps in the reference's passes (``pass_schedule``
    at ``plan_shape``, by default T's; each pass boundary is a bf16
    rounding point). ``out``, when given, receives the last pass — the
    caller's ping-pong buffer, so a one-pass call allocates nothing."""
    if bounds is None:
        bounds = _default_bounds(T.shape)
    plan_shape = tuple(T.shape if plan_shape is None else plan_shape)
    schedule = pass_schedule.passes(plan_shape, T.dtype, ksteps)
    if schedule is None:
        raise ValueError(f"no kernel plan for {plan_shape} {T.dtype} "
                         f"(gate on kernel_available)")
    for i, k in enumerate(schedule):
        T = _pass(T, r, k, bounds, plain=plain,
                  out=out if i == len(schedule) - 1 else None)
    return T


def ftcs_multistep_bounded_cuda(T: torch.Tensor, r: float, ksteps: int,
                                bounds: Sequence[int], *,
                                out: Optional[torch.Tensor] = None,
                                plan_shape: Optional[Sequence[int]] = None,
                                plain: bool = False) -> torch.Tensor:
    """``ksteps`` fused FTCS steps freezing cells at or beyond ``bounds``
    (``lo, hi`` per axis); the caller owns a discard margin >= ksteps on
    every side ``bounds`` leaves unfrozen. ``out`` receives the last
    pass; ``plan_shape`` names the shape whose pass schedule the steps are
    cut into (by default T's): a caller that steps a block inside a
    larger array, and keeps only cells whose steps never reach past the
    block, rounds where a call on the block alone would."""
    plan_shape = tuple(T.shape if plan_shape is None else plan_shape)
    if not kernel_available(plan_shape, T.dtype):
        raise ValueError(f"no stencil kernel for {plan_shape} {T.dtype}")
    if len(bounds) != 2 * T.dim():
        raise ValueError(f"{T.dim()}D bounds are {2 * T.dim()} values, "
                         f"got {len(bounds)}")
    return _multistep(T, r, ksteps, bounds=tuple(int(b) for b in bounds),
                      out=out, plain=plain, plan_shape=plan_shape)


def ftcs_multistep_edges_cuda(T: torch.Tensor, r: float, ksteps: int, *,
                              out: Optional[torch.Tensor] = None,
                              plain: bool = False) -> torch.Tensor:
    """``ksteps`` frozen-boundary FTCS steps in fused kernel passes (the
    plain PyTorch step, one at a time, where no kernel applies)."""
    if kernel_available(T.shape, T.dtype):
        return _multistep(T, r, ksteps, out=out, plain=plain)
    for _ in range(ksteps):
        T = ftcs_step_edges(T, r)
    return T


def ftcs_step_edges_cuda(T: torch.Tensor, r: float, *,
                         out: Optional[torch.Tensor] = None,
                         plain: bool = False) -> torch.Tensor:
    """One frozen-boundary FTCS step: a one-step kernel pass."""
    return ftcs_multistep_edges_cuda(T, r, 1, out=out, plain=plain)


def ftcs_multistep_ghost_cuda(T: torch.Tensor, r: float, bc_value,
                              ksteps: int, *, plain: bool = False) -> torch.Tensor:
    """``ksteps`` ghost-BC steps fused: the bc-padded array's frozen outer
    ring IS the ghost ring, which never changes — so the edges kernel on the
    padded array is exactly k ghost-BC steps. The passes are planned on the
    padded shape, as the reference plans them."""
    nd = T.dim()
    padded_shape = tuple(s + 2 for s in T.shape)
    if not (kernel_available(T.shape, T.dtype)
            and kernel_available(padded_shape, T.dtype)):
        for _ in range(ksteps):
            T = ftcs_step_ghost(T, r, bc_value)
        return T
    value = torch.tensor(bc_value, dtype=T.dtype).item()
    padded = F.pad(T, (1, 1) * nd, mode="constant", value=value)
    out = _multistep(padded, r, ksteps, plain=plain)
    return out[(slice(1, -1),) * nd].contiguous()


def ftcs_step_ghost_cuda(T: torch.Tensor, r: float, bc_value, *,
                         plain: bool = False) -> torch.Tensor:
    return ftcs_multistep_ghost_cuda(T, r, bc_value, 1, plain=plain)


def periodic_pad_width(shape, ksteps: int) -> int:
    """Wrap-ring width per chunk of the periodic multistep: up to 32 steps
    in 2D and 16 in 3D (the reference's caps; 3D cuts the chunk into
    passes further), kept within one period of the field."""
    cap = _KMAX_2D if len(shape) == 2 else 16
    return max(1, min(cap, max(ksteps, 1), min(shape)))


def _wrap_pad(T: torch.Tensor, w: int) -> torch.Tensor:
    """``jnp.pad(T, w, mode="wrap")`` for w <= min(T.shape)."""
    for d in range(T.dim()):
        size = T.shape[d]
        T = torch.cat([T.narrow(d, size - w, w), T, T.narrow(d, 0, w)], dim=d)
    return T


def ftcs_multistep_periodic_cuda(T: torch.Tensor, r: float, ksteps: int, *,
                                 plain: bool = False) -> torch.Tensor:
    """``ksteps`` FTCS steps on the torus: wrap-pad a width-k ring (the
    periodic analog of a halo exchange), run k fused steps with bounds that
    freeze nothing, crop. The wrap ring IS the discard margin the bounded
    contract demands. As in the reference, every padded shape the chunk
    loop builds must have a kernel, else the plain step runs."""
    if ksteps <= 0:
        return T
    nd = T.dim()
    cap = periodic_pad_width(T.shape, ksteps)
    widths = {min(cap, ksteps), ksteps % cap or cap}
    if not all(kernel_available(tuple(s + 2 * w for s in T.shape), T.dtype)
               for w in widths):
        for _ in range(ksteps):
            T = ftcs_step_periodic(T, r)
        return T
    bounds = (-_NO_FREEZE, _NO_FREEZE) * nd
    done = 0
    while done < ksteps:
        k = min(cap, ksteps - done)
        out = _multistep(_wrap_pad(T, k), r, k, bounds=bounds, plain=plain)
        T = out[(slice(k, -k),) * nd].contiguous()
        done += k
    return T


def ftcs_step_periodic_cuda(T: torch.Tensor, r: float, *,
                            plain: bool = False) -> torch.Tensor:
    return ftcs_multistep_periodic_cuda(T, r, 1, plain=plain)
