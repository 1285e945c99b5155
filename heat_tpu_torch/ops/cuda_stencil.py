"""The hand-written Hopper stencil kernel and its plain PyTorch version.

Counterpart of ``heat_tpu.ops.pallas_stencil``'s 2D surface. There, two
Pallas kernels — K1 ``_pallas_2d`` (full-width row bands) and K2
``_pallas_2d_coltiled`` (row x column tiles), picked by a VMEM planner —
compute one function: ``k`` masked FTCS steps per pass on an f32 band,
rounded to the storage dtype once per pass. Here one tiled CUDA kernel,
``csrc/ftcs2d.cu``, computes it for every width.

The per-pass arithmetic, in the Pallas body's order
(pallas_stencil.py:239-249)::

    maskr = where(frozen, 0, f32(r))       frozen: global index <= lo or >= hi
    lap   = ((up + dn) + lf) + rt - 4*band
    band  = fma(maskr, lap, band)          ONE rounding

The single rounding matters: the compiled Pallas update contracts
``band + maskr*lap`` into one fused multiply-add (where the XLA step,
``ops.stencil``, rounds twice). At the shipped sigma=0.25, r is exactly
0.25 and the two agree; at other r they differ in the last bit.

``bounds`` is ``(row_lo, row_hi, col_lo, col_hi)``: cells whose global row
or column index is ``<= lo`` or ``>= hi`` are frozen. For a plain solve that
is the boundary ring ``(0, m-1, 0, n-1)``. Cells that ``bounds`` does not
freeze at the array edge read neighbours from outside it (zeros in the
kernel, wrapped values in the plain version), so a caller with custom
bounds owns a discard margin of at least ``k`` cells on every unfrozen side.

Every wrapper takes a tensor on the card or on the CPU. On a CUDA tensor it
launches the kernel (or raises); on a CPU tensor it runs the plain version,
``ftcs_multistep_2d_plain``, which follows the Pallas body literally and is
what the CPU tests hold against the reference. ``plain=True`` runs the plain
version on any device — the yardstick the kernel is compared with on the
card. f64 has no kernel: like the reference's Pallas wrappers, the edges /
ghost / periodic wrappers then take the plain PyTorch step (``ops.stencil``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .stencil import ftcs_step_edges, ftcs_step_ghost, ftcs_step_periodic

# Steps per kernel launch (the kernel's halo width, csrc/ftcs2d.cu KMAX).
# The default fuse depth is 16, so every default solve keeps the
# reference's pass schedule; f32 bytes do not depend on pass depth at all.
_KMAX = 16

# periodic runs freeze nothing: bounds no cell index can satisfy
_NO_FREEZE = 2**30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the ftcs2d kernel in this process (plain-version passes are
# not counted): a run can show that its main path went through the kernel.
launches = {"ftcs2d": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def kernel_available(shape: Sequence[int], dtype: torch.dtype) -> bool:
    """True where the kernel applies: 2D fields in f32 or bf16. f64 and 3D
    have no kernel (see the module docstring for what f64 does)."""
    return len(tuple(shape)) == 2 and dtype in _KERNEL_DTYPES


def _default_bounds(shape) -> tuple:
    m, n = shape
    return (0, m - 1, 0, n - 1)


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

# rows of f64 temporaries the single-rounding update holds at once
_FMA_ROWS = 2048


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` on f32 tensors with ONE rounding to f32 (an exact fma).

    The product of two f32 values is exact in f64. The f64 sum rounds, so
    its error is recovered exactly (TwoSum) and the sum is rounded to odd
    (stepped one f64 ulp towards the exact value when inexact and even);
    rounding that to f32 is then the correctly rounded result, because f64
    carries at least two more bits than f32. (A plain f64 sum rounded to f32
    rounds twice and differs from an fma in rare cases.) Rows go through
    in blocks so the f64 temporaries stay small at full size."""
    out = torch.empty_like(c)
    for lo in range(0, c.shape[0], _FMA_ROWS):
        sl = slice(lo, lo + _FMA_ROWS)
        p = a[sl].double() * b[sl].double()
        q = c[sl].double()
        s = p + q
        bb = s - p
        err = (p - (s - bb)) + (q - bb)
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, float("inf"), float("-inf")).double()
        s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
        out[sl] = s.float()
    return out


def ftcs_multistep_2d_plain(T: torch.Tensor, r: float, ksteps: int,
                            bounds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``ksteps`` masked FTCS steps in one pass, as the Pallas body computes
    them: neighbours by wrap-rotate (``torch.roll``) of an f32 band, the
    multiply-mask, the single-rounding update, and one rounding back to the
    storage dtype at the end. The kernel's plain PyTorch version."""
    m, n = T.shape
    rlo, rhi, clo, chi = _default_bounds(T.shape) if bounds is None else bounds
    band = T.to(torch.float32)
    rows = torch.arange(m, device=T.device).view(-1, 1)
    cols = torch.arange(n, device=T.device).view(1, -1)
    frozen = (rows <= rlo) | (rows >= rhi) | (cols <= clo) | (cols >= chi)
    maskr = torch.where(frozen, torch.zeros((), device=T.device),
                        torch.tensor(r, dtype=torch.float32, device=T.device))
    del frozen
    for _ in range(ksteps):
        lap = torch.roll(band, 1, 0)              # up: row i-1
        lap += torch.roll(band, -1, 0)            # dn: row i+1
        lap += torch.roll(band, 1, 1)             # lf: col j-1
        lap += torch.roll(band, -1, 1)            # rt: col j+1
        lap -= 4.0 * band
        band = _fma_f32(maskr, lap, band)
        del lap
    return band.to(T.dtype)


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------


def _lib():
    from . import _build

    lib = _build.load("ftcs2d")
    if not getattr(lib, "_heat_typed", False):
        lib.heat_ftcs2d.restype = ctypes.c_int
        lib.heat_ftcs2d.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.heat_cuda_error_string.restype = ctypes.c_char_p
        lib.heat_cuda_error_string.argtypes = [ctypes.c_int]
        lib._heat_typed = True
    return lib


def _launch(T: torch.Tensor, r: float, ksteps: int, bounds,
            out: Optional[torch.Tensor]) -> torch.Tensor:
    """One kernel pass ``T -> out`` on T's device and current stream."""
    if T.dim() != 2 or T.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"ftcs2d takes a 2D float32/bfloat16 tensor, got "
                         f"{T.dim()}D {T.dtype}")
    if not 1 <= ksteps <= _KMAX:
        raise ValueError(f"ftcs2d runs 1..{_KMAX} steps per pass, got {ksteps}")
    T = T.contiguous()
    if out is None:
        out = torch.empty_like(T)
    elif (out.shape != T.shape or out.dtype != T.dtype or out.device != T.device
          or not out.is_contiguous() or out.data_ptr() == T.data_ptr()):
        raise ValueError("out must be a distinct contiguous tensor of T's "
                         "shape, dtype and device")
    lib = _lib()
    m, n = T.shape
    rlo, rhi, clo, chi = (int(b) for b in bounds)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        err = lib.heat_ftcs2d(_KERNEL_DTYPES[T.dtype], T.data_ptr(),
                              out.data_ptr(), m, n, float(r), ksteps,
                              rlo, rhi, clo, chi, stream)
    if err:
        raise RuntimeError(f"ftcs2d launch failed: "
                           f"{lib.heat_cuda_error_string(err).decode()} "
                           f"(shape {tuple(T.shape)}, {T.dtype}, k={ksteps})")
    launches["ftcs2d"] += 1
    return out


def _pass(T: torch.Tensor, r: float, ksteps: int, bounds, out=None,
          plain: bool = False) -> torch.Tensor:
    """One pass of ``ksteps`` <= _KMAX fused steps: the kernel on a CUDA
    tensor, the plain version on a CPU tensor or when asked for."""
    if plain or T.device.type == "cpu":
        res = ftcs_multistep_2d_plain(T, r, ksteps, bounds)
        if out is None:
            return res
        out.copy_(res)
        return out
    if T.device.type != "cuda":
        raise ValueError(f"ftcs2d runs on CUDA or CPU tensors, got {T.device}")
    return _launch(T, r, ksteps, bounds, out)


def _multistep(T: torch.Tensor, r: float, ksteps: int, bounds=None,
               out: Optional[torch.Tensor] = None,
               plain: bool = False) -> torch.Tensor:
    """``ksteps`` fused steps in passes of at most _KMAX (each pass boundary
    is a bf16 rounding point). ``out``, when given, receives the last pass
    — the caller's ping-pong buffer, so a one-pass call allocates nothing."""
    if bounds is None:
        bounds = _default_bounds(T.shape)
    done = 0
    while done < ksteps:
        k = min(_KMAX, ksteps - done)
        done += k
        T = _pass(T, r, k, bounds, out=out if done == ksteps else None,
                  plain=plain)
    return T


def ftcs_multistep_bounded_cuda(T: torch.Tensor, r: float, ksteps: int,
                                bounds: Sequence[int], *,
                                plain: bool = False) -> torch.Tensor:
    """``ksteps`` fused FTCS steps freezing cells at or beyond ``bounds``
    ``(row_lo, row_hi, col_lo, col_hi)``; the caller owns a discard margin
    >= ksteps on every side ``bounds`` leaves unfrozen."""
    if not kernel_available(T.shape, T.dtype):
        raise ValueError(f"no ftcs2d kernel for {tuple(T.shape)} {T.dtype}")
    return _multistep(T, r, ksteps, bounds=tuple(bounds), plain=plain)


def ftcs_multistep_edges_cuda(T: torch.Tensor, r: float, ksteps: int, *,
                              out: Optional[torch.Tensor] = None,
                              plain: bool = False) -> torch.Tensor:
    """``ksteps`` frozen-boundary FTCS steps in fused kernel passes (the
    plain PyTorch step, one at a time, for f64)."""
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
    padded array is exactly k ghost-BC steps."""
    if not kernel_available(T.shape, T.dtype):
        for _ in range(ksteps):
            T = ftcs_step_ghost(T, r, bc_value)
        return T
    value = torch.tensor(bc_value, dtype=T.dtype).item()
    padded = F.pad(T, (1, 1, 1, 1), mode="constant", value=value)
    return _multistep(padded, r, ksteps, plain=plain)[1:-1, 1:-1].contiguous()


def ftcs_step_ghost_cuda(T: torch.Tensor, r: float, bc_value, *,
                         plain: bool = False) -> torch.Tensor:
    return ftcs_multistep_ghost_cuda(T, r, bc_value, 1, plain=plain)


def periodic_pad_width(shape, ksteps: int) -> int:
    """Wrap-ring width per chunk of the periodic multistep: one pass's
    depth, kept within one period of the field."""
    return max(1, min(_KMAX, max(ksteps, 1), min(shape)))


def _wrap_pad(T: torch.Tensor, w: int) -> torch.Tensor:
    """``jnp.pad(T, w, mode="wrap")`` for w <= min(T.shape)."""
    T = torch.cat([T[-w:], T, T[:w]], dim=0)
    return torch.cat([T[:, -w:], T, T[:, :w]], dim=1)


def ftcs_multistep_periodic_cuda(T: torch.Tensor, r: float, ksteps: int, *,
                                 plain: bool = False) -> torch.Tensor:
    """``ksteps`` FTCS steps on the torus: wrap-pad a width-k ring (the
    periodic analog of a halo exchange), run k fused steps with bounds that
    freeze nothing, crop. The wrap ring IS the discard margin the bounded
    contract demands."""
    if ksteps <= 0:
        return T
    if not kernel_available(T.shape, T.dtype):
        for _ in range(ksteps):
            T = ftcs_step_periodic(T, r)
        return T
    cap = periodic_pad_width(T.shape, ksteps)
    bounds = (-_NO_FREEZE, _NO_FREEZE, -_NO_FREEZE, _NO_FREEZE)
    done = 0
    while done < ksteps:
        k = min(cap, ksteps - done)
        out = _multistep(_wrap_pad(T, k), r, k, bounds=bounds, plain=plain)
        T = out[k:-k, k:-k].contiguous()
        done += k
    return T


def ftcs_step_periodic_cuda(T: torch.Tensor, r: float, *,
                            plain: bool = False) -> torch.Tensor:
    return ftcs_multistep_periodic_cuda(T, r, 1, plain=plain)
