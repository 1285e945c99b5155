"""ctypes binding to the native IO library, with transparent auto-build.

The CPython/C++ boundary is plain ctypes over an ``extern "C"`` surface,
the same pattern the reference uses for its Fortran/C++ boundary
(``bind(c)`` interface block, fortran/hip/heat.F90:48-102). If
``libfastio.so`` is missing we try one quiet ``make``; on any failure
callers fall back to pure numpy.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).parent
_SO = _DIR / "libfastio.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SO.exists():
        try:
            subprocess.run(
                ["make", "-s"], cwd=_DIR, check=True,
                capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
        lib.heat_write_table.restype = ctypes.c_int
        lib.heat_write_table.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
            ctypes.c_long,
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def fast_write_triplets(path: str, table: np.ndarray) -> bool:
    """Write an (N, k) float64 table as text lines. True iff native path ran."""
    lib = _load()
    if lib is None:
        return False
    table = np.ascontiguousarray(table, dtype=np.float64)
    rc = lib.heat_write_table(path.encode(), table, table.shape[0], table.shape[1])
    return rc == 0
