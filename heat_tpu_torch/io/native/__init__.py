"""ctypes binding to the native IO library, with transparent auto-build.

The CPython/C++ boundary is plain ctypes over an ``extern "C"`` surface,
the same pattern the reference uses for its Fortran/C++ boundary
(``bind(c)`` interface block, fortran/hip/heat.F90:48-102). If
``libfastio.so`` is missing we try one quiet ``make``; on any failure
callers fall back to pure numpy.

The build links under a name of this process's own and renames the result
into place, so the processes of one run (the ranks of a ``launch`` world,
several worlds side by side) may all build at once: each finds either no
library or a whole one, never a file another build is still writing.
Loading a torn file would fail and drop that process to the numpy writer,
whose bytes differ (``%.17g`` against the shortest round trip).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).parent
_SO = _DIR / "libfastio.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(directory: Path) -> bool:
    """Link ``directory/libfastio.so`` with one ``make``, under a name of
    this process and thread, then rename it into place (atomic). True when
    the library is there afterwards, built here or by a concurrent build."""
    so = directory / _SO.name
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["make", "-s", f"OUT={tmp.name}"], cwd=directory, check=True,
            capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return so.exists()
    return True


def _library(directory: Path) -> Optional[ctypes.CDLL]:
    """``directory/libfastio.so`` loaded and typed, built first where it is
    missing; None where it cannot be built or loaded."""
    so = directory / _SO.name
    if not so.exists() and not _build(directory):
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.heat_write_table.restype = ctypes.c_int
        lib.heat_write_table.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
            ctypes.c_long,
        ]
    except OSError:
        return None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    _lib = _library(_DIR)
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
