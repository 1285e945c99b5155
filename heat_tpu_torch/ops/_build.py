"""Build and load the hand-written CUDA kernels.

The sources under ``ops/csrc`` have a plain C interface; ``nvcc`` compiles
them straight into a shared library for ``sm_90a``, which ``ctypes`` loads.
(Including PyTorch's headers, as ``torch.utils.cpp_extension.load`` does,
makes one file take minutes to compile; this takes seconds.) The library
lands in ``heat_tpu_torch/_build/`` (in a checkout; where the package's
directory cannot be written, as in an installed, read-only package, in the
per-user cache ``$XDG_CACHE_HOME/heat_tpu_torch``, by default
``~/.cache/heat_tpu_torch``), named by a hash of the source, the headers
beside it (``csrc/*.cuh``) and the flags, so a changed source, header or
flag set builds anew and an unchanged one is reused by every later process
of the same checkout.

Nothing here runs at import: the first CUDA launch builds, so the package
imports on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).parent / "csrc"
# the kernels, by source name: csrc/<name>.cu exports heat_<name>()
KERNELS = ("ftcs2d", "ftcs3d", "lanes2d", "lanes3d", "lab2d", "lab3d")
# the build directory in a checkout (.gitignore lists it)
PACKAGE_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# -fmad=false: no contraction of a*b+c anywhere the source does not ask for
# one with __fmaf_rn (the kernel's bytes depend on it); no --use_fast_math
# (it flushes subnormals). -Xptxas=-v puts registers/spills in the log.
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# plain, not a ranked debug.make_lock: it guards the libraries' build and
# load, a leaf (no lock is taken under it) with no counterpart in the
# reference's lock order
_lock = threading.Lock()
_libs: dict = {}


def _writable(d: Path) -> bool:
    """Whether ``d`` exists or can be made, and takes a new file."""
    try:
        d.mkdir(parents=True, exist_ok=True)
        probe = d / f".probe.{os.getpid()}.{threading.get_ident()}"
        probe.touch()
        probe.unlink()
    except OSError:
        return False
    return True


def build_dir() -> Path:
    """Where the libraries go: ``heat_tpu_torch/_build/`` where the package's
    directory can be written, else the per-user cache
    (``$XDG_CACHE_HOME/heat_tpu_torch``, by default
    ``~/.cache/heat_tpu_torch``)."""
    if _writable(PACKAGE_BUILD_DIR):
        return PACKAGE_BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "heat_tpu_torch"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (once per source+flags hash) and return the
    library's path. Raises with nvcc's output when the build fails."""
    src = _CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(_CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    out = build_dir()
    so = out / f"lib{name}-{key.hexdigest()[:16]}.so"
    if so.exists():
        return so
    out.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out / f"{name}.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src.name} "
                           f"(rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never loads a torn file
    # the compile observatory's tap: each build this process ran (a
    # library found already built costs nothing and is not noted)
    from ..runtime import prof

    prof.compile_log().note(f"nvcc {name}", 0, seconds)
    return so


def build_all(names=KERNELS) -> dict:
    """Build the libraries of ``names`` (default every kernel) at once, one
    ``nvcc`` each, all started together; returns {name: seconds its build
    took} (about 0 for a library already built)."""
    def timed(name: str) -> float:
        t = time.perf_counter()
        build(name)
        return time.perf_counter() - t

    names = tuple(names)
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def build_log(name: str) -> str:
    """nvcc's command line and output (ptxas register/spill report) from the
    last build of ``name`` in this checkout, or "" if none."""
    p = build_dir() / f"{name}.log"
    return p.read_text() if p.exists() else ""


def ptxas_report(log: str) -> list:
    """(function, registers, spill store bytes, spill load bytes) of each
    kernel instance in a ``build_log`` (``-Xptxas=-v``)."""
    out, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            fn, spill = m[1], (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m[1]), int(m[2]))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            out.append((fn, int(m[1]), *spill))
            fn = None
    return out
