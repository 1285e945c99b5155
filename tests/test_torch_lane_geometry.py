"""The streamed ``lanes2d`` kernel's launch geometry, its source's shape,
and where the kernels build.

``cuda_lanes.lanes2d_geometry`` mirrors the launch that
``csrc/lanes2d.cu`` makes (``chip_smoke.py`` holds it to the kernel's own
``heat_lanes2d_geometry`` on the card): here it must cover each lane's
``m x m`` exactly once, with every output column at least ``k`` from its
region's edge (the cells a k-step wavefront computes right), within the
grid's limits. The source checks pin what the design rests on: no
``break`` in the streamed step loop (it sends the pipeline's state to local
memory), and the lane update kept by a select, never by a multiply-mask.
The build directory falls back to the per-user cache where the package's
own directory cannot be written; no nvcc is needed for that.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from heat_tpu_torch.ops import cuda_lanes as cl

_CSRC = Path(__file__).resolve().parent.parent / "heat_tpu_torch" / "ops" / "csrc"
_OPS = _CSRC.parent


def _covers_once(m: int, k: int, L: int, slots: int) -> None:
    g = cl.lanes2d_geometry(L, m, k, slots)
    gx, gy, gz = g.grid
    assert gz == L
    assert g.region == 128 and g.out_cols == g.region - 2 * k
    assert g.block_cols == 4 * g.out_cols
    assert 8 <= g.seg_rows <= 256 and gy <= 65535
    # columns: warp w of column block bx writes [c0, c0 + out_cols) of its
    # region [c0 - k, c0 - k + region); a warp whose c0 >= m returns
    cols = np.zeros(m, int)
    for bx in range(gx):
        for w in range(4):
            c0 = (bx * 4 + w) * g.out_cols
            if c0 >= m:
                continue
            lo, hi = c0, min(c0 + g.out_cols, m)
            assert lo - (c0 - k) >= k and (c0 - k + g.region - 1) - (hi - 1) >= k
            cols[lo:hi] += 1
        # every column block has a warp with work
        assert bx * g.block_cols < m
    rows = np.zeros(m, int)
    for y in range(gy):
        lo, hi = y * g.seg_rows, min((y + 1) * g.seg_rows, m)
        assert lo < hi
        rows[lo:hi] += 1
    assert (cols == 1).all() and (rows == 1).all(), (m, k, L, slots)


@pytest.mark.parametrize("slots", [132, 264])
@pytest.mark.parametrize("k", range(1, 17))
def test_lanes2d_geometry_covers_each_lane_once(k, slots):
    for m in range(3, 301):
        for L in range(1, 9):
            _covers_once(m, k, L, slots)


def test_lanes2d_geometry_fills_whole_waves():
    """8 lanes of 1026^2 at k = 16 on 264 slots: 3 column blocks a lane,
    segments of 94 rows, 11 segments: 264 blocks, one wave."""
    g = cl.lanes2d_geometry(8, 1026, 16, 264)
    assert (g.out_cols, g.block_cols, g.seg_rows, g.grid) == (
        96, 384, 94, (3, 11, 8))


@pytest.mark.parametrize("m", [65535 * 16, 4 * 10**6, 65535 * 256])
def test_lanes2d_segments_stay_within_the_grid(m):
    for k in (1, 16):
        g = cl.lanes2d_geometry(1, m, k, 264)
        assert g.grid[1] <= 65535 and g.grid[1] * g.seg_rows >= m


def test_lanes2d_geometry_refuses_what_no_launch_takes():
    with pytest.raises(ValueError, match="65535"):
        cl.lanes2d_geometry(1, 65535 * 256 + 1, 16, 264)
    for L, m, k, slots in ((1, 2, 1, 264), (0, 14, 1, 264), (1, 14, 17, 264),
                           (1, 14, 0, 264), (1, 14, 1, 0)):
        with pytest.raises(ValueError):
            cl.lanes2d_geometry(L, m, k, slots)


def _code(path: Path) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _block(code: str, head: str) -> str:
    """The brace-delimited body that follows the first match of ``head``."""
    start = code.index("{", re.search(head, code).end())
    depth = 0
    for i in range(start, len(code)):
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        if depth == 0:
            return code[start:i + 1]
    raise AssertionError(f"unbalanced braces after {head!r}")


@pytest.mark.parametrize("path, head", [
    ("stencil2d_stream.cuh", r"void stream2_body\("),
    ("lanes2d.cu", r"struct LaneCells"),
    ("lanes2d.cu", r"lanes2d_stream_kernel\("),
])
def test_streamed_step_loop_has_no_break(path, head):
    body = _block(_code(_CSRC / path), head)
    assert not re.search(r"\bbreak\b", body)


def test_lane_update_is_a_select_not_a_multiply_mask():
    """The update keeps u or the old value bit for bit (a bitwise select on
    an all-ones or all-zeros mask), never u * mask or r * mask."""
    cells = _block(_code(_CSRC / "lanes2d.cu"), r"struct LaneCells")
    update = _block(cells, r"float cell\(")
    assert re.search(r"__fmaf_rn\(r, lap, cc\)", update)
    keep = _block(cells, r"void keep\(")
    assert re.search(r"__float_as_uint\(u\[c\]\)\s*&\s*k\)\s*\|\s*"
                     r"\(__float_as_uint\(cc\[c\]\)\s*&\s*~k\)", keep)
    assert "maskr" not in cells
    assert not re.search(r"[*]\s*\(?\s*(live|lmask|k\b|z_keep)", cells)


def _build_dir_in(pkg_root: Path, env: dict, unprivileged: bool) -> str:
    """``_build.build_dir()`` of a copy of ``ops/_build.py`` placed under
    ``pkg_root/heat_tpu_torch/ops``, in a child process (as an unprivileged
    user where this one is root, which mode bits do not stop)."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('b', sys.argv[1])\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "print(mod.build_dir())\n")
    target = pkg_root / "heat_tpu_torch" / "ops" / "_build.py"

    def drop():
        os.setgid(65534)
        os.setuid(65534)

    proc = subprocess.run([sys.executable, "-c", code, str(target)],
                          capture_output=True, text=True, env=env,
                          preexec_fn=drop if unprivileged else None,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_build_dir_falls_back_to_the_user_cache_when_read_only():
    root = Path(tempfile.mkdtemp(prefix="heat_build_dir_"))
    try:
        pkg = root / "site" / "heat_tpu_torch"
        (pkg / "ops").mkdir(parents=True)
        shutil.copy(_OPS / "_build.py", pkg / "ops" / "_build.py")
        cache, home = root / "cache", root / "home"
        cache.mkdir()
        home.mkdir()
        for d in (root, root / "site", pkg, pkg / "ops", cache, home):
            d.chmod(0o777)
        (pkg / "ops" / "_build.py").chmod(0o644)
        unpriv = os.geteuid() == 0
        base = {"PATH": os.environ.get("PATH", ""), "HOME": str(home)}
        # a checkout: the package directory takes the build
        assert _build_dir_in(root / "site", base, unpriv) == str(pkg / "_build")
        # an installed, read-only package: the per-user cache
        shutil.rmtree(pkg / "_build")
        for d in (pkg, pkg / "ops"):
            d.chmod(0o555)
        got = _build_dir_in(root / "site", dict(base, XDG_CACHE_HOME=str(cache)),
                            unpriv)
        assert got == str(cache / "heat_tpu_torch")
        got = _build_dir_in(root / "site", base, unpriv)
        assert got == str(home / ".cache" / "heat_tpu_torch")
        assert not (pkg / "_build").exists()
    finally:
        for d in root.rglob("*"):
            if d.is_dir():
                d.chmod(0o777)
        shutil.rmtree(root, ignore_errors=True)
