"""The streamed lane kernels' launch geometry, their sources' shape, and
where the kernels build.

``cuda_lanes.lanes2d_geometry`` and ``lanes3d_geometry`` mirror the
launches that ``csrc/lanes2d.cu`` and ``csrc/lanes3d.cu`` make
(``chip_smoke.py`` holds them to the kernels' own ``heat_lanes2d_geometry``
and ``heat_lanes3d_geometry`` on the card): here each must cover each
lane's ``m^nd`` exactly once, with every stored cell at least ``k`` from its
region's edge (the cells a k-step wavefront computes right), within the
grid's limits. The source checks pin what the designs rest on: no
``break`` in the streamed step loops (it sends the pipeline's state to local
memory), the lane update kept by a select, never by a multiply-mask, the
3D lane programs' neighbour order, and both lane kernels on the solo
kernels' streamed bodies.
The build directory falls back to the per-user cache where the package's
own directory cannot be written; no nvcc is needed for that.
"""

import inspect
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


def _covers_once_3d(m: int, k: int, L: int, slots: int) -> None:
    g = cl.lanes3d_geometry(L, m, k, slots)
    gx, gy, gz = g.grid
    tiles = gy
    assert gx == tiles * L and gx <= 2**31 - 1 and gy <= 65535
    assert gz <= 65535
    assert g.tile_max == (48 if k <= 4 else 32) and g.tile <= g.tile_max
    # stencil3d_stream.cuh's Stream<k, tile_max, tile_max>: a thread per 4
    # cells of the region, rows padded to 4 cells, whole warps
    side = g.tile_max + 2 * k
    assert g.threads % 32 == 0
    assert g.threads - 32 < side * -(-side // 4) <= g.threads
    # in-plane (mid and col alike): tile j stores [j*tile, (j+1)*tile) of
    # the array from its region [j*tile - k, (j+1)*tile + k)
    cells = np.zeros(m, int)
    for j in range(tiles):
        lo, hi = j * g.tile, min((j + 1) * g.tile, m)
        assert lo < hi, "a tile with nothing to store"
        r0, r1 = j * g.tile - k, (j + 1) * g.tile + k
        assert lo - r0 >= k and r1 - hi >= k
        cells[lo:hi] += 1
    # rows: segment s stores [s*lz, min((s+1)*lz, m)), streaming k rows
    # before and after it
    rows = np.zeros(m, int)
    for s in range(gz):
        lo, hi = s * g.seg_rows, min((s + 1) * g.seg_rows, m)
        assert lo < hi
        rows[lo:hi] += 1
    assert (cells == 1).all() and (rows == 1).all(), (m, k, L, slots)
    assert min(8, m) <= g.seg_rows <= min(1024, m)


@pytest.mark.parametrize("m", [10, 34, 35, 66, 258, 1026])
@pytest.mark.parametrize("k", range(1, 9))
def test_lanes3d_geometry_covers_each_lane_once(k, m):
    for L in (1, 3, 8, 65535):
        for slots in (132, 264):
            _covers_once_3d(m, k, L, slots)


def test_lanes3d_geometry_fills_whole_waves():
    """8 lanes of 258^3 at k = 4 on 132 slots: 6 x 6 tiles of 43 (no last
    tile of 2 cells), 4 segments of 65 rows: 1152 blocks of 800 threads,
    8.7 waves (one 258-row segment would leave 2.2 waves, the third mostly
    idle); at k = 8, 9 x 9 tiles of 29."""
    g = cl.lanes3d_geometry(8, 258, 4, 132)
    assert (g.tile, g.seg_rows, g.threads, g.grid) == (43, 65, 800,
                                                       (48, 6, 4))
    g = cl.lanes3d_geometry(8, 258, 8, 132)
    assert (g.tile, g.threads, g.grid[:2]) == (29, 576, (72, 9))


def test_lanes3d_geometry_refuses_what_no_launch_takes():
    for L, m, k, slots in ((1, 2, 1, 132), (0, 10, 1, 132),
                           (65536, 10, 1, 132), (1, 10, 9, 132),
                           (1, 10, 0, 132), (1, 10, 1, 0), (1, 46342, 1, 132)):
        with pytest.raises(ValueError):
            cl.lanes3d_geometry(L, m, k, slots)


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
    ("stencil3d_stream.cuh", r"void stream3_body\("),
    ("lanes3d.cu", r"struct LaneCells"),
    ("lanes3d.cu", r"lanes3d_stream_kernel\("),
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


def test_lanes3d_update_is_a_select_not_a_multiply_mask():
    """lanes3d's cells as lanes2d's: the update keeps u or the old value bit
    for bit (a bitwise select on an all-ones or all-zeros mask), after u is
    rounded to the storage type, never u * mask or r * mask."""
    cells = _block(_code(_CSRC / "lanes3d.cu"), r"struct LaneCells")
    update = _block(cells, r"float cell\(")
    assert re.search(r"__fmaf_rn\(-6\.0f, cc, s\)", update)
    assert re.search(r"__fmaf_rn\(r, lap, cc\)", update)
    keep = _block(cells, r"void keep\(")
    assert re.search(r"__float_as_uint\(u\[c\]\)\s*&\s*k\)\s*\|\s*"
                     r"\(__float_as_uint\(cc\[c\]\)\s*&\s*~k\)", keep)
    # rounded before the select: the conversions precede it
    assert keep.index("__floats2bfloat162_rn") < keep.index("& ~k")
    assert keep.index("0x7fc00000") < keep.index("& ~k")
    assert "maskr" not in cells
    assert not re.search(r"[*]\s*\(?\s*(lmask|k\b|z\b)", cells)


def test_lanes3d_sums_in_the_lane_programs_order():
    """s = ((((row+1 + mid+1) + col+1) + row-1) + mid-1) + col-1
    (laplacian_interior's order, not the solo kernels' ORDER_L1): the
    lane cell's sum, and the body handing it row-1, centre, row+1 (planes
    q-1, q, q+1), mid-1, mid+1 (the plane buffer one row before and after
    the group), col-1, col+1 in that order."""
    cells = _block(_code(_CSRC / "lanes3d.cu"), r"struct LaneCells")
    head = re.search(r"float cell\(([^)]*)\)", cells)[1]
    params = [p.split()[-1] for p in head.split(",")]
    assert params[2:] == ["up", "cc", "dn", "mm", "mp", "left", "right"]
    update = _block(cells, r"float cell\(")
    terms = re.findall(r"s = (?:s \+ )?(\w+)(?: \+ (\w+))?;", update)
    order = [t for pair in terms for t in pair if t]
    assert order == ["dn", "mp", "right", "up", "mm", "left"]
    body = _block(_code(_CSRC / "stencil3d_stream.cuh"),
                  r"void stream3_body\(")
    call = re.search(r"cells\.cell\(([^;]*)\);", body)[1]
    args = [a.strip() for a in call.split(",")]
    assert args[2:] == ["older[t - 1][c]", "newer[t - 1][c]", "f[c]",
                        "mm[c]", "mp[c]", "left", "right"]
    assert re.search(r"up4 = \*reinterpret_cast<const float4\*>\(pl - RXP\)",
                     body)
    assert re.search(r"dn4 = \*reinterpret_cast<const float4\*>\(pl \+ RXP\)",
                     body)
    assert re.search(r"mm\[4\] = \{up4", body)
    assert re.search(r"mp\[4\] = \{dn4", body)


@pytest.mark.parametrize("source, kernel, cells", [
    ("ftcs3d.cu", "launch_stream<T, ORDER_L1, UPD_LAP", None),
    ("lab3d.cu", "launch_stream<T, ORDER, UPD", None),
    ("lanes3d.cu", "stream3_body<T, K, TM, TM>", "LaneCells<T> cells"),
])
def test_3d_kernels_run_the_one_streamed_body(source, kernel, cells):
    """ftcs3d and lab3d launch the streamed body's solo kernel (SoloCells),
    lanes3d runs the same body with its LaneCells; the one-step design is
    an export beside it, which the lane wrappers never name."""
    code = _code(_CSRC / source)
    assert '#include "stencil3d_stream.cuh"' in code
    assert kernel in code
    if cells:
        assert cells in code
    solo = _block(_code(_CSRC / "stencil3d_stream.cuh"),
                  r"ftcs3d_stream_kernel\(")
    assert "SoloCells<ORDER, UPD> cells" in solo and "stream3_body" in solo
    for fn in (cl.lane_chunk, cl.lane_multistep, cl._launch_passes):
        assert "_step" not in inspect.getsource(fn)


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
