"""heat_tpu_torch.ops.cuda_lanes against heat_tpu's lane programs.

On the CPU the lane wrappers run their kernels' plain PyTorch version
(``lane_multistep_{2d,3d}_plain``). The reference runs as its own tests run
it: the jitted XLA lane program (``serve/engine.make_lane_advance(kernel=
"xla")``, the serving oracle) and the multi-lane Pallas kernels K4/K5
(``pallas_stencil.lane_multistep``) in interpret mode. Same inputs (numpy,
seeded). Fields and finite bits compare as bytes (a NaN cell as NaN: the
NaN lane's payload bits are not part of either contract); resid, tmin and
tmax exactly on finite lanes; heat, a float32 sum in another order, within
a relative 1e-5. The case grid is chip_smoke.py's phase 2 at small
buckets: per lane r, one lane with n < B, one whose countdown ends inside
the chunk, one with none left, one with a NaN in its centre; chunks of
k in {1, 5, 16, 37} so that some take several kernel passes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat_tpu.ops import pallas_stencil as ps
from heat_tpu.serve import engine as je
from heat_tpu_torch.ops import cuda_lanes as cl
from heat_tpu_torch.ops.cuda_stencil import _fma_f32

# One intra-op thread: the suite runs several pytest workers at once.
torch.set_num_threads(1)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_R = {2: [0.25, 0.2, 0.1], 3: [1 / 6, 0.15, 0.1]}
_BC_LO = {"ghost": 0, "edges": 1}
_L = 4


def _case(nd, B, k, seed=0):
    """(fields f32, r, n, rem) numpy inputs of one grid case."""
    m = B + 2
    f = np.random.default_rng(seed).uniform(1, 2, (_L,) + (m,) * nd)
    f = f.astype(np.float32)
    f[(3,) + (1 + B // 2,) * nd] = np.nan
    n = np.array([B - 3, B, B, B], np.int32)
    rem = np.array([k + 3, k // 2 if k > 1 else 0, 0, k + 1], np.int32)
    r = np.array(_R[nd] + _R[nd][:1], np.float32)
    return f, r, n, rem


def _port(f, r, n, rem, dtype, k, bc):
    out, fin, stats = cl.lane_multistep(
        torch.from_numpy(f).to(_TORCH[dtype]), torch.from_numpy(r),
        torch.from_numpy(n), torch.from_numpy(rem), k, _BC_LO[bc])
    return out.float().numpy(), fin.numpy(), stats.numpy()


def _nan_bits(a: np.ndarray) -> np.ndarray:
    a = np.where(np.isnan(a), np.float32(np.nan), a).astype(np.float32)
    return a.view(np.uint32)


def _assert_same(got, want_fields, want_fin, want_stats):
    fields, fin, stats = got
    assert fields.shape == want_fields.shape
    ndiff = int((_nan_bits(fields) != _nan_bits(want_fields)).sum())
    assert ndiff == 0, f"{ndiff} of {fields.size} cells differ"
    np.testing.assert_array_equal(fin, np.asarray(want_fin, bool))
    ok = np.asarray(want_fin, bool)
    np.testing.assert_array_equal(stats[:3, ok], want_stats[:3, ok])
    np.testing.assert_allclose(stats[3, ok], want_stats[3, ok], rtol=1e-5)


_GRID = [(nd, B, dtype, bc, k)
         for nd, buckets in ((2, (12, 16)), (3, (8, 33)))
         for B in buckets
         for dtype in ("float32", "bfloat16")
         for bc in ("edges", "ghost")
         for k in (1, 5, 16, 37)]


@pytest.mark.parametrize("nd,B,dtype,bc,k", _GRID)
def test_plain_matches_xla_lane_program(nd, B, dtype, bc, k):
    f, r, n, rem = _case(nd, B, k, seed=B + k)
    adv = je.make_lane_advance(je.BucketKey(nd, B, dtype, bc), kernel="xla",
                               donate=False)
    out = adv(jnp.asarray(f).astype(_JNP[dtype]), jnp.asarray(r),
              jnp.asarray(n), jnp.asarray(rem), k)
    b = np.asarray(out[4])
    np.testing.assert_array_equal(np.asarray(out[3]), np.maximum(rem - k, 0))
    _assert_same(_port(f, r, n, rem, dtype, k, bc),
                 np.asarray(out[0].astype(jnp.float32)), b[1],
                 je.unpack_boundary(b))


# interpret-mode K4/K5 compile once per (shape, depth, offset): the 2D grid at
# one bucket, 3D at the depths that stay within a few seconds
_PALLAS = ([(2, 12, dtype, bc, k) for dtype in ("float32", "bfloat16")
            for bc in ("edges", "ghost") for k in (1, 5, 16, 37)]
           + [(3, 8, dtype, bc, k) for dtype in ("float32", "bfloat16")
              for bc in ("edges", "ghost") for k in (1, 5)])


@pytest.mark.parametrize("nd,B,dtype,bc,k", _PALLAS)
def test_plain_matches_pallas_lane_kernels(nd, B, dtype, bc, k):
    f, r, n, rem = _case(nd, B, k, seed=B + k)
    m = B + 2
    slab = np.zeros((_L,) + ps.lane_state_shape(nd, B, dtype), np.float32)
    corner = (slice(None),) + (slice(0, m),) * nd
    slab[corner] = f
    out, fin, stats = ps.lane_multistep(
        jnp.asarray(slab).astype(_JNP[dtype]), jnp.asarray(r),
        jnp.asarray(n), jnp.asarray(rem), k, _BC_LO[bc], B)
    _assert_same(_port(f, r, n, rem, dtype, k, bc),
                 np.asarray(out.astype(jnp.float32))[corner], np.asarray(fin),
                 np.asarray(stats))


def _form_step(T, r, nd, form):
    """One unmasked lane step of a (1,)+(m,)*nd f32 stack on its interior,
    in one of several arithmetic forms."""
    ctr = (slice(None),) + (slice(1, -1),) * nd

    def nb(d, off):
        sl = list(ctr)
        sl[d + 1] = slice(2, None) if off > 0 else slice(0, -2)
        return T[tuple(sl)]

    c = T[ctr]
    if form.startswith("k-order"):
        # the solo kernels' neighbour order (ftcs2d.cu / ftcs3d.cu)
        order = ([(0, -1), (0, 1), (1, -1), (1, 1)] if nd == 2 else
                 [(0, 1), (0, -1), (1, 1), (1, -1), (2, -1), (2, 1)])
    else:
        order = [(d, 1) for d in range(nd)] + [(d, -1) for d in range(nd)]
    s = nb(*order[0])
    for d, off in order[1:]:
        s = s + nb(d, off)
    rr = torch.full_like(c, r)
    if nd == 2:
        lap = s + (-4.0) * c
    elif form.endswith("lap2"):          # s - 6c rounded twice
        lap = s + (-6.0) * c
    else:
        lap = _fma_f32(-6.0, c, s)
    if form.endswith("upd2") or form == "two":
        u = c + rr * lap                 # the update rounded twice
        if form == "two" and nd == 3:
            u = c + rr * (s + (-6.0) * c)
    else:
        u = _fma_f32(rr, lap, c)
    out = T.clone()
    out[ctr] = u
    return out


_FORMS = {2: ["upd2", "k-order"], 3: ["lap2", "upd2", "two", "k-order"]}


@pytest.mark.parametrize("nd,r", [(2, 0.2), (2, 0.1), (3, 1 / 6), (3, 0.15)])
def test_lane_arithmetic_forms(nd, r):
    """The reference's jitted XLA lane program rounds the update once (an
    FMA) and, in 3D, ``s - 6c`` once as well, with the neighbours summed in
    laplacian_interior's order. Only that form matches it: the two-rounding
    forms and the solo kernels' neighbour order each differ in many cells
    (at r = 0.25 the product is exact and no form would show)."""
    B = 14 if nd == 2 else 10
    m = B + 2
    f = np.random.default_rng(7).uniform(1, 2, (1,) + (m,) * nd)
    f = f.astype(np.float32)
    key = je.BucketKey(nd, B, "float32", "ghost")
    adv = je.make_lane_advance(key, kernel="xla", donate=False)
    want = np.asarray(adv(jnp.asarray(f), jnp.asarray([r], jnp.float32),
                          jnp.asarray([B], jnp.int32),
                          jnp.asarray([1], jnp.int32), 1)[0])

    def ndiff(got):
        return int((got.numpy().view(np.uint32) != want.view(np.uint32)).sum())

    T = torch.from_numpy(f)
    assert ndiff(_form_step(T, r, nd, "fma")) == 0
    port, _, _ = cl.lane_multistep(T, torch.tensor([r]),
                                   torch.tensor([B], dtype=torch.int32),
                                   torch.tensor([1], dtype=torch.int32), 1, 0)
    assert ndiff(port) == 0
    for form in _FORMS[nd]:
        assert ndiff(_form_step(T, r, nd, form)) > 0, form


def test_bf16_rounds_every_step():
    """bf16 lanes round to storage after every step, not once per pass as
    the solo kernels do: 16 steps in one call equal 16 one-step calls, and
    differ from 16 steps carried in f32 and rounded once."""
    f, r, n, _ = _case(2, 16, 16, seed=3)
    f[3] = 1.5                     # no NaN: compare whole stacks
    rem = np.full(_L, 100, np.int32)
    T = torch.from_numpy(f).to(torch.bfloat16)
    args = (torch.from_numpy(r), torch.from_numpy(n), torch.from_numpy(rem))
    once, _, _ = cl.lane_multistep(T, *args, 16, 1)
    step = T
    for _ in range(16):
        step, _, _ = cl.lane_multistep(step, *args, 1, 1)
    assert torch.equal(once.view(torch.int16), step.view(torch.int16))
    f32, _, _ = cl.lane_multistep(T.float(), *args, 16, 1)
    assert not torch.equal(once, f32.to(torch.bfloat16))


def test_lane_chunk_writes_boundary_and_countdown():
    f, r, n, rem = _case(2, 12, 5, seed=5)
    fields = torch.from_numpy(f)
    spare = torch.empty_like(fields)
    rem_t = torch.from_numpy(rem)
    rem_out = torch.empty_like(rem_t)
    boundary = torch.full((cl.K_BOUNDARY, _L), -7, dtype=torch.int32)
    out = cl.lane_chunk(fields, spare, torch.from_numpy(r),
                        torch.from_numpy(n), rem_t, rem_out, boundary, 5, 1)
    assert out is spare
    want, fin, stats = cl.lane_multistep(fields, torch.from_numpy(r),
                                         torch.from_numpy(n), rem_t, 5, 1)
    assert torch.equal(out.nan_to_num(), want.nan_to_num())
    np.testing.assert_array_equal(rem_out.numpy(), np.maximum(rem - 5, 0))
    b = boundary.numpy()
    np.testing.assert_array_equal(b[0], np.maximum(rem - 5, 0))
    np.testing.assert_array_equal(b[1], fin.numpy().astype(np.int32))
    np.testing.assert_array_equal(b[2:].view(np.float32), stats.numpy())
    with pytest.raises(ValueError, match="alias"):
        cl.lane_chunk(fields, spare, torch.from_numpy(r), torch.from_numpy(n),
                      rem_t, rem_t, boundary, 5, 1)


def test_availability_and_pass_schedule():
    for nd in (2, 3):
        assert cl.lane_kernel_available(nd, "float32")
        assert cl.lane_kernel_available(nd, torch.bfloat16)
        assert not cl.lane_kernel_available(nd, "float64")
    assert not cl.lane_kernel_available(4, "float32")
    assert cl.passes(2, 37) == [8, 8, 8, 8, 5]
    assert cl.passes(2, 16) == [8, 8]
    assert cl.passes(2, 4) == [4]
    assert cl.passes(3, 4) == [4]
    assert cl.passes(3, 16) == [4, 4, 4, 4]
    assert cl.passes(3, 37) == [4] * 9 + [1]
    assert cl.passes(3, 16, 1) == [1] * 16


_QNAN = {"float32": (torch.int32, 0x7FC00001), "bfloat16": (torch.int16, 0x7FC1)}


def _depth_case(dtype):
    """A 3D stack of B = 8 whose lanes take, in a 16-step chunk: steps past
    the chunk; n < B with NaNs of a payload no kernel computes at the live
    region's edge (read by live cells under ghost BC) and in a cell two
    rows past it (kept: its bytes must survive); a countdown that ends
    inside a 4-step and inside an 8-step pass; none left; a NaN in the
    centre that spreads."""
    B, m = 8, 10
    f = np.random.default_rng(7).uniform(1, 2, (5, m, m, m)).astype(np.float32)
    f[4, 1 + B // 2, 1 + B // 2, 1 + B // 2] = np.nan
    T = torch.from_numpy(f).to(_TORCH[dtype])
    n = torch.tensor([B, B - 3, B, B, B], dtype=torch.int32)
    rem = torch.tensor([20, 17, 6, 0, 16], dtype=torch.int32)
    itype, payload = _QNAN[dtype]
    for row in (B - 3 + 1, B - 3 + 3):
        T.view(itype)[1, row, 3, 4] = payload
    r = torch.tensor([1 / 6, 0.15, 0.1, 1 / 6, 0.15], dtype=torch.float32)
    return T, r, n, rem


def _in_passes(T, r, n, rem, depths, bc_lo):
    """A 16-step chunk as the kernel runs it: passes of the given depths,
    each gated from its offset in the chunk; the last pass's finite bits
    and stats."""
    off = 0
    for k in depths:
        T, fin, stats = cl.lane_multistep_3d_plain(T, r, n, rem - off, k, bc_lo)
        off += k
    return T, fin, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bc", ["edges", "ghost"])
def test_pass_depth_does_not_change_bytes(dtype, bc):
    """Every step rounds to storage, so where a chunk is cut into passes is
    no rounding point: [16], [8, 8], [4, 4, 4, 4] and [1] * 16 give the same
    bytes (NaN payloads included), finite bits and stats."""
    T, r, n, rem = _depth_case(dtype)
    itype = _QNAN[dtype][0]
    want = _in_passes(T, r, n, rem, [16], _BC_LO[bc])
    kept = T.view(itype)[1, 8, 3, 4]
    assert torch.equal(want[0].view(itype)[1, 8, 3, 4], kept)
    assert not bool(want[1][4]) and bool(want[1][0])
    for depths in ([8, 8], [4] * 4, [1] * 16):
        got = _in_passes(T, r, n, rem, depths, _BC_LO[bc])
        assert torch.equal(got[0].view(itype), want[0].view(itype)), depths
        assert torch.equal(got[1], want[1]), depths
        np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())


@pytest.mark.parametrize("nd, m, itemsize, k, by", [
    (2, 258, 4, 16, "bytes"), (2, 258, 2, 16, "operations"),
    (2, 1026, 4, 16, "bytes"), (3, 258, 4, 1, "bytes")])
def test_lane_chunk_bound_counts_the_live_cells(nd, m, itemsize, k, by):
    """A lane chunk's bound: the stack read and written once, against 7
    (2D) or 9 (3D) f32 operations per live cell-step only (8 lanes with
    n = B under edges BC: (B-2)^nd live cells), not per buffer cell."""
    from heat_tpu_torch.machine import PEAKS, DeviceModel

    dm = DeviceModel("NVIDIA H100 80GB HBM3", 132, None, None, 0, PEAKS["H100"])
    cells, live = 8 * m ** nd, 8 * (m - 4) ** nd
    t, got_by = dm.pass_bound_s(cells, itemsize, k, ndim=nd, op_points=live)
    t_bytes = 2 * itemsize * cells / 3.35e12
    t_ops = {2: 7, 3: 9}[nd] * live * k / 67e12
    assert got_by == by and t == pytest.approx(max(t_bytes, t_ops))
    assert dm.pass_bound_s(cells, itemsize, k, ndim=nd, op_points=0) == (
        pytest.approx(t_bytes), "bytes")


def test_f64_takes_two_roundings():
    """No f64 kernel: the plain version takes the serial oracle's
    arithmetic (``c + r*lap``, each operation rounded)."""
    from heat_tpu_torch.backends.serial_np import step_ghost_np

    B = 10
    f = np.random.default_rng(9).uniform(1, 2, (1, B + 2, B + 2))
    f[0, 0, :] = f[0, -1, :] = f[0, :, 0] = f[0, :, -1] = 1.0  # ghost ring
    out, _, _ = cl.lane_multistep(torch.from_numpy(f),
                                  torch.tensor([0.2], dtype=torch.float64),
                                  torch.tensor([B], dtype=torch.int32),
                                  torch.tensor([1], dtype=torch.int32), 1, 0)
    want = step_ghost_np(f[0, 1:-1, 1:-1], 0.2, 1.0)
    np.testing.assert_array_equal(out[0, 1:-1, 1:-1].numpy(), want)

