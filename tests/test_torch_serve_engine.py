"""heat_tpu_torch.serve.engine's pieces against heat_tpu.serve.engine's.

The boundary vector's bit layout, the lane tiers and tail size, the host
lane image, the kernel-resolution rules, the state carried across from the
reference's stack (both of its layouts), and one LaneEngine chunk against
the reference's XLA lane program, on the CPU, seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat_tpu.ops import pallas_stencil as ps
from heat_tpu.serve import engine as je
from heat_tpu_torch.serve import engine as te

torch.set_num_threads(1)


def test_boundary_rows_are_the_reference():
    assert te.BOUNDARY_ROWS == je.BOUNDARY_ROWS
    assert te.K_BOUNDARY == je.K_BOUNDARY


def test_pack_unpack_boundary_bit_level():
    """Stats rows are a bitcast: NaN payloads, infinities and -0 survive
    the round trip bit for bit, and the packed bits are the reference's."""
    rem = np.array([5, 0, 17, 3], np.int32)
    fin = np.array([True, False, True, True])
    stats = np.array([[0.5, np.nan, 1e-30, 0.0],
                      [1.0, -np.inf, 2.0, -0.0],
                      [2.0, np.inf, 3.5, 7.0],
                      [10.0, 3.0, -1e30, 1.25]], np.float32)
    stats.view(np.uint32)[0, 1] = 0x7FC01234       # a NaN with a payload
    b = te.pack_boundary(torch.from_numpy(rem), torch.from_numpy(fin),
                         torch.from_numpy(stats))
    host = te.host_fetch(b)
    assert host.dtype == np.int32 and host.shape == (te.K_BOUNDARY, 4)
    np.testing.assert_array_equal(host[0], rem)
    np.testing.assert_array_equal(host[1], fin.astype(np.int32))
    np.testing.assert_array_equal(te.unpack_boundary(host).view(np.uint32),
                                  stats.view(np.uint32))
    ref = np.asarray(je.pack_boundary(jnp.asarray(rem), jnp.asarray(fin),
                                      jnp.asarray(stats)))
    np.testing.assert_array_equal(host, ref)
    np.testing.assert_array_equal(te.unpack_boundary(ref).view(np.uint32),
                                  je.unpack_boundary(ref).view(np.uint32))


@pytest.mark.parametrize("needed,cap", [(1, 4), (3, 4), (5, 4), (5, 8),
                                        (8, 8), (9, 16), (2, 1)])
def test_lane_tier_is_the_reference(needed, cap):
    assert te.lane_tier(needed, cap) == je.lane_tier(needed, cap)


def test_lane_tier_rejects_nonpositive():
    with pytest.raises(ValueError):
        te.lane_tier(0, 4)


@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 7, 16, 33])
def test_tail_size_is_the_reference(chunk):
    assert te.tail_size(chunk) == je.tail_size(chunk)


@pytest.mark.parametrize("ndim,n", [(2, 5), (2, 12), (3, 4)])
def test_lane_buffer_is_the_reference(ndim, n):
    field = np.random.default_rng(n).uniform(1, 2, (n,) * ndim)
    tk = te.BucketKey(ndim, 12 if ndim == 2 else 6, "float32", "ghost")
    jk = je.BucketKey(ndim, tk.n, "float32", "ghost")
    np.testing.assert_array_equal(te.lane_buffer(tk, field, 2.5),
                                  je.lane_buffer(jk, field, 2.5))
    assert tk.padded_shape == jk.padded_shape


def test_lane_buffer_rejects_oversize():
    with pytest.raises(ValueError, match="exceeds bucket"):
        te.lane_buffer(te.BucketKey(2, 4, "float32", "edges"),
                       np.ones((5, 5)), 1.0)


@pytest.mark.parametrize("requested,dtype,device,want", [
    ("auto", "float32", "cuda", ("cuda", False)),
    ("auto", "bfloat16", "cuda", ("cuda", False)),
    ("auto", "float64", "cuda", ("torch", True)),
    ("auto", "float32", "cpu", ("torch", False)),
    ("auto", "float64", "cpu", ("torch", False)),
    ("cuda", "float32", "cpu", ("cuda", False)),
    ("cuda", "float64", "cpu", ("torch", True)),
    ("cuda", "float64", "cuda", ("torch", True)),
    ("torch", "float32", "cuda", ("torch", False)),
])
def test_resolve_lane_kernel(requested, dtype, device, want):
    """auto = the kernels on the card where the bucket has one (a missing
    one is a loud fallback), torch on the CPU; cuda forces them (f64: loud
    fallback, never an error); torch forces the plain step."""
    for ndim in (2, 3):
        key = te.BucketKey(ndim, 16, dtype, "edges")
        kernel, reason = te.resolve_lane_kernel(requested, key, device)
        assert (kernel, reason is not None) == want


# (the reference has no f64 Pallas layout)
@pytest.mark.parametrize("dtype,layout", [
    ("float32", "xla"), ("bfloat16", "xla"), ("float64", "xla"),
    ("float32", "pallas"), ("bfloat16", "pallas")])
def test_lane_state_from_reference(dtype, layout):
    """The reference's stack in either layout crops to the port's: the
    bucket buffer, bytes unchanged."""
    B, L = 12, 3
    key = te.BucketKey(2, B, dtype, "edges")
    m = B + 2
    f = np.random.default_rng(1).uniform(1, 2, (L, m, m)).astype(np.float32)
    shape = (m, m) if layout == "xla" else ps.lane_state_shape(2, B, dtype)
    stack = jnp.zeros((L,) + shape, jnp.dtype(dtype)).at[:, :m, :m].set(
        jnp.asarray(f).astype(jnp.dtype(dtype)))
    r = np.array([0.25, 0.2, 0.1], np.float32)
    n = np.array([12, 9, 5], np.int32)
    rem = np.array([7, 0, 3], np.int32)
    tf, tr, tn, trem = te.lane_state_from_reference(np.asarray(stack), r, n,
                                                    rem, key)
    assert tuple(tf.shape) == (L, m, m)
    want = np.asarray(stack[:, :m, :m])
    assert te.host_fetch(tf).tobytes() == want.tobytes()
    assert tr.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    np.testing.assert_array_equal(tr.numpy(), r.astype(tr.numpy().dtype))
    np.testing.assert_array_equal(tn.numpy(), n)
    np.testing.assert_array_equal(trem.numpy(), rem)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_lane_engine_chunk_matches_reference(dtype, kernel):
    """One LaneEngine, loaded from the reference's state, steps a chunk and
    its tail to the reference's XLA lane program's bytes and boundary."""
    B, L = 12, 4
    key = te.BucketKey(2, B, dtype, "ghost")
    m = B + 2
    f = np.random.default_rng(2).uniform(1, 2, (L, m, m)).astype(np.float32)
    r = np.array([0.25, 0.2, 0.1, 0.2], np.float32)
    n = np.array([12, 9, 5, 12], np.int32)
    rem = np.array([7, 0, 3, 40], np.int32)
    ref = (jnp.asarray(f).astype(jnp.dtype(dtype)), jnp.asarray(r),
           jnp.asarray(n), jnp.asarray(rem))
    adv = je.make_lane_advance(je.BucketKey(2, B, dtype, "ghost"),
                               kernel="xla", donate=False)
    eng = te.LaneEngine(key, L, 8, kernel=kernel, device="cpu")
    eng._fields, eng._r, eng._n, eng._rem = te.lane_state_from_reference(
        np.asarray(ref[0]), r, n, rem, key)
    eng._spare = torch.empty_like(eng._fields)
    for k in (8, 2):
        out = adv(*ref, k)
        ref = out[:4]
        b = eng.fetch_remaining(eng.dispatch_chunk(k))
        want = np.asarray(out[4])
        np.testing.assert_array_equal(b[:2], want[:2])
        np.testing.assert_array_equal(te.unpack_boundary(b)[:3],
                                      je.unpack_boundary(want)[:3])
        np.testing.assert_allclose(te.unpack_boundary(b)[3],
                                   je.unpack_boundary(want)[3], rtol=1e-5)
        assert te.host_fetch(eng._fields).tobytes() == \
            np.asarray(ref[0]).tobytes()
    np.testing.assert_array_equal(eng.remaining(), np.asarray(ref[3]))


def test_load_lane_builds_the_reference_lane_image():
    """load_lane on the device = the reference's host lane_buffer, cast."""
    key = te.BucketKey(2, 12, "bfloat16", "ghost")
    eng = te.LaneEngine(key, 2, 4, device="cpu")
    field = np.random.default_rng(4).uniform(1, 2, (9, 9)).astype(np.float32)
    eng.load_lane(1, field, 0.2, 30, 2.5)
    want = je.lane_buffer(je.BucketKey(2, 12, "bfloat16", "ghost"), field,
                          2.5).astype(jnp.bfloat16)
    assert te.host_fetch(eng._fields[1]).tobytes() == want.tobytes()
    assert eng.remaining().tolist() == [0, 30]
    snap = te.host_fetch(eng.snapshot_lane(1, 9))
    assert snap.dtype == np.dtype("V2")
    np.testing.assert_array_equal(te.bf16_to_float32(snap),
                                  np.asarray(want[1:10, 1:10], np.float32))


def test_lane_engine_rejects_periodic_and_bad_kernel():
    with pytest.raises(ValueError, match="no lane form"):
        te.LaneEngine(te.BucketKey(2, 8, "float32", "periodic"), 2, 4)
    with pytest.raises(ValueError, match="kernel must be"):
        te.LaneEngine(te.BucketKey(2, 8, "float32", "edges"), 2, 4,
                      kernel="pallas", device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_lane_engine_defaults_to_the_card_and_auto(dtype):
    """A LaneEngine built without a device runs on the card (and raises on
    a host without one, as every entry point of the port does); its
    kernel defaults to "auto", resolved as the scheduler resolves it."""
    key = te.BucketKey(2, 8, dtype, "edges")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            te.LaneEngine(key, 2, 4)
    eng = te.LaneEngine(key, 2, 4, device="cpu")
    assert (eng.kernel, eng.fallback_reason) == te.resolve_lane_kernel(
        "auto", key, "cpu") == ("torch", None)
    assert te.LaneEngine(key, 2, 4, kernel="cuda", device="cpu").kernel \
        == "cuda"
