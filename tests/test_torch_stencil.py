"""heat_tpu_torch.ops.stencil (the ``torch`` backend's step) against
heat_tpu.ops.stencil (the ``xla`` step): same seeded numpy inputs, bytes
compared, for every boundary condition, 2D and 3D, f32/f64/bf16, at the
shipped r and at r=0.2 (where a fused multiply-add would show: the XLA step
rounds ``T + r*lap`` twice, and so must the port).

The reference step runs op by op, each jnp operation rounding as written.
Under ``jax.jit`` XLA's CPU compiler fuses the step and may contract
``a*b + c`` into a fused multiply-add (in 2D at r=0.2, and in 3D where
``-6*T`` is inexact), a compiler choice that moves last bits; the
arithmetic the step writes down is the op-by-op one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat_tpu.ops import stencil as ref_ops
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.ops import stencil as ops

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default of one thread per core in each worker starves the rest.
torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32),
       "float64": (jnp.float64, torch.float64),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_STEPS = 7


def _run_ref(T, bc, r, dtype):
    step = {"edges": lambda t: ref_ops.ftcs_step_edges(t, r),
            "ghost": lambda t: ref_ops.ftcs_step_ghost(t, r, 1.0),
            "periodic": lambda t: ref_ops.ftcs_step_periodic(t, r)}[bc]
    out = jnp.asarray(T).astype(_DT[dtype][0])
    for _ in range(_STEPS):
        out = step(out)
    return np.asarray(out.astype(jnp.float64))


def _run_port(T, bc, r, dtype):
    step = {"edges": lambda t: ops.ftcs_step_edges(t, r),
            "ghost": lambda t: ops.ftcs_step_ghost(t, r, 1.0),
            "periodic": lambda t: ops.ftcs_step_periodic(t, r)}[bc]
    out = ops.run_steps(torch.from_numpy(T).to(_DT[dtype][1]), _STEPS, step)
    return out.double().numpy()


@pytest.mark.parametrize("r", [HeatConfig().r, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("bc", ["edges", "ghost", "periodic"])
def test_torch_step_matches_xla_step(bc, ndim, dtype, r):
    shape = (23, 31) if ndim == 2 else (9, 10, 11)
    T = np.random.default_rng(ndim).uniform(1, 2, shape)
    if dtype != "float64":
        T = T.astype(np.float32)
    ref = _run_ref(T, bc, r, dtype)
    got = _run_port(T, bc, r, dtype)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))


def test_laplacian_interior_order():
    """The summation order is the reference expression's, so an f64 sum
    that association could change is reproduced exactly."""
    T = np.random.default_rng(5).standard_normal((12, 13)) * 10.0 ** np.arange(13)
    ref = np.asarray(ref_ops.laplacian_interior(jnp.asarray(T)))
    got = ops.laplacian_interior(torch.from_numpy(T)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_accum_dtype_for(dtype):
    jdt, tdt = _DT[dtype]
    assert str(ops.accum_dtype_for(tdt)).replace("torch.", "") == \
        str(ref_ops.accum_dtype_for(jdt))
