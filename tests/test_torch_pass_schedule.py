"""heat_tpu_torch.ops.pass_schedule against heat_tpu's Pallas planners.

A bf16 field rounds to storage at every pass boundary, so the port must cut
``k`` fused steps into the passes the reference's ``_multistep`` cuts them
into: in 2D ``min(k, _thin_chunk_cap)`` for the thin kernel or the
column-tiled plan's own ``kchunk`` (``_plan_2d``), in 3D ``_plan_3d``'s
``kchunk``, or no kernel at all where ``_plan_3d`` finds no plan. The
expected passes are derived from the reference's planners (pure Python,
no kernel runs), and on small shapes also observed by spying on the
reference's kernel calls.
"""

import jax.numpy as jnp
import pytest

from heat_tpu.ops import pallas_stencil as ps
from heat_tpu_torch.ops import pass_schedule

_SHAPES_2D = [(67, 130), (100, 500), (4096, 4096), (64, 8320), (32768, 32768)]
_SHAPES_3D = [(24, 24, 24), (40, 33, 130), (256, 256, 256), (512, 512, 512),
              (514, 514, 514), (1024, 1024, 1024),
              (4, 4, 40000)]  # the last has no 3D plan
_KSTEPS = [1, 5, 16, 40]


def _reference_passes(shape, dtype, ksteps):
    if len(shape) == 2:
        plan = ps._plan_2d(shape, dtype, ksteps)
        if plan[0] == "thin":
            chunk = ps._thin_chunk_cap(ps._round_up(max(shape[1], 128), 128),
                                       dtype)
        else:
            chunk = plan[-1]
    else:
        plan = ps._plan_3d(shape, dtype, ksteps)
        if plan is None:
            return None
        chunk = plan[-1]
    full, rem = divmod(ksteps, chunk)
    return [chunk] * full + ([rem] if rem else [])


@pytest.mark.parametrize("ksteps", _KSTEPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _SHAPES_2D + _SHAPES_3D)
def test_passes_are_the_reference_planners(shape, dtype, ksteps):
    assert (pass_schedule.passes(shape, dtype, ksteps)
            == _reference_passes(shape, dtype, ksteps))


def test_known_depths():
    """The depths that make a fixed schedule wrong: 3D bf16 is not 8 deep
    and 1024^3 f32 is 5; wide 2D rows pass 16, 32768^2 takes the
    column-tiled plan's 16, narrower rows pass 32."""
    assert pass_schedule.passes((512,) * 3, "float32", 16) == [8, 8]
    assert pass_schedule.passes((512,) * 3, "bfloat16", 16) == [4] * 4
    assert pass_schedule.passes((1024,) * 3, "float32", 16) == [5, 5, 5, 1]
    assert pass_schedule.passes((514,) * 3, "float32", 16) == [6, 6, 4]
    assert pass_schedule.passes((64, 8320), "bfloat16", 40) == [16, 16, 8]
    assert pass_schedule.passes((32768, 32768), "float32", 40) == [16, 16, 8]
    assert pass_schedule.passes((4096, 4096), "bfloat16", 40) == [32, 8]
    assert pass_schedule.passes((67, 130), "float32", 0) == []
    assert pass_schedule.passes((4, 4, 40000), "float32", 8) is None


@pytest.mark.parametrize("shape,dtype,ksteps", [
    ((67, 130), "bfloat16", 40), ((100, 500), "float32", 16),
    ((24, 20, 130), "bfloat16", 20), ((40, 33, 130), "float32", 16)])
def test_passes_are_what_the_reference_launches(monkeypatch, shape, dtype,
                                                ksteps):
    """The reference's ``_multistep`` run with its kernels replaced by a
    recorder: the step counts it launches are the port's schedule."""
    seen = []

    def record(T, *, ksteps, **_):
        seen.append(ksteps)
        return T

    monkeypatch.setattr(ps, "_pallas_2d", record)
    monkeypatch.setattr(ps, "_pallas_3d_aligned", record)
    ps._multistep(jnp.zeros(shape, dtype), 0.2, ksteps)
    assert seen == pass_schedule.passes(shape, dtype, ksteps)


def test_torch_dtypes_name_the_schedule():
    import torch

    assert (pass_schedule.passes((24, 20, 130), torch.bfloat16, 20)
            == pass_schedule.passes((24, 20, 130), "bfloat16", 20))
    with pytest.raises(ValueError):
        pass_schedule.passes((8, 8), torch.float64, 4)
