"""heat_tpu_torch.parallel (mesh, halo, comm) against heat_tpu.parallel.

The port's halo functions run on a list of padded shards through a
communicator (``LocalComm`` here: every shard in this process); heat_tpu's
run inside ``shard_map`` on the 8 virtual CPU devices ``conftest.py``
provides. The same random padded shards go through both, and every cell of
every padded shard (owned and ghost, corners included) must hold the same
bytes: seq and indep, widths 1-3, periodic or not, direct or staged, on
meshes (4, 2), (2, 4), (1, 1) and (2, 2, 2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from heat_tpu.backends.sharded import shard_map
from heat_tpu.parallel import halo as ref_halo
from heat_tpu.parallel import mesh as ref_mesh
from heat_tpu_torch.parallel import comm as port_comm
from heat_tpu_torch.parallel import halo, mesh

torch.set_num_threads(1)

_BC = 0.75


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_auto_mesh_shape_matches_reference(ndim):
    for ndev in range(1, 65):
        assert mesh.auto_mesh_shape(ndev, ndim) == ref_mesh.auto_mesh_shape(ndev, ndim)


@pytest.mark.parametrize("n,shape", [(32, (4, 2)), (30, (4, 2)), (30, (2, 3)),
                                     (16, (2, 2, 2)), (18, (2, 3, 1))])
def test_validate_divisible_matches_reference(n, shape):
    devices = jax.devices()[:int(np.prod(shape))]
    ref = ref_mesh.build_mesh(len(shape), shape, devices)
    want = None
    try:
        ref_mesh.validate_divisible(n, ref)
    except ValueError as e:
        want = str(e)
    got = None
    try:
        mesh.validate_divisible(n, mesh.RankMesh(shape))
    except ValueError as e:
        got = str(e)
    assert got == want


def test_rank_mesh_neighbors():
    m = mesh.RankMesh((2, 3))
    assert m.coords(4) == (1, 1) and m.rank_of((1, 1)) == 4
    assert m.neighbors(0, 0) == (None, 3) and m.neighbors(4, 1) == (3, 5)
    p = mesh.RankMesh((2, 1), periodic=True)
    assert p.neighbors(0, 0) == (1, 1)      # a ring of two: both sides
    assert p.neighbors(1, 1) == (1, 1)      # size 1: the shard itself
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        mesh.build_mesh(2, 4, (4, 2))


def _shards(shape, width, seed):
    """Random padded shards (owned + width-cell margin) in rank order."""
    rng = np.random.default_rng(seed)
    local = 4 if len(shape) < 3 else 3
    return [rng.random((local + 2 * width,) * len(shape)) + 1.0
            for _ in range(int(np.prod(shape)))]


def _reference(fn, blocks, shape, width, periodic, staged):
    """heat_tpu's halo function on the blocks, inside shard_map."""
    nd = len(shape)
    names = ref_mesh.MESH_AXES[:nd]
    jmesh = ref_mesh.build_mesh(nd, shape, jax.devices()[:len(blocks)])
    side = blocks[0].shape
    glob = np.zeros(tuple(s * b for s, b in zip(shape, side)))
    for rank, b in enumerate(blocks):
        c = np.unravel_index(rank, shape)
        glob[tuple(slice(ci * bi, (ci + 1) * bi) for ci, bi in zip(c, side))] = b
    spec = P(*names)
    body = functools.partial(fn, axis_names=names, axis_sizes=shape,
                             bc_value=_BC, staged=staged, width=width,
                             periodic=periodic)
    out = jax.jit(shard_map(body, mesh=jmesh, in_specs=(spec,), out_specs=spec,
                            check_vma=False))(
        jax.device_put(jnp.asarray(glob), NamedSharding(jmesh, spec)))
    out = np.asarray(out)
    return [out[tuple(slice(ci * bi, (ci + 1) * bi)
                      for ci, bi in zip(np.unravel_index(r, shape), side))]
            for r in range(len(blocks))]


_CASES = [(shape, w, periodic)
          for shape in ((4, 2), (2, 4), (1, 1), (2, 2, 2))
          for w in (1, 2, 3) for periodic in (False, True)
          if not (len(shape) == 3 and w == 3)]


@pytest.mark.parametrize("form", ["seq", "indep"])
@pytest.mark.parametrize("shape,width,periodic", _CASES)
def test_halo_matches_reference(shape, width, periodic, form):
    """The port's one exchange against each of the reference's two
    formulations (the same bytes by design), every cell."""
    blocks = _shards(shape, width, seed=len(shape) * 10 + width)
    ref_fn = ref_halo.halo_exchange if form == "seq" else ref_halo.halo_exchange_indep
    want = _reference(ref_fn, blocks, shape, width, periodic, staged=False)
    for staged in (False, True):
        comm = port_comm.LocalComm(mesh.RankMesh(shape, periodic), "cpu", staged)
        got = halo.halo_exchange([torch.tensor(b) for b in blocks], comm, _BC,
                                 width=width)
        for rank, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"shard {rank}")
        assert comm.stats["exchanges"] == 1


def test_staged_goes_through_host(monkeypatch):
    """``staged`` sends every received slab through ``stage_to_host``;
    ``direct`` sends none."""
    calls = []
    real = port_comm.stage_to_host

    def spy(t):
        calls.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(port_comm, "stage_to_host", spy)
    blocks = _shards((2, 2), 2, seed=3)
    for staged in (False, True):
        calls.clear()
        comm = port_comm.LocalComm(mesh.RankMesh((2, 2)), "cpu", staged)
        halo.halo_exchange([torch.tensor(b) for b in blocks], comm, _BC, 2)
        # 2x2, not periodic: each shard has one neighbour per axis
        assert len(calls) == (8 if staged else 0)


def test_halo_pad():
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    p = halo.halo_pad(t, 0.3, 2)
    ref = np.asarray(ref_halo.halo_pad(jnp.asarray(t.float().numpy(), jnp.bfloat16),
                                       0.3, 2), np.float32)
    np.testing.assert_array_equal(p.float().numpy(), ref)
