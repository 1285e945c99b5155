"""heat_tpu_torch's config, grid, .dat files and checkpoints against
heat_tpu's: every shipped config parses to the same fields, every initial
condition is the same array, the text files are the same bytes, and each
package resumes the other's checkpoint."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu.config as ref_config
import heat_tpu.grid as ref_grid
import heat_tpu.io as ref_io
from heat_tpu.backends import solve as ref_solve
from heat_tpu.runtime import checkpoint as ref_ckpt
from heat_tpu_torch import config, grid, io
from heat_tpu_torch.backends import solve
from heat_tpu_torch.runtime import checkpoint

# One intra-op thread: the suite runs several pytest workers at once, and
# torch's default of one thread per core in each worker starves the rest.
torch.set_num_threads(1)

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.dat"))
_FIELDS = ("n", "sigma", "nu", "dom_len", "ntime", "soln", "delta", "dt", "r",
           "shape", "points")
# the port's backend names for the reference's
_BACKEND = {"xla": "torch", "pallas": "cuda", "serial": "serial",
            "sharded": "sharded"}


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_configs_parse_to_the_same_fields(path):
    got, want = config.parse_input(path), ref_config.parse_input(path)
    for f in _FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_write_input_round_trips_like_the_reference(tmp_path):
    cfg = config.HeatConfig(n=37, sigma=0.2, nu=0.07, dom_len=1.5, ntime=9,
                            soln=True)
    config.write_input(cfg, tmp_path / "a.dat")
    ref_config.write_input(ref_config.HeatConfig(
        n=37, sigma=0.2, nu=0.07, dom_len=1.5, ntime=9, soln=True),
        tmp_path / "b.dat")
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()
    assert config.parse_input(tmp_path / "a.dat") == cfg


@pytest.mark.parametrize("name", sorted(ref_config.VARIANTS))
def test_variants_map_backends(name):
    got = config.variant_config(name)
    want = ref_config.variant_config(name)
    for f in ("ic", "bc", "dtype", "write_int", "heartbeat_every"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.backend == _BACKEND[want.backend]


def _pair(ndim, dtype, ic, n=19, bc="edges"):
    kw = dict(n=n, ndim=ndim, dtype=dtype, ic=ic, bc=bc)
    return config.HeatConfig(**kw), ref_config.HeatConfig(**kw)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("ic", ["hat", "hat_half", "hat_small", "uniform",
                                "zero", "sine"])
def test_initial_condition_is_the_same_array(ic, dtype, ndim):
    cfg, rcfg = _pair(ndim, dtype, ic)
    want = ref_grid.initial_condition(rcfg)
    host = grid.initial_condition(cfg)
    assert host.dtype == want.dtype
    np.testing.assert_array_equal(host, want)
    dev = grid.initial_condition_device(cfg, "cpu")
    assert dev.dtype == {"float64": torch.float64, "float32": torch.float32,
                         "bfloat16": torch.bfloat16}[dtype]
    # the device field is the host one in the storage dtype
    np.testing.assert_array_equal(
        dev.double().numpy(),
        torch.from_numpy(np.array(want)).to(dev.dtype).double().numpy())
    for ax_got, ax_want in zip(grid.coords(cfg), ref_grid.coords(rcfg)):
        np.testing.assert_array_equal(ax_got, ax_want)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("bc", ["edges", "ghost"])
@pytest.mark.parametrize("ic", ["hat", "hat_half", "hat_small", "sine",
                                "uniform"])
def test_grid_helpers_agree(ic, bc, ndim):
    cfg, rcfg = _pair(ndim, "float32", ic, bc=bc)
    assert grid.ic_envelope(cfg) == ref_grid.ic_envelope(rcfg)
    assert grid.sine_decay_factor(cfg) == ref_grid.sine_decay_factor(rcfg)
    np.testing.assert_array_equal(grid.boundary_mask(cfg),
                                  ref_grid.boundary_mask(rcfg))
    if ic.startswith("hat"):
        assert grid._hat_index_bounds(cfg) == ref_grid._hat_index_bounds(rcfg)


@pytest.mark.parametrize("ndim", [2, 3])
def test_int_and_soln_dat_bytes_identical(tmp_path, ndim):
    cfg, rcfg = _pair(ndim, "float64", "hat", n=11)
    T = np.random.default_rng(ndim).uniform(1, 2, cfg.shape)
    io.write_int_dat(tmp_path / "int_a.dat", grid.coords(cfg), T)
    ref_io.write_int_dat(tmp_path / "int_b.dat", ref_grid.coords(rcfg), T)
    io.write_soln(tmp_path / "soln_a.dat", grid.coords(cfg), T)
    ref_io.write_soln(tmp_path / "soln_b.dat", ref_grid.coords(rcfg), T)
    for stem in ("int", "soln"):
        a = (tmp_path / f"{stem}_a.dat").read_bytes()
        assert a == (tmp_path / f"{stem}_b.dat").read_bytes()
    axes, back = io.read_dat(tmp_path / "soln_a.dat", ndim=ndim)
    np.testing.assert_array_equal(back, T)


def test_native_and_numpy_writers_agree(tmp_path, monkeypatch):
    from heat_tpu_torch.io import datfiles

    cfg = config.HeatConfig(n=9)
    T = np.random.default_rng(1).uniform(1, 2, cfg.shape)
    io.write_soln(tmp_path / "a.dat", grid.coords(cfg), T)
    monkeypatch.setattr(datfiles, "fast_write_triplets", lambda *a: False)
    io.write_soln(tmp_path / "b.dat", grid.coords(cfg), T)
    np.testing.assert_array_equal(io.read_dat(tmp_path / "a.dat")[1],
                                  io.read_dat(tmp_path / "b.dat")[1])


# process i imports, waits for the go file and i * 40 ms more (the starts
# spread over one build, so later ones find a build in progress), then
# loads the library of argv[1] (building it where it is missing) and writes
# the table with it
_BUILD_RACE = """
import sys, time
from pathlib import Path
import numpy as np
from heat_tpu_torch.io.native import _library
d = Path(sys.argv[1])
while not (d / "go").exists():
    time.sleep(0.005)
time.sleep(0.04 * int(sys.argv[2]))
lib = _library(d)
t = np.load(d / "table.npy")
sys.exit(3 if lib is None else
         lib.heat_write_table(str(d / f"out{sys.argv[2]}.dat").encode(), t,
                              *t.shape))
"""


def test_native_library_builds_whole_beside_other_builds(tmp_path):
    """Processes that find no library build it at the same moment, as the
    ranks of a ``launch`` world do: each loads a whole library and writes
    the native writer's bytes (a torn load would drop it to numpy's), and
    no temporary file is left."""
    import os
    import shutil
    import subprocess
    import sys

    from heat_tpu_torch.io import native

    for f in ("Makefile", "fastio.cpp"):
        shutil.copy(Path(native.__file__).parent / f, tmp_path / f)
    table = np.random.default_rng(2).uniform(1, 2, (257, 3))
    np.save(tmp_path / "table.npy", table)
    assert native.fast_write_triplets(str(tmp_path / "ref.dat"), table)
    root = str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "PYTHONPATH": root + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_RACE,
                               str(tmp_path), str(i)], env=env)
             for i in range(12)]
    time.sleep(1.0)
    (tmp_path / "go").touch()
    assert [p.wait(timeout=120) for p in procs] == [0] * 12
    ref = (tmp_path / "ref.dat").read_bytes()
    assert all((tmp_path / f"out{i}.dat").read_bytes() == ref
               for i in range(12))
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fingerprints_agree(dtype):
    cfg, rcfg = _pair(2, dtype, "hat")
    assert checkpoint.config_fingerprint(cfg) == ref_ckpt.config_fingerprint(rcfg)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_resume_across_packages(tmp_cwd, writer, dtype):
    """A solve cut at step 12 and resumed by the other package ends on the
    bytes of an uninterrupted solve."""
    kw = dict(n=21, ntime=20, dtype=dtype, ic="hat", checkpoint_every=12,
              checkpoint_dir=str(tmp_cwd / "ck"))
    port_cfg = config.HeatConfig(backend="torch", **kw)
    ref_cfg = ref_config.HeatConfig(backend="xla", **kw)
    whole = ref_solve(ref_cfg.with_(checkpoint_every=0)).T
    if writer == "port":
        solve(port_cfg.with_(ntime=12), device="cpu")
        res = ref_solve(ref_cfg)
    else:
        ref_solve(ref_cfg.with_(ntime=12))
        res = solve(port_cfg, device="cpu")
    assert res.start_step == 12
    np.testing.assert_array_equal(np.asarray(res.T), np.asarray(whole))


def test_bf16_checkpoint_round_trips(tmp_cwd):
    cfg = config.HeatConfig(n=13, dtype="bfloat16", checkpoint_dir="ck")
    T = torch.from_numpy(np.random.default_rng(2).uniform(1, 2, cfg.shape)
                         ).to(torch.bfloat16)
    path = checkpoint.save(cfg, T, 5)
    assert checkpoint.latest(cfg) == path
    back, step = checkpoint.load(path, cfg)
    assert step == 5
    np.testing.assert_array_equal(back, T.float().numpy())
