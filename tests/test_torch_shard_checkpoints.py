"""The port's shard checkpoints against heat_tpu's, on the CPU.

A world of several ranks checkpoints per-rank shard files
(``heat_shards_step%08d.proc%04d.npz``). Held to heat_tpu's
``runtime.checkpoint``: ``save_shards`` writes the bytes the reference
writes for the same blocks in the same order (the reference's blocks are
those of a jax array sharded over the 8 virtual CPU devices
``conftest.py`` provides); ``latest_shards`` and ``scan_resume_step``
give the reference's answers and quarantine the same files, on copies of
one directory; a fingerprint mismatch raises. The world's agreement on
the resume step (the minimum over the ranks) runs in a 2-rank gloo world.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import types
import zipfile
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import heat_tpu.config as ref_config
from heat_tpu.runtime import checkpoint as ref_ckpt
from heat_tpu_torch import config
from heat_tpu_torch.runtime import checkpoint, faults

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def fixed_zip_time(monkeypatch):
    """zip members carry the time they were written (to 2 s): both
    packages' files are written at one fixed time so that their bytes
    compare."""
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.time = lambda: 1.7e9
    monkeypatch.setattr(zipfile, "time", fake)


def _cfgs(tmp_path, **kw):
    kw = {"n": 24, "ndim": 2, "dtype": "float32", "backend": "sharded", **kw}
    return (ref_config.HeatConfig(**kw, checkpoint_dir=str(tmp_path / "ref")),
            config.HeatConfig(**kw, checkpoint_dir=str(tmp_path / "port")))


def _sharded_field(ndim, dtype, seed):
    """A jax array over the 8 CPU devices and its shards as the port's
    blocks, ``(start offsets, tensor)``, in the same order."""
    n = 24
    mesh_shape = (2, 4) if ndim == 2 else (2, 2, 2)
    devs = np.array(jax.devices()[:8]).reshape(mesh_shape)
    names = ("x", "y", "z")[:ndim]
    T = np.random.default_rng(seed).uniform(1, 2, (n,) * ndim).astype(np.float32)
    arr = jax.device_put(jnp.asarray(T).astype(dtype),
                         NamedSharding(Mesh(devs, names), P(*names)))
    blocks = []
    for shard in arr.addressable_shards:
        data = np.asarray(shard.data)
        t = (torch.from_numpy(data.view(np.int16).copy()).view(torch.bfloat16)
             if dtype == "bfloat16" else torch.from_numpy(data.copy()))
        blocks.append((tuple(s.start or 0 for s in shard.index), t))
    return arr, blocks


@pytest.mark.parametrize("ndim,dtype", [(2, "float32"), (2, "bfloat16"),
                                        (3, "float32")])
def test_save_shards_bytes_match_reference(tmp_path, fixed_zip_time, ndim,
                                           dtype):
    ref_cfg, cfg = _cfgs(tmp_path, ndim=ndim, dtype=dtype)
    arr, blocks = _sharded_field(ndim, dtype, seed=ndim)
    want = ref_ckpt.save_shards(ref_cfg, arr, 12)
    got = checkpoint.save_shards(cfg, blocks, 12)
    assert got.name == want.name == "heat_shards_step00000012.proc0000.npz"
    assert got.read_bytes() == want.read_bytes()
    # and back: each block at its offset, bf16 widened exactly
    loaded, step = checkpoint.load_shards(cfg, 12)
    assert step == 12
    for (start, data), (s0, t) in zip(loaded, blocks):
        assert start == s0
        np.testing.assert_array_equal(data, t.float().numpy())


def test_load_shards_refuses_other_physics(tmp_path):
    _, cfg = _cfgs(tmp_path)
    _, blocks = _sharded_field(2, "float32", seed=0)
    checkpoint.save_shards(cfg, blocks, 4)
    with pytest.raises(ValueError, match="different physics"):
        checkpoint.load_shards(cfg.with_(sigma=0.2), 4)
    with pytest.raises(ValueError, match="different physics"):
        checkpoint.latest_shards(cfg.with_(sigma=0.2))


def _damage(path: Path, how: str) -> None:
    data = path.read_bytes()
    if how == "truncate":
        path.write_bytes(data[:len(data) // 2])
    else:
        mid = len(data) // 2
        path.write_bytes(data[:mid] + bytes(b ^ 0xFF for b in data[mid:mid + 64])
                         + data[mid + 64:])


def _write_set(d: Path, cfg, steps, procs=(0, 1), nan_at=None):
    """Shard files of ``steps`` for ``procs`` (each a 12x24 block)."""
    d.mkdir(parents=True, exist_ok=True)
    cfg = cfg.with_(checkpoint_dir=str(d))
    for step in steps:
        for proc in procs:
            block = torch.full((12, 24), 1.0 + step + proc)
            if nan_at == (step, proc):
                block[3, 4] = float("nan")
            with mock.patch.object(faults, "_process_index", lambda: proc):
                checkpoint.save_shards(cfg, [((12 * proc, 0), block)], step)


# (name, steps with both ranks' files, damage, extra, max_step)
_SCANS = [
    ("partial newest", (2, 4), None, "partial6", None),
    ("corrupt newest", (2, 4, 6), ("corrupt", 6, 1), None, None),
    ("truncated newest", (2, 4, 6), ("truncate", 6, 0), None, None),
    ("non-finite newest", (2, 4), ("nan", 4, 1), None, None),
    ("capped", (2, 4, 6), None, None, 5),
    ("global newer", (2, 4), None, "global8", None),
    ("global older", (2, 4), None, "global2", None),
    ("none complete", (), None, "partial6", None),
]


@pytest.mark.parametrize("name,steps,damage,extra,cap", _SCANS,
                         ids=[s[0] for s in _SCANS])
def test_scan_resume_step_matches_reference(tmp_path, name, steps, damage,
                                            extra, cap):
    _, cfg = _cfgs(tmp_path)
    src = tmp_path / "src"
    _write_set(src, cfg, steps,
               nan_at=damage[1:] if damage and damage[0] == "nan" else None)
    if damage and damage[0] != "nan":
        _damage(src / f"heat_shards_step{damage[1]:08d}.proc"
                f"{damage[2]:04d}.npz", damage[0])
    if extra == "partial6":
        _write_set(src, cfg, (6,), procs=(0,))
    elif extra and extra.startswith("global"):
        checkpoint.save(cfg.with_(checkpoint_dir=str(src)),
                        np.ones((24, 24), np.float32), int(extra[6:]))
    shutil.copytree(src, tmp_path / "a")
    shutil.copytree(src, tmp_path / "b")
    got = checkpoint.scan_resume_step(tmp_path / "a", nprocs=2, max_step=cap)
    want = ref_ckpt.scan_resume_step(tmp_path / "b", nprocs=2, max_step=cap)
    assert got == want
    assert (sorted(p.name for p in (tmp_path / "a").iterdir())
            == sorted(p.name for p in (tmp_path / "b").iterdir()))


def test_latest_shards_quarantines_like_reference(tmp_path):
    """This rank's newest valid step, the bad newer files renamed to
    ``*.corrupt`` (rank 0: the process index of both packages here)."""
    ref_cfg, cfg = _cfgs(tmp_path)
    src = tmp_path / "src"
    _write_set(src, cfg, (2, 4, 6, 8), nan_at=(6, 0))
    _damage(src / "heat_shards_step00000008.proc0000.npz", "corrupt")
    shutil.copytree(src, tmp_path / "port")
    shutil.copytree(src, tmp_path / "ref")
    assert checkpoint.latest_shards(cfg) == 4
    assert ref_ckpt.latest_shards(ref_cfg) == 4
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert {"heat_shards_step00000006.proc0000.npz.corrupt",
            "heat_shards_step00000008.proc0000.npz.corrupt"} <= set(names)
    assert checkpoint.latest_shards(cfg, max_step=3) == 2


_AGREE = '''import json, sys
import torch.distributed as dist
from heat_tpu_torch.backends.common import _agree_resume_step
from heat_tpu_torch.parallel.dist import init_distributed
init_distributed("cpu", "staged")
rank = dist.get_rank()
for steps in json.loads(sys.argv[1]):
    print("AGREED", json.dumps([steps, _agree_resume_step(steps[rank])]),
          flush=True)
'''


def test_world_agrees_on_the_minimum_step(tmp_path):
    """Ranks holding different newest steps resume at the minimum; a rank
    with none pulls every rank to none."""
    cases = [[8, 4], [4, 8], [8, None], [None, None], [6, 6]]
    worker = tmp_path / "agree.py"
    worker.write_text(_AGREE)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "--tee=1", str(worker), json.dumps(cases)],
        env={**os.environ, "PYTHONPATH": str(_REPO), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = [json.loads(line.split("AGREED ", 1)[1])
           for line in proc.stdout.splitlines() if "AGREED " in line]
    assert len(got) == 2 * len(cases)
    for steps, agreed in got:
        live = [s for s in steps if s is not None]
        assert agreed == (min(live) if len(live) == len(steps) else None)
