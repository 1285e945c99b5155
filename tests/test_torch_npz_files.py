"""The port's published files against the reference's, whole-file bytes,
and the packaging of the kernel sources.

A bf16 field is written under the ``.npy`` header an ``ml_dtypes.bfloat16``
array gets (``'descr': '<V2'``), as ``heat_tpu`` writes it, so a ``run``
checkpoint and a served result are the reference's files byte for byte
(numpy pins the zip members' timestamps, so equal inputs give equal files);
f32 is the control. Then: every header a kernel source includes is shipped
by ``pyproject.toml``'s package data, so an installed package can build its
kernels."""

import fnmatch
import re
import tomllib
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu.cli import main as ref_main
from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu_torch.cli import main
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.runtime import checkpoint
from heat_tpu_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)
_REPO = Path(__file__).resolve().parent.parent
_DTYPES = ["bfloat16", "float32"]


@pytest.mark.parametrize("dtype", _DTYPES)
def test_run_checkpoints_are_the_reference_files(tmp_path, monkeypatch, dtype):
    """``run --checkpoint-every 64`` at 67^2 x 200 steps in each package:
    every checkpoint is the same file."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "input.dat").write_text("67 0.25 0.05 2.0 200 0\n")
    common = ["run", "--dtype", dtype, "--checkpoint-every", "64"]
    assert ref_main([*common, "--backend", "xla",
                     "--checkpoint-dir", "ref"]) == 0
    assert main([*common, "--backend", "torch", "--device", "cpu",
                 "--checkpoint-dir", "port"]) == 0
    names = sorted(p.name for p in (tmp_path / "ref").glob("*.npz"))
    assert names == [f"heat_step{s:08d}.npz" for s in (64, 128, 192)]
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name


@pytest.mark.parametrize("dtype", _DTYPES)
def test_served_npz_is_the_reference_file(tmp_path, dtype):
    """One ghost request served by the JAX engine and by the port's engine
    (the plain lane body): the published npz files are equal."""
    req = dict(n=12, ntime=13, dtype=dtype, bc="ghost", ic="hat",
               bc_value=0.5)
    kw = dict(lanes=2, chunk=4, buckets=(12,), emit_records=False)
    jeng = JEngine(JServeConfig(out_dir=str(tmp_path / "ref"), **kw))
    jeng.submit(JHeatConfig(**req))
    peng = Engine(ServeConfig(out_dir=str(tmp_path / "port"),
                              lane_kernel="torch", **kw), device="cpu")
    peng.submit(HeatConfig(**req))
    assert [r["status"] for r in jeng.results()] == ["ok"]
    assert [r["status"] for r in peng.results()] == ["ok"]
    names = sorted(p.name for p in (tmp_path / "ref").glob("*.npz"))
    assert len(names) == 1
    assert ((tmp_path / "port" / names[0]).read_bytes()
            == (tmp_path / "ref" / names[0]).read_bytes())


def test_bf16_header_is_the_ml_dtypes_one_and_reads_back(tmp_path):
    bits = np.arange(12, dtype=np.uint16).reshape(3, 4) + 0x3F80
    path = tmp_path / "a.npz"
    with open(path, "wb") as f:
        checkpoint.savez_compressed(f, T=bits.view("V2"), step=3)
    with np.load(path) as z:
        assert z["T"].view(np.uint16).tolist() == bits.tolist()
        assert int(z["step"]) == 3
    with zipfile.ZipFile(path) as z:
        assert b"'descr': '<V2'" in z.read("T.npy")[:128]


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def test_every_included_kernel_header_is_shipped():
    data = tomllib.loads((_REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["heat_tpu_torch.ops"]
    csrc = _REPO / "heat_tpu_torch" / "ops" / "csrc"
    sources = sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])
    assert sources
    needed = {f"csrc/{p.name}" for p in sources}
    for src in sources:
        for inc in _INCLUDE.findall(src.read_text()):
            assert (csrc / inc).exists(), (src.name, inc)
            needed.add(f"csrc/{inc}")
    for rel in sorted(needed):
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
