"""The port's last six labs of ``benchmarks/`` on the CPU, held against the
reference where it defines something.

``chip_check``'s cases are the reference's one for one (the backend
renamed) and all pass on the plain versions; ``ckpt_overlap``'s async and
sync checkpoints are bit-identical and each one loads through the
reference's ``checkpoint.load`` byte-equal to the reference's own run;
``weak_scaling`` and ``sharded3d_check`` pick the reference's meshes, sides
and fuse depths; ``overlap_ab --smoke`` computes one field both ways;
``collective_overhead --smoke`` fits its slopes and depths.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu_torch.labs import (chip_check, ckpt_overlap, collective_overhead,
                                 overlap_ab, sharded3d_check, weak_scaling)

torch.set_num_threads(1)

_BENCH = Path(__file__).resolve().parent.parent / "benchmarks"


def _reference(name):
    """The reference's lab module ``benchmarks/<name>.py``, loaded by path
    (nothing runs at import but its ``sys.path`` set-up)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}",
                                                  _BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_RENAMED = {"xla": "torch", "pallas": "cuda", "sharded": "sharded"}
_CASE_FIELDS = ("n", "ndim", "ntime", "dtype", "bc", "ic", "sigma", "nu",
                "dom_len", "fuse_steps")


def test_chip_check_cases_are_the_references():
    ref = list(_reference("chip_check").cases())
    port = list(chip_check.cases())
    assert len(port) == len(ref) == 23
    for (rname, rcfg, rtol), (pname, pcfg, ptol) in zip(ref, port):
        backend = _RENAMED[rcfg.backend]
        assert pname == rname.replace(f"-{rcfg.backend}-", f"-{backend}-")
        assert pcfg.backend == backend and ptol == rtol
        for f in _CASE_FIELDS:
            assert getattr(pcfg, f) == getattr(rcfg, f), (pname, f)
        if backend == "sharded":
            assert pcfg.mesh_shape == (1, 1)


def test_chip_check_certifies_the_plain_versions(tmp_path):
    out = tmp_path / "chip_check.json"
    assert chip_check.main(["--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["platform"] == "cpu" and rec["bench"] == "chip_check"
    assert rec["passed"] == 23 and rec["failed"] == 0
    assert all(r["ok"] and r["max_abs_err"] < r["tol"] for r in rec["rows"])
    # a CPU run launches nothing: the wrappers ran their plain versions
    assert rec["launches"] == {"ftcs2d": 0, "ftcs3d": 0}


def test_chip_check_records_a_failed_row(monkeypatch):
    from heat_tpu_torch import backends

    real = backends.solve

    def broken(cfg, *a, **kw):
        if cfg.backend == "torch" and cfg.bc == "ghost":
            raise RuntimeError("planted")
        return real(cfg, *a, **kw)

    monkeypatch.setattr(backends, "solve", broken)
    body = chip_check.certify(torch.device("cpu"), echo=lambda s: None)
    bad = [r["name"] for r in body["rows"] if not r["ok"]]
    assert bad == ["2d-torch-ghost-float32-fuse0",
                   "2d-torch-ghost-bfloat16-fuse0"]
    assert body["failed"] == 2
    assert all(r["max_abs_err"] is None for r in body["rows"]
               if not r["ok"])


@pytest.fixture(scope="module")
def ckpt_run(tmp_path_factory):
    """The port's lab at 64^2 x 64 steps, a checkpoint every 16, on the
    torch backend, its checkpoint directories kept."""
    work = tmp_path_factory.mktemp("ckpt_overlap")
    out = work / "ckpt_overlap.json"
    rc = ckpt_overlap.main(["--device", "cpu", "--n", "64", "--steps", "64",
                            "--every", "16", "--repeats", "1", "--work-dir",
                            str(work / "ck"), "--out", str(out)])
    return rc, json.loads(out.read_text()), work / "ck"


def test_ckpt_overlap_record(ckpt_run):
    rc, rec, _ = ckpt_run
    assert rec["bit_identical"] is True
    assert set(rec["rows"]) == {"baseline", "ckpt_sync", "ckpt_async"}
    assert rec["sink_delay_s"] >= 0.005
    assert rec["sync_vs_baseline"] > 1.0
    assert rec["rows"]["ckpt_async"]["io_wait_s"] is not None
    assert rec["field_bytes"] == 64 * 64 * 4
    # the exit code is the reference's verdict (the 10% gate, sync slower,
    # bytes), whichever way the host's walls fall
    want = (rec["async_vs_baseline"] <= 1.10
            and rec["sync_vs_baseline"] > rec["async_vs_baseline"])
    assert rc == (0 if want else 1)


@pytest.mark.parametrize("mode", ["bit_sync", "bit_async"])
def test_ckpt_overlap_checkpoints_load_in_the_reference(ckpt_run, mode,
                                                        tmp_path):
    from heat_tpu.backends import solve as ref_solve
    from heat_tpu.config import HeatConfig as RefConfig
    from heat_tpu.runtime import checkpoint as ref_ckpt

    _, _, ck = ckpt_run
    ref_dir = tmp_path / "ref"
    cfg = RefConfig(n=64, ntime=64, dtype="float32", backend="xla",
                    heartbeat_every=16, checkpoint_every=16,
                    checkpoint_dir=str(ref_dir), async_io="off")
    ref_solve(cfg, fetch=False)
    port_files = sorted((ck / mode).glob("heat_step*.npz"))
    assert [p.name for p in port_files] == sorted(
        p.name for p in ref_dir.glob("heat_step*.npz"))
    assert len(port_files) == 4
    for p in port_files:
        T, step = ref_ckpt.load(p, cfg)
        T_ref, step_ref = ref_ckpt.load(ref_dir / p.name, cfg)
        assert step == step_ref == int(p.stem.replace("heat_step", ""))
        assert T.dtype == T_ref.dtype and T.tobytes() == T_ref.tobytes()


def _reference_weak_rows(monkeypatch):
    """The reference lab's rows under ``--virtual 4`` on conftest's CPU
    devices, its solve replaced by a stub and its record captured."""
    import heat_tpu.backends as ref_backends

    ws = _reference("weak_scaling")

    class _Capture:
        text = None
        parent = property(lambda self: self)

        def __truediv__(self, _):
            return self

        def write_text(self, text):
            self.text = text

    class _Res:
        class timing:
            per_step_s = 1.0

    cap = _Capture()
    monkeypatch.setattr(ws, "Path", lambda *_: cap)
    monkeypatch.setattr(ref_backends, "solve", lambda cfg, **kw: _Res)
    monkeypatch.setattr(sys, "argv", ["weak_scaling.py", "--virtual", "4"])
    monkeypatch.setenv("XLA_FLAGS", "")
    ws.main()
    return json.loads(cap.text)["rows"]


def test_weak_scaling_geometry_is_the_references(monkeypatch, tmp_path):
    ref = {r["devices"]: r for r in _reference_weak_rows(monkeypatch)}
    out = tmp_path / "weak_scaling.json"
    assert weak_scaling.main(["--virtual", "4", "--device", "cpu", "--out",
                              str(out)]) == 0
    rec = json.loads(out.read_text())
    rows = {r["devices"]: r for r in rec["rows"]}
    assert sorted(rows) == [1, 2, 4]
    for d, row in rows.items():
        assert (row["mesh"], row["n"]) == (ref[d]["mesh"], ref[d]["n"]), d
        assert row["shards_on"] == ["cpu"]
        assert math.isfinite(row["weak_efficiency"])
    assert rows[1]["weak_efficiency"] == 1.0
    assert rec["conditions"]["mode"] == "virtual-cpu"
    assert "cannot hold" in rec["conditions"]["note"]
    # the card record's side: hip.dat's 32768^2 on 2x2 at four shards
    assert weak_scaling.geometry(4, 16384) == ((2, 2), 32768)


@pytest.mark.parametrize("n", [40, 64])
def test_sharded3d_check_depths_are_the_references(n, tmp_path):
    from heat_tpu.backends.sharded import fuse_depth_sharded as ref_kf
    from heat_tpu.config import HeatConfig as RefConfig

    out = tmp_path / "s3.json"
    assert sharded3d_check.main(["--device", "cpu", "--n", str(n),
                                 "--steps", "16", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["fuse_steps_requested"] for r in rows] == ["auto", 8, 32]
    for row, fuse in zip(rows, sharded3d_check.FUSES):
        cfg = RefConfig(n=n, ndim=3, ntime=16, dtype="float32",
                        backend="sharded", mesh_shape=(1, 1, 1),
                        sigma=1 / 6, fuse_steps=fuse or 0)
        assert row["kf"] == ref_kf(cfg, (1, 1, 1))
        assert row["padded_shard"] == [n + 2 * row["kf"]] * 3
        assert row["points_per_s_two_point"] > 0


def test_overlap_ab_smoke_computes_one_field(tmp_path):
    out = tmp_path / "overlap_ab_smoke.json"
    assert overlap_ab.main(["--smoke", "--device", "cpu", "--out",
                            str(out)]) == 0
    rec = json.loads(out.read_text())
    assert (rec["n"], rec["steps"]) == (512, 32)
    assert set(rec["rows"]) == {"indep_fuse4", "overlap_fuse4"}
    assert rec["fields_equal"] == {"4": True}
    assert all(r["kf"] == 4 and r["points_per_s_two_point"] > 0
               for r in rec["rows"].values())
    assert rec["overlap_vs_indep"]["4"] > 0


def test_collective_overhead_smoke_fits(tmp_path):
    out = tmp_path / "collective_overhead_smoke.json"
    assert collective_overhead.main(["--smoke", "--device", "cpu", "--out",
                                     str(out)]) == 0
    rec = json.loads(out.read_text())
    for name in ("post_chain", "dispatch_chain"):
        assert sorted(map(int, rec[name]["times_s"])) == list(
            collective_overhead.MS)
        assert math.isfinite(rec[name]["per_stage_s"])
    assert math.isfinite(rec["per_post_dispatch_s"])
    ex = rec["exchange_delta"]
    assert ex["fit_ks"] == [1, 8, 16, 32]
    assert math.isfinite(ex["per_exchange_s"])
    assert math.isfinite(ex["t_step_compute_s"])
    assert len(ex["fit_residuals_s"]) == 4
    assert all(ex[f"fuse_{k}"]["exchange_alone_s"] > 0 for k in ex["fit_ks"])


def test_post_chain_adds_through_the_shard_itself():
    from heat_tpu_torch.parallel.comm import LocalComm
    from heat_tpu_torch.parallel.mesh import RankMesh

    comm = LocalComm(RankMesh((1, 1), periodic=True), "cpu")
    s = torch.zeros((8, 16))
    got = collective_overhead.chain(comm, 4, True)(s)
    assert got is s and torch.equal(s, torch.full((8, 16), 10.0))
    assert comm.stats["bytes"] == 4 * 2 * s.numel() * 4
    plain = collective_overhead.chain(comm, 4, False)(torch.zeros((8, 16)))
    assert np.array_equal(plain.numpy(), s.numpy())
