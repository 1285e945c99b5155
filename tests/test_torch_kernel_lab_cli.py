"""The port's kernel lab and tuning session as programs, on the CPU.

``python -m heat_tpu_torch.labs.kernel_lab`` and ``...labs.tune_on_chip``
run in process through their ``main``: the checks pass on the plain
versions with ``--device cpu``; a bench config that cannot launch is
reported as FAILED with the limit it breaks and the exit code is 1; a bench
on the CPU fails (it times the card); the default device raises on a host
without a card; a session with a failed stage exits 1. The bench's own
plumbing (fields, passes, the bound, the rows) runs at a small size with
the card's timer and device model stood in for.
"""

import pytest
import torch

from heat_tpu_torch.labs import kernel_lab as lab
from heat_tpu_torch.labs import tune_on_chip as tune
from heat_tpu_torch.machine import PEAKS, DeviceModel
from heat_tpu_torch.ops import cuda_lab as cl
from heat_tpu_torch.runtime.timing import TwoPointResult

# One intra-op thread: the suite runs several pytest workers at once.
torch.set_num_threads(1)


@pytest.mark.parametrize("exp", sorted(lab.CHECKS))
def test_checks_pass_on_the_cpu(exp, capsys):
    assert lab.main([exp, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "max err" in out and "FAILED" not in out


def test_a_check_over_its_tolerance_raises(monkeypatch):
    monkeypatch.setattr(lab, "ref_steps", lambda T, r, k: T)   # unstepped
    with pytest.raises(AssertionError, match="ksteps=1: max err .* over 2e-06"):
        lab.main(["check3d", "--device", "cpu"])


@pytest.mark.parametrize("argv,limit", [
    (["bench3d", "8,16,64,8"], "245760 bytes of shared memory"),
    (["bench3d_rolled_var", "fma", "16,16,32,9"], "halo width"),
    (["bench2d", "64,96,33"], "halo width"),
    (["bench2d_rolled_var", "bf16fma", "64,64,16", "--n2", "64"],
     "no compiled tile"),
    (["benchthin", "64", "bfloat16", "shrink,32,192,40"], "halo width"),
])
def test_unlaunchable_bench_config_fails_loudly(argv, limit, capsys):
    rows = []
    assert lab.main(argv + ["--device", "cpu"], results=rows) == 1
    out = capsys.readouterr().out
    assert f"FAILED ValueError" in out and limit in out
    assert len(rows) == 1 and limit in rows[0]["failed"]


def test_bench_on_the_cpu_fails(capsys):
    rows = []
    assert lab.main(["bench2d", "--device", "cpu"], results=rows) == 1
    assert "a bench times the card" in rows[0]["failed"]
    n = len(lab.DEFAULT_2D)  # both 2D designs, each refused on the CPU
    assert n == 2 and all("a bench times the card" in r["failed"]
                          for r in rows)
    assert f"{n} of {n} configs FAILED" in capsys.readouterr().out


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lab.main(["check3d"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tune.main(["lab3d"])


@pytest.mark.parametrize("argv", [
    ["nosuch"], ["check3d", "extra"], ["bench3d_rolled_var", "bf16"],
    ["bench2d_rolled_var", "f32", "--n2", "0"], ["benchthin", "64"],
    ["benchthin", "64", "float32", "shrink,64,96"], ["bench3d", "16,16,8"],
    ["framework", "2d1"], ["check3d", "--device"]])
def test_usage_errors(argv):
    with pytest.raises(SystemExit):
        lab.main(argv + (["--device", "cpu"] if argv[-1] != "--device"
                         else []))


def _fake_card(monkeypatch):
    """The card's timer and device model stood in for, so a bench's
    plumbing runs on CPU tensors (the wrappers run the plain versions)."""
    calls = []

    def rate(call, x, work, repeats=2):
        x = call(x)
        calls.append(work)
        return TwoPointResult(work / 2e-3, work / 3e-3, fell_back=False)

    monkeypatch.setattr(lab, "_require_card", lambda device: None)
    monkeypatch.setattr(lab, "two_point_rate", rate)
    monkeypatch.setattr(lab, "device_model", lambda device: DeviceModel(
        "NVIDIA H100 80GB HBM3", 132, 232448, None, 80 << 30, PEAKS["H100"]))
    monkeypatch.setattr(lab.cs, "_launch", lambda T, r, k, bounds, out:
                        out.copy_(lab.cs.ftcs_multistep_2d_plain(T, r, k)
                                  if T.dim() == 2 else
                                  lab.cs.ftcs_multistep_3d_plain(T, r, k)))
    return calls


def test_bench_rows_carry_the_bound_and_the_shipped_kernel(monkeypatch,
                                                           capsys):
    calls = _fake_card(monkeypatch)
    rows = []
    lab.bench_3d([((16, 16, 32), 4)], torch.device("cpu"), rows, n3=12,
                 steps=8, variant="fma")
    lab.bench_2d([((64, 96), 4), ((32, 192), 33)], torch.device("cpu"),
                 rows, n2=20, dtype="bfloat16", steps=8)
    lab.bench_thin2d_variants(20, "float32", [("bf16native", (64, 96), 5)],
                              torch.device("cpu"), rows, steps=12)
    out = capsys.readouterr().out
    ok = [r for r in rows if not r["failed"]]
    assert [r["failed"] is None for r in rows] == [True, True, False, True]
    assert len(calls) == 2 * len(ok)       # the candidate and the shipped
    r3 = rows[0]
    assert r3["shape"] == (12, 12, 12) and r3["k"] == 4
    # 2 passes of 4 steps over 12^3 points in 2 ms: 1 ms per pass
    assert r3["ms"] == pytest.approx(1.0) and r3["shipped_ms"] == pytest.approx(1.0)
    bytes_s = 2 * 4 * 12 ** 3 / 3.35e12
    ops_s = 8 * 12 ** 3 * 4 / 67e12        # L2 fma: 8 operations
    assert r3["bound_ms"] == pytest.approx(max(bytes_s, ops_s) * 1e3)
    assert r3["bound_by"] == "bytes"
    assert rows[1]["shape"] == (20, 20) and rows[1]["dtype"] == "bfloat16"
    assert rows[3]["shape"] == (20, 20) and rows[3]["k"] == 5
    assert "shipped ftcs3d" in out and "shipped ftcs2d" in out


def test_framework_bench_uses_the_reference_passes(monkeypatch, capsys):
    _fake_card(monkeypatch)
    rows = []
    lab.bench_framework([("2d 40^2 f32", (40, 40), "float32", 16, 32),
                         ("3d 20^3 bf16", (20, 20, 20), "bfloat16", 8, 8)],
                        torch.device("cpu"), rows)
    assert all(r["failed"] is None for r in rows)
    assert rows[0]["plan"] == [16] and sum(rows[1]["plan"]) == 8
    assert "passes=" in capsys.readouterr().out


def test_tune_session_exits_nonzero_on_a_failed_stage(monkeypatch, capsys):
    assert tune.main(["lab3d", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    n = len(tune.LAB3D)  # every config of the stage (both 3D designs)
    assert f"stage lab3d FAILED: {n} of {n} configs" in out

    def boom(*a, **k):
        raise RuntimeError("out of memory")

    def fine(*a, **k):
        return [dict(failed=None)]

    monkeypatch.setattr(lab, "bench_2d", boom)
    for name in ("bench_3d", "bench_thin2d_variants", "bench_framework"):
        monkeypatch.setattr(lab, name, fine)
    assert tune.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "stage lab2d FAILED: RuntimeError: out of memory" in out
    assert "=== stage thin" in out                 # the next stage ran
    assert "FAILED stages: lab2d" in out
    assert tune.main(["framework:2d4096", "thin", "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        tune.main(["framework:nosuch", "--device", "cpu"])


def test_tune_stage_configs_launch():
    """Every Hopper config of the session's stages names a compiled tile at
    a depth it can take (the (8, 16, 64) tile fits up to 7 steps)."""
    for block, k in tune.LAB3D:
        assert cl.check_launch(3, block, k) == block
    for block, k in tune.LAB2D:
        assert cl.check_launch(2, block, k) == block
    for variant, block, k in tune.THIN:
        assert ("lab_thin2d_variant", variant) in cl.FORMS
        assert cl.check_launch(2, block, k) == block
    assert set(tune.FRAMEWORK) == set(lab.FRAMEWORK_CASES)
