"""``audit``, the program auditor of the port, on the CPU: every family
dispatched with its plain versions holds every contract, and each contract
fails on a seeded violation (a host sync in a dispatch, a snapshot that
aliases what the next chunk writes, an f64 promotion, a launch budget
overshoot). The card's run is ``tests/test_torch_card.py``'s."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from heat_tpu_torch.analysis import programs as P
from heat_tpu_torch.cli import main

REPO = Path(__file__).resolve().parent.parent


def test_audit_on_the_cpu_is_clean():
    vs, report = P.audit(device="cpu")
    assert vs == [], [v.format() for v in vs]
    assert report["dispatched"] == report["families"] >= 19
    fams = {v["family"] for v in report["programs"].values()}
    assert fams == {"solo", "lane", "loader", "mega"}
    kernels = {k for v in report["programs"].values() for k in v["kernels"]}
    assert kernels == {"ftcs2d", "ftcs3d", "lanes2d", "lanes3d"}
    dtypes = {v["dtype"] for v in report["programs"].values()}
    assert dtypes == {"float64", "float32", "bfloat16"}
    # plain versions on the CPU: no kernel launched
    assert all(not v["launches"] for v in report["programs"].values())
    b = report["budget"]
    assert b["declared"] == b["enumerated"]["total"] > 0


def test_audit_cli_on_the_cpu(capsys, tmp_path):
    assert main(["audit", "--device", "cpu"]) == 0
    assert "OK" in capsys.readouterr().out
    assert main(["audit", "--device", "cpu", "--json", "--fast"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["contracts"] == list(P.FAST_CONTRACTS)
    assert report["violation_list"] == []
    assert main(["audit", "--list-contracts"]) == 0
    out = capsys.readouterr().out
    assert all(c in out for c in P.CONTRACTS)
    assert main(["audit", "--device", "cpu", "--fast",
                 "--contracts", "program-sync"]) == 2
    assert main(["audit", "--device", "cpu",
                 "--contracts", "program-digest"]) == 2
    # a budget registry elsewhere: rewritten, then gated
    reg = tmp_path / "launches.json"
    assert main(["audit", "--device", "cpu", "--contracts",
                 "launch-budget", "--update-digests", "--registry",
                 str(reg)]) == 0
    assert json.loads(reg.read_text())["launch_budget"]["max_launch_keys"] \
        == P.enumerate_launch_keys()["total"]


def test_audit_without_a_card_raises():
    """The default device is the card: on a host without one the audit
    fails instead of dropping to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch", "audit"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_committed_budget_matches_the_default_config():
    reg = P.load_registry(P.default_registry_path())
    assert reg["launch_budget"]["key_dims"] == list(P.LAUNCH_KEY_DIMS)
    assert reg["launch_budget"]["max_launch_keys"] == \
        P.enumerate_launch_keys()["total"]
    assert reg["compiled"] == P.compiled_depths() == {
        "lanes2d": 16, "lanes3d": 8, "ftcs2d": 32, "ftcs3d": 8}


# --- seeded violations ---------------------------------------------------------

class _Seeded(P.Program):
    """A tiny family whose dispatch does what the test asks."""

    def __init__(self, dispatch, snapshot=None, dtype=torch.float32):
        self.T = torch.zeros(8, 8, dtype=dtype)
        self.spare = torch.zeros_like(self.T)
        self._dispatch = dispatch
        self._snapshot = snapshot
        self.field_nbytes = self.T.numel() * self.T.element_size()

    def dispatch(self):
        self._dispatch(self)

    def held(self):
        return {"fields": self.T, "spare": self.spare}

    def written(self):
        return {"fields": self.T}

    def buffers(self):
        return frozenset(P._ptr(t) for t in (self.T, self.spare))

    def snapshot(self):
        return None if self._snapshot is None else self._snapshot(self)


def _swap(p):
    p.T, p.spare = torch.add(p.T, 1, out=p.spare), p.T


def _spec(name, prog, **kw):
    return P.ProgramSpec(name, lambda dev: prog, **kw)


def _violations(spec):
    vs, _ = P.audit(device="cpu", specs=[spec],
                    contracts=["program-sync", "program-aliasing",
                               "program-dtype"])
    return vs


def test_a_clean_seeded_family_passes():
    spec = _spec("clean", _Seeded(_swap), double_buffer=True)
    assert _violations(spec) == []


@pytest.mark.parametrize("sync", ["item", "cpu", "numpy", "tolist",
                                  "host_fetch"])
def test_a_sync_in_the_dispatch_fails_program_sync(sync):
    def dispatch(p):
        _swap(p)
        if sync == "host_fetch":
            from heat_tpu_torch.serve import engine
            engine.host_fetch(p.T)
        else:
            getattr(p.T.sum(), sync)()

    vs = _violations(_spec(f"sync-{sync}", _Seeded(dispatch),
                           double_buffer=True))
    assert [v.rule for v in vs] == ["program-sync"]
    assert sync in vs[0].message


def test_an_aliasing_snapshot_fails_program_aliasing():
    # the snapshot is the live stack, and the chunk writes it in place
    def dispatch(p):
        p.T.add_(1)

    vs = _violations(_spec("alias", _Seeded(dispatch,
                                            snapshot=lambda p: [p.T]),
                           rollback=True))
    assert {v.rule for v in vs} == {"program-aliasing"}
    msgs = " ".join(v.message for v in vs)
    assert "shares storage" in msgs and "restorable cells" in msgs


def test_a_fresh_buffer_per_chunk_fails_program_aliasing():
    def dispatch(p):
        p.T = p.T + 1             # a new tensor a chunk, not a swap

    vs = _violations(_spec("fresh", _Seeded(dispatch), double_buffer=True))
    assert [v.rule for v in vs] == ["program-aliasing"]


def test_an_f64_promotion_fails_program_dtype():
    def dispatch(p):
        p.T = p.T.double() * 0.5  # an unpinned promotion

    vs = _violations(_spec("promote", _Seeded(dispatch)))
    assert {v.rule for v in vs} == {"program-dtype"}
    assert any("silent f64 promotion" in v.message for v in vs)
    # and an f64 family that lost its dtype
    vs = _violations(_spec("lost", _Seeded(_swap), dtype="float64"))
    assert any("holds no float64" in v.message for v in vs)


def test_a_budget_overshoot_fails_launch_budget():
    reg = {"launch_budget": {"key_dims": list(P.LAUNCH_KEY_DIMS),
                             "max_launch_keys": 3}}
    keys = P.launch_keys()
    vs = P.check_launch_budget(reg, keys=keys)
    assert [v.rule for v in vs] == ["launch-budget"]
    assert "exceeds the declared budget (3)" in vs[0].message
    # a key no compiled instance serves, and a changed dimension
    vs = P.check_launch_budget(
        {"launch_budget": {"key_dims": ["kernel"], "max_launch_keys": 99}},
        keys={("lanes2d", 2, 64, "float32", "edges", 2, 17)})
    msgs = [v.message for v in vs]
    assert any("dimensions changed" in m for m in msgs)
    assert any("not an instance _build compiles" in m for m in msgs)
    assert P.check_launch_budget(None, keys=set())[0].message.startswith(
        "no declared launch budget")


def test_launch_keys_follow_the_config():
    from heat_tpu_torch.serve import ServeConfig

    small = P.launch_keys(ServeConfig(buckets=(64,), lanes=2, chunk=16))
    # 2 ndims x 2 kernel dtypes x 2 bcs x tiers {1, 2} x depths of the
    # chunk (16: 8+8 in 2D, 4x4 in 3D) and the tail (4)
    assert {k[-1] for k in small if k[0] == "lanes2d"} == {8, 4}
    assert {k[-1] for k in small if k[0] == "lanes3d"} == {4}
    assert {k[3] for k in small} == {"float32", "bfloat16"}
    assert not P.launch_keys(ServeConfig(lane_kernel="torch"))
