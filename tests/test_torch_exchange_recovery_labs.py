"""The port's exchange and recovery labs on the CPU.

``exchange_lab`` at a small n: each exchange form leaves the padded shard
as the shipped exchange does (the ``concat`` rebuild against the in-place
slab writes, bytes), the record carries every row of the reference's lab
(``donate`` with the reason it is not run), and the padded-carry rows run
the ``sharded`` backend. ``recovery_lab`` runs its two ``launch -n 2``
worlds on gloo: the crashed world restarts and its final field is the
clean one's, byte for byte. Both refuse to run without a card unless
``--device cpu`` is given.
"""

import json

import numpy as np
import pytest
import torch

from heat_tpu_torch.labs import exchange_lab, recovery_lab
from heat_tpu_torch.parallel.comm import LocalComm
from heat_tpu_torch.parallel.mesh import build_mesh

torch.set_num_threads(1)


@pytest.mark.parametrize("staged", [False, True])
def test_concat_exchange_is_the_slab_exchange(staged):
    w = 3
    rng = np.random.default_rng(0)
    padded = torch.from_numpy(rng.random((20 + 2 * w, 20 + 2 * w),
                                         dtype=np.float32))
    comm = LocalComm(build_mesh(2, 1, (1, 1)), "cpu", staged=staged)
    cat = exchange_lab.concat_exchange(comm, 2.0, w)(padded.clone())
    slab = exchange_lab.slab_exchange(comm, 2.0, w)(padded.clone())
    assert torch.equal(cat, slab)
    assert torch.equal(slab[w:-w, w:-w], padded[w:-w, w:-w])
    assert (slab[:w] == 2.0).all() and (slab[:, -w:] == 2.0).all()


def test_exchange_lab_writes_its_record(tmp_path):
    out = tmp_path / "exchange_lab.json"
    assert exchange_lab.main(["--device", "cpu", "--n", "32", "--repeats",
                              "2", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["platform"] == "cpu" and rec["n"] == 32 and rec["w"] == 8
    rows = rec["variants"]
    assert set(rows) == {
        "slab", "slab_staged", "concat", "donate",
        "real_advance_seq_fuse1", "real_advance_seq_fuse8",
        "real_advance_indep_fuse1", "real_advance_indep_fuse8",
        "real_advance_overlap_fuse8"}
    assert "in place" in rows["donate"]["skipped"]
    for name in ("slab", "slab_staged", "concat"):
        assert rows[name]["per_exchange_s"] > 0
        assert rows[name]["allocated_bytes_per_exchange"] is None  # no card
    for name, row in rows.items():
        if name.startswith("real_advance"):
            assert row["per_step_s"] > 0 and row["kf"] in (1, 8)
    assert rows["real_advance_overlap_fuse8"]["local_kernel"] == "cuda"


def test_recovery_lab_heals_bit_identically(tmp_path):
    out = tmp_path / "recovery_lab.json"
    assert recovery_lab.main(["--device", "cpu", "--n", "32", "--steps",
                              "16", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["bit_identical_final_field"] is True
    assert rec["uninterrupted"]["rc"] == 0 and rec["crash_resume"]["rc"] == 0
    assert not rec["uninterrupted"]["restarts"]
    (restart,) = rec["crash_resume"]["restarts"]
    assert restart["event"] == "launch_restart"
    assert rec["config"] == {"n": 32, "steps": 16, "checkpoint_every": 2,
                             "crash_at": 8, "processes": 2, "mesh": "2x1",
                             "dtype": "float64", "comm": "staged",
                             "device": "cpu"}
    assert rec["recovery_overhead_s"] is not None


@pytest.mark.parametrize("lab", [exchange_lab, recovery_lab])
def test_labs_refuse_a_missing_card(lab, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lab.main(["--out", "/nonexistent/x.json"])
