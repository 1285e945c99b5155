"""The port's serve labs on the CPU (second half): the lane-kernel A/B, the
mega-lane, numerics, steady, resume and cache labs, each in process at a
tiny population with ``--device cpu``. Each writes every gate field
``perfcheck`` reads, its bit-identity fields are true, and the labs
without a timing gate on the CPU exit 0.
"""

import torch

from heat_tpu_torch.labs import (numerics_overhead_lab, serve_cache_lab,
                                 serve_lane_kernel_lab, serve_mega_lab,
                                 serve_resume_lab, serve_steady_lab)
from heat_tpu_torch.serve import scheduler as sch
from test_torch_labs import run_lab

torch.set_num_threads(1)


def test_serve_lane_kernel_lab_on_the_cpu(tmp_path):
    """On CPU tensors the ``cuda`` side runs the kernels' plain version:
    bytes equal to the plain lane body, no fallback, no launch, and the
    card gate informational (exit 0)."""
    rc, rec = run_lab(serve_lane_kernel_lab, tmp_path, "--requests", "6")
    assert rc == 0
    assert rec["bit_identical"] is True
    assert rec["solo_sample_identical"] is True
    assert rec["zero_fallbacks"] is True
    assert rec["cuda"]["ok"] == rec["torch"]["ok"] == 6
    assert rec["cuda"]["lane_kernel"] == "cuda"
    assert rec["torch"]["lane_kernel"] == "torch"
    assert {e["kernel"] for e in rec["cuda"]["cost_model"]} == {"cuda"}
    assert {e["kernel"] for e in rec["torch"]["cost_model"]} == {"torch"}
    for side in ("cuda", "torch"):
        assert set(rec[side]["launches"].values()) == {0}
    assert set(rec["solo_cuda"]["launches"].values()) == {0}
    assert {"cuda_vs_torch", "cuda_vs_solo", "cuda_beats_torch"} <= set(rec)


def test_serve_mega_lab_on_the_cpu(tmp_path):
    """Two oversized requests over 8 shards (the ``mega_device_count``
    seam) beside the packed lanes; the seam is restored after."""
    seam = sch.mega_device_count
    _, rec = run_lab(serve_mega_lab, tmp_path, "--requests", "6",
                     "--waves", "1")
    assert sch.mega_device_count is seam
    assert rec["mega_bit_identical"] is True
    assert rec["packed_bit_identical"] is True
    assert rec["zero_overflow_rejections"] is True
    m = rec["mega_resident"]
    assert m["mega_statuses"] == ["ok", "ok"]
    assert m["mega_placements"] == ["mega", "mega"]
    assert m["warm_mega_compiles"] == 0
    assert rec["config"]["devices"] == 8 and rec["config"]["mega_lanes"] == 1
    # no committed record of this population size to compare against
    assert rec["packed_within_10pct_of_serve_lab"] is None


def test_numerics_overhead_lab_on_the_cpu(tmp_path):
    _, rec = run_lab(numerics_overhead_lab, tmp_path, "--requests", "6",
                     "--repeats", "1", "--bit-requests", "3")
    assert rec["bit_identical_depth0"] is True
    assert rec["bit_identical_depth2"] is True
    assert rec["probe_verification_ok"] is True
    assert rec["detector_fires_on_seeded_perturb"] is True
    assert rec["on_violation_total"] == 0 and rec["on_lanes_retired"]
    assert rec["off_observatory_absent"] is True


def test_serve_steady_lab_on_the_cpu(tmp_path):
    _, rec = run_lab(serve_steady_lab, tmp_path, "--requests", "4",
                     "--colanes", "2")
    assert rec["steady_bit_identical"] is True
    assert rec["colane_bit_identical"] is True
    assert rec["zero_added_transfers"] is True
    assert rec["all_population_retired_steady"] is True
    assert rec["steady"]["steady_exits"] == 4
    assert rec["steady"]["host_fetches"] <= rec["fixed"]["host_fetches"]


def test_serve_resume_lab_on_the_cpu(tmp_path):
    """A cut inside the wave: some requests done, some in flight, some
    queued; the merged npz files equal the golden ones as file bytes."""
    rc, rec = run_lab(serve_resume_lab, tmp_path, "--requests", "40")
    assert rc == 0
    assert rec["resumed_bit_identical"] is True
    assert rec["zero_resteps"] is True
    assert rec["resumed_requests_recovered"] is True
    cut = rec["cut"]
    assert 0 < cut["boundaries"] < cut["of_total_boundaries"]
    assert cut["inflight"] + cut["queued"] + cut["done"] == 40
    assert rec["resumed_requests"] == cut["inflight"] + cut["queued"] > 0


def test_serve_cache_lab_on_the_cpu(tmp_path):
    _, rec = run_lab(serve_cache_lab, tmp_path, "--requests", "8",
                     "--distinct", "4")
    assert rec["full_hit_bit_identical"] is True
    assert rec["prefix_delta_exact"] is True
    assert rec["prefix_bit_identical"] is True
    assert rec["cache_off_bit_identical"] is True
    assert rec["warm"]["all_cached"] and rec["warm"]["zero_billed_steps"]
    assert rec["warm"]["cache"]["hits_full"] == 8
    assert rec["prefix"] == {"cached_step": 96, "ntime": 128, "stepped": 32,
                             "steps_saved": 96}
