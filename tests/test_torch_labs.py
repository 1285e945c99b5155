"""The port's serve labs on the CPU (first half) and the pieces they share.

The populations every lab draws from are the JAX package's serve lab's,
held here as literal lists; every lab refuses to run without a card unless
``--device cpu`` is given, and the lane-kernel build check refuses the CPU
outright; the build check's ptxas parsing and its one-chunk launch (on the
CPU, the plain body on both sides) are held here too. Then five of the
eleven serve labs run in process at a tiny population: each writes every
gate field ``perfcheck`` reads, and its bit-identity fields are true.
Timing gates are measurements on a shared host, so a lab's exit code is
only held to be 0 or 1 (1: a timing gate missed).
"""

import json

import pytest
import torch

from heat_tpu_torch.cli import PERFCHECK_GATES
from heat_tpu_torch.ops import _build
from heat_tpu_torch.labs import (_util, fleet_lab, lane_kernel_build_check,
                                 numerics_overhead_lab, prof_overhead_lab,
                                 serve_cache_lab, serve_chaos_lab,
                                 serve_frontend_lab, serve_lab,
                                 serve_lane_kernel_lab, serve_mega_lab,
                                 serve_resume_lab, serve_steady_lab,
                                 trace_overhead_lab)

torch.set_num_threads(1)

SERVE_LABS = (serve_lab, trace_overhead_lab, prof_overhead_lab,
              serve_chaos_lab, serve_frontend_lab, serve_lane_kernel_lab,
              serve_mega_lab, numerics_overhead_lab, serve_steady_lab,
              serve_resume_lab, serve_cache_lab)

# the JAX package's serve lab population: (n, ntime, dtype, bc, ic, nu)
SERVE_LAB_8 = [
    (24, 96, "float64", "edges", "hat", 0.05),
    (32, 112, "float64", "edges", "hat_small", 0.05),
    (48, 128, "float64", "edges", "hat", 0.05),
    (24, 96, "float64", "edges", "hat_small", 0.1),
    (32, 112, "float64", "edges", "hat", 0.1),
    (48, 128, "float64", "edges", "hat_small", 0.1),
    (24, 96, "float64", "edges", "hat", 0.05),
    (32, 112, "float64", "edges", "hat_small", 0.05),
]
# its two oversized requests: (n, ntime, dtype, bc, ic)
OVERSIZED = [(96, 32, "float64", "edges", "hat"),
             (96, 16, "float64", "ghost", "uniform")]
# the steady lab's population and co-lanes: (n, ntime, ic)
STEADY_4 = [(24, 512, "sine"), (32, 512, "sine"), (24, 512, "sine"),
            (32, 512, "sine")]
COLANES_3 = [(24, 96, "hat"), (32, 112, "hat_small"), (24, 96, "hat")]
# the cache lab's wave at 5 requests over 3 distinct configs:
# (n, ntime, ic, nu)
CACHE_5_3 = [(24, 96, "hat", 0.05), (32, 112, "sine", 0.06),
             (48, 96, "hat", 0.07), (24, 96, "hat", 0.05),
             (32, 112, "sine", 0.06)]


def _row(c):
    return (c.n, c.ntime, c.dtype, c.bc, c.ic, c.nu)


def test_serve_lab_population_is_the_reference_population():
    got = _util.build_requests(8)
    assert [_row(c) for c in got] == SERVE_LAB_8
    assert all(c.ndim == 2 and c.sigma == 0.25 and c.backend == "torch"
               for c in got)
    f32 = _util.build_requests(8, dtype="float32")
    assert [_row(c) for c in f32] == [r[:2] + ("float32",) + r[3:]
                                      for r in SERVE_LAB_8]
    assert [_row(c)[:5] for c in _util.build_oversized()] == OVERSIZED


def test_lab_populations_are_the_reference_labs():
    clean, chaos, poisoned = serve_chaos_lab.build_waves(20)
    assert poisoned == [9, 19]
    assert [_row(c) for c in clean[:8]] == SERVE_LAB_8
    assert [c.inject for c in chaos] == [
        "lane-nan@40" if i in (9, 19) else "" for i in range(20)]
    assert [(c.n, c.ntime, c.ic) for c in
            serve_steady_lab.build_population(4)] == STEADY_4
    assert all(c.dtype == "float64" and c.bc == "edges"
               for c in serve_steady_lab.build_population(4))
    assert [(c.n, c.ntime, c.ic) for c in
            serve_steady_lab.build_colanes(3)] == COLANES_3
    wave = serve_cache_lab.build_wave(5, 3)
    assert [(c.n, c.ntime, c.ic, c.nu) for c in wave] == [
        (n, t, ic, pytest.approx(nu)) for n, t, ic, nu in CACHE_5_3]
    # the fleet lab's request lines carry the same population
    assert [(d["n"], d["ntime"], d["dtype"], d["bc"], d["ic"], d["nu"])
            for d in fleet_lab.build_requests(8)] == SERVE_LAB_8


@pytest.mark.parametrize("lab", SERVE_LABS, ids=lambda m: m.__name__
                         .rsplit(".", 1)[1])
def test_every_lab_defaults_to_the_card(lab, tmp_path):
    """Without ``--device cpu`` a lab runs on the card: on a host without
    one it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lab.main(["--requests", "1", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_build_check_refuses_the_cpu(tmp_path):
    out = tmp_path / "x.json"
    with pytest.raises(SystemExit, match="no CPU form"):
        lane_kernel_build_check.main(["--device", "cpu", "--out", str(out)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lane_kernel_build_check.main(["--out", str(out)])
    assert not out.exists()


PTXAS_LOG = """nvcc -O3 ...
ptxas info    : Compiling entry function '_Z21lanes2d_stream_kernelIfLi8EEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z21lanes2d_stream_kernelIfLi8EEvPKT_
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 72 registers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_Z21lanes2d_stream_kernelI13__nv_bfloat16Li8EEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z21lanes2d_stream_kernelI13__nv_bfloat16Li8EEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_Z21lanes2d_stream_kernelIfLi4EEvPKT_' for 'sm_90a'
ptxas info    : Used 40 registers, 464 bytes cmem[0]
"""


def test_build_check_reads_registers_and_spills_per_instance():
    report = _build.ptxas_report(PTXAS_LOG)
    assert [r[1:] for r in report] == [(72, 8, 12), (64, 0, 0), (40, 0, 0)]
    f32 = lane_kernel_build_check.instances(report, "lanes2d", "float32",
                                            [8, 8])
    assert list(f32) == ["k=8"]
    assert (f32["k=8"]["registers"], f32["k=8"]["spill_stores"],
            f32["k=8"]["spill_loads"]) == (72, 8, 12)
    bf16 = lane_kernel_build_check.instances(report, "lanes2d", "bfloat16",
                                             [8])
    assert bf16["k=8"]["registers"] == 64
    tail = lane_kernel_build_check.instances(report, "lanes2d", "float32",
                                             [4])
    assert tail["k=4"]["registers"] == 40
    assert lane_kernel_build_check.instances(report, "lanes3d", "float32",
                                             [4]) == {}


@pytest.mark.parametrize("variant", lane_kernel_build_check.VARIANTS,
                         ids=lambda v: v[0])
def test_build_check_chunk_runs_to_the_end_on_the_cpu(variant):
    """The check's one chunk, on CPU tensors (the ``cuda`` wrappers' plain
    version on both sides): every countdown at 0, every finite bit set,
    every lane's bytes equal, no kernel launched."""
    _, ndim, bucket, dtype, bc, lanes, chunk, donate = variant
    launched, remaining, finite, same = lane_kernel_build_check.\
        launch_variant(ndim, bucket, dtype, bc, lanes, chunk, donate,
                       torch.device("cpu"), seed=0)
    assert remaining == [0] * lanes and finite == [1] * lanes and same
    assert launched == {"lanes2d": 0, "lanes3d": 0}


def test_stamp_names_the_platform_and_the_sources():
    s = _util.stamp("cpu")
    assert s["platform"] == "cpu" and s["card"] is None
    assert len(s["source_sha256"]) == 64
    assert s["source_sha256"] == _util.source_sha256()
    assert s["torch"] == torch.__version__


# the fields perfcheck reads from the baseline (and a fresh)
# prof_overhead_lab record
BASELINE_FIELDS = ("on_within_2pct_of_off", "on_overhead_frac",
                   "bit_identical_depth0", "bit_identical_depth2",
                   "usage_reconciles", "cost_model", "on", "platform")


def run_lab(lab, tmp_path, *argv):
    """``lab.main`` in process with ``--device cpu``; returns (rc, record),
    after checking that the record carries every gate field perfcheck
    reads from it."""
    name = lab.__name__.rsplit(".", 1)[1]
    out = tmp_path / f"{name}.json"
    rc = lab.main([*argv, "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc in (0, 1)
    assert rec["bench"] == name and rec["platform"] == "cpu"
    assert rec["card"] is None and "commit" in rec
    fields = (BASELINE_FIELDS if name == "prof_overhead_lab" else
              [f for f, _ in dict(PERFCHECK_GATES)[f"{name}.json"]])
    missing = [f for f in fields if f not in rec]
    assert not missing, missing
    return rc, rec


def test_serve_lab_on_the_cpu(tmp_path):
    _, rec = run_lab(serve_lab, tmp_path, "--requests", "6")
    assert rec["bit_identical_sample"] is True
    assert rec["one_compile_per_bucket_lane_tier"] is True
    assert rec["engine"]["ok"] == rec["engine_sync"]["ok"] == 6
    assert rec["engine"]["step_compiles"] == 0
    # one device: the two oversized requests are rejected with the hint
    assert rec["oversized"]["expected"] == "rejected"
    assert rec["oversized"]["statuses"] == ["rejected"] * 4
    assert rec["oversized"]["hint_present"] is True
    assert rec["engine"]["dispatch_depth"] == 2
    assert rec["engine_sync"]["dispatch_depth"] == 0


def test_trace_overhead_lab_on_the_cpu(tmp_path):
    _, rec = run_lab(trace_overhead_lab, tmp_path, "--requests", "6",
                     "--repeats", "1")
    assert rec["trace_export_nonempty"] is True
    assert rec["off"]["events"] == 0 < rec["full"]["events"]
    assert all(rec[m]["ok"] == 6 for m in ("off", "flightrec", "full"))


def test_prof_overhead_lab_on_the_cpu(tmp_path):
    _, rec = run_lab(prof_overhead_lab, tmp_path, "--requests", "6",
                     "--repeats", "1", "--bit-requests", "3")
    assert rec["bit_identical_depth0"] is True
    assert rec["bit_identical_depth2"] is True
    assert rec["usage_reconciles"] is True
    assert rec["cost_model_off_empty"] is True
    assert {e["kernel"] for e in rec["cost_model"]} == {"torch"}
    assert {e["bucket"] for e in rec["cost_model"]} == {
        "2d/n32/float64/edges", "2d/n48/float64/edges"}


def test_serve_chaos_lab_on_the_cpu(tmp_path):
    _, rec = run_lab(serve_chaos_lab, tmp_path, "--requests", "10")
    assert rec["config"]["poisoned"] == 1
    assert rec["bit_identical_healthy_sample"] is True
    assert rec["all_poisoned_quarantined"] is True
    assert rec["all_healthy_ok"] is True
    assert rec["chaos"]["lanes_quarantined"] == rec["chaos"]["nonfinite"] == 1


def test_serve_frontend_lab_on_the_cpu(tmp_path):
    """The schema and the gate field, not a rate: which policy meets more
    deadlines depends on the host's clock."""
    _, rec = run_lab(serve_frontend_lab, tmp_path, "--requests", "6")
    assert rec["offline_drain"]["ok"] == 6
    # no committed record of this population size to compare against
    assert rec["offline_drain"]["vs_serve_lab_engine"] is None
    for side in ("online_fifo", "online_edf"):
        r = rec[side]
        assert sum(r["statuses"].values()) == 6
        assert r["deadline_carrying"] == 3
        assert 0 <= r["deadline_hit_rate"] <= 1
    assert isinstance(rec["edf_vs_fifo_hit_rate_delta"], float)
