"""heat_tpu_torch.calibrate and the planner's chip model against heat_tpu's.

The port's fit must be the reference's float for float: it bisects the
planner's own cost functions (``pass_schedule.cost_thin_2d`` / ``cost_3d``,
copies of ``pallas_stencil``'s), so synthetic per-point times made from the
reference's model at known rates must invert to the same floats in both
packages. A calibration record moves the planner's cuts in f32 and bf16
alike, as the reference's ``machine.current()`` does: under one file that
both packages read, the port's plans, passes and bf16 bytes are the
reference's. The refusals of the reference's ``run`` (a floor-fallback
stream, an overhead-dominated stencil rate) hold in the port's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from heat_tpu import calibrate as ref_cal
from heat_tpu import machine as ref_machine
from heat_tpu.backends import solve as ref_solve
from heat_tpu.config import HeatConfig as RefConfig
from heat_tpu.ops import pallas_stencil as ps
from heat_tpu_torch import calibrate, cli, machine
from heat_tpu_torch.backends import solve
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.ops import pass_schedule

torch.set_num_threads(1)

# the shape grid of tests/test_torch_pass_schedule.py
_SHAPES_2D = [(67, 130), (100, 500), (4096, 4096), (64, 8320), (32768, 32768)]
_SHAPES_3D = [(24, 24, 24), (40, 33, 130), (256, 256, 256), (512, 512, 512),
              (514, 514, 514), (1024, 1024, 1024), (4, 4, 40000)]

# an H100-like fit: every rate moved from the reference's off-TPU table
_SYNTHETIC = dict(name="synthetic", hbm_bytes_per_s=3.0e12,
                  vpu_ops_per_s=3.2e13, ops_rate_3d=1.5e13, calibrated=True)


@pytest.fixture
def fresh_models(monkeypatch):
    """Both packages' chip models re-read from the environment before and
    after the test (planner caches flushed)."""
    monkeypatch.delenv("HEAT_CHIP_CALIBRATION", raising=False)
    ref_machine.override(None)
    machine.override(None)
    yield
    monkeypatch.delenv("HEAT_CHIP_CALIBRATION", raising=False)
    ref_machine.override(None)
    machine.override(None)


@pytest.fixture
def shared_calibration(tmp_path, monkeypatch, fresh_models):
    """A synthetic calibration record that both packages load through
    ``HEAT_CHIP_CALIBRATION``."""
    rec = {"trustworthy": True, "platform": "cuda",
           "chip_model": dataclasses.asdict(dataclasses.replace(
               ref_machine._DEFAULT, **_SYNTHETIC))}
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(rec))
    monkeypatch.setenv("HEAT_CHIP_CALIBRATION", str(path))
    ref_machine.override(None)
    machine.override(None)
    return path


def _ref_passes(shape, dt, ksteps):
    """The cuts of the reference's ``_multistep`` (pallas_stencil.py:718)."""
    if len(shape) == 2:
        plan = ps._plan_2d(shape, dt, ksteps)
        chunk = (ps._thin_chunk_cap(ps._round_up(max(shape[1], 128), 128), dt)
                 if plan[0] == "thin" else plan[-1])
    else:
        plan = ps._plan_3d(shape, dt, ksteps)
        if plan is None:
            return None
        chunk = plan[-1]
    full, rem = divmod(ksteps, chunk)
    return [chunk] * full + ([rem] if rem else [])


def test_default_is_the_references_off_tpu_table(fresh_models):
    assert (dataclasses.asdict(machine.DEFAULT)
            == dataclasses.asdict(ref_machine._DEFAULT))
    assert machine.current() == machine.DEFAULT
    assert ref_machine.current() == ref_machine._DEFAULT


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _SHAPES_2D)
def test_fit_vpu_2d_is_the_references(fresh_models, shape, dt):
    chip = ref_machine._DEFAULT
    n_pad = ps._round_up(max(shape[1], 128), 128)
    for true_vpu in (1.7e12, 3.2e13):
        plan = ps._plan_2d(shape, dt, 16)
        assert pass_schedule.plan_2d(shape, dt, 16) == plan
        k = plan[1] if plan[0] == "thin" else plan[-1]
        t_pp = ps.cost_thin_2d(n_pad, k, dt, dataclasses.replace(
            chip, vpu_ops_per_s=true_vpu))
        assert pass_schedule.cost_thin_2d(
            n_pad, k, dt, dataclasses.replace(
                machine.DEFAULT, vpu_ops_per_s=true_vpu)) == t_pp
        want = ref_cal.fit_vpu_2d(t_pp, shape, dt, 16, chip)
        got = calibrate.fit_vpu_2d(t_pp, shape, dt, 16, machine.DEFAULT)
        assert got == want
        if plan[0] == "thin":
            assert got == pytest.approx(true_vpu, rel=1e-6)
        else:
            assert got is None


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _SHAPES_3D)
def test_fit_ops_3d_is_the_references(fresh_models, shape, dt):
    chip = ref_machine._DEFAULT
    plan = ps._plan_3d(shape, dt, 8)
    assert pass_schedule.plan_3d(shape, dt, 8) == plan
    if plan is None:
        assert calibrate.fit_ops_3d(1e-12, shape, dt, 8,
                                    machine.DEFAULT) is None
        return
    (m_pad, mid_pad, _), R, M, k = plan
    pad = m_pad * mid_pad / (shape[0] * shape[1])
    for true_rate in (3.1e12, 1.5e13):
        t_pp = ps.cost_3d(R, M, k, dt, dataclasses.replace(
            chip, ops_rate_3d=true_rate)) * pad
        assert pass_schedule.cost_3d(R, M, k, dt, dataclasses.replace(
            machine.DEFAULT, ops_rate_3d=true_rate)) * pad == t_pp
        want = ref_cal.fit_ops_3d(t_pp, shape, dt, 8, chip)
        got = calibrate.fit_ops_3d(t_pp, shape, dt, 8, machine.DEFAULT)
        assert got == want
        assert got == pytest.approx(true_rate, rel=1e-6)


@pytest.mark.parametrize("t_pp", [1e-30, 1e-13, 5.6e-13, 3e-12, 1.0])
def test_invert_rate_is_the_references(t_pp):
    def cost(v):
        return 11.0 * 1.25 / v + 2.5e-13

    assert calibrate._invert_rate(cost, t_pp) == ref_cal._invert_rate(cost,
                                                                      t_pp)


def test_fit_refuses_impossible_measurement(fresh_models):
    assert calibrate.fit_vpu_2d(1e-30, (4096, 4096), "float32", 16,
                                machine.DEFAULT) is None
    assert calibrate.fit_ops_3d(1e-30, (512, 512, 512), "float32", 8,
                                machine.DEFAULT) is None


def _pretend_card(monkeypatch):
    """The run's device, name and stamp of a card, on the CPU (the sweeps
    themselves are stubbed by the caller)."""
    import heat_tpu_torch.backends as backends
    import heat_tpu_torch.labs._util as util

    monkeypatch.setattr(backends, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(util, "stamp", lambda device: {
        "platform": "cuda", "card": {"name": "NVIDIA H100 80GB HBM3",
                                     "smi": "NVIDIA H100 80GB HBM3, 700.00 W"},
        "commit": None, "source_sha256": "0" * 64, "torch": "x"})


def test_run_refuses_floor_fallback_hbm(tmp_path, monkeypatch, fresh_models):
    """A stream at the two-point noise floor keeps the table's HBM rate in
    the model and in the fit, and the record is neither fitted nor
    calibrated (tests/test_calibrate.py's case)."""
    _pretend_card(monkeypatch)
    monkeypatch.setattr(calibrate, "measure_hbm", lambda *a, **kw: {
        "hbm_bytes_per_s": 4.2e9, "hbm_bytes_per_s_raw": 4.2e9,
        "floor_fallback": True, "buffer_mib": 8, "passes": 2})
    monkeypatch.setattr(calibrate, "_solve_rate",
                        lambda cfg, device, **kw: (1.5e11, False))
    seen = []

    def fit(name, value):
        def f(*a):
            seen.append((name, a[-1].hbm_bytes_per_s))
            return value
        return f

    monkeypatch.setattr(calibrate, "fit_vpu_2d", fit("vpu", 1.7e12))
    monkeypatch.setattr(calibrate, "fit_ops_3d", fit("ops3", 3.1e12))
    rec = calibrate.run(tmp_path / "cal.json")
    assert rec["trustworthy"] is True and rec["platform"] == "cuda"
    assert rec["stream"]["floor_fallback"] is True
    assert rec["hbm_fitted"] is False
    assert rec["fit_complete"] is False
    assert rec["chip_model"]["calibrated"] is False
    assert rec["chip_model"]["hbm_bytes_per_s"] == machine.DEFAULT.hbm_bytes_per_s
    assert seen == [("vpu", machine.DEFAULT.hbm_bytes_per_s),
                    ("ops3", machine.DEFAULT.hbm_bytes_per_s)]
    assert rec["vs_table"]["hbm_ratio"] is None
    assert rec["vs_table"]["vpu_ratio"] == pytest.approx(1.7e12 / 2.2e12)
    assert json.loads((tmp_path / "cal.json").read_text()) == rec


def test_run_refuses_overhead_dominated_stencil_fit(tmp_path, monkeypatch,
                                                    fresh_models):
    """A stencil rate whose two-point correction fell back is not inverted;
    the table's rates stay in the model."""
    _pretend_card(monkeypatch)
    monkeypatch.setattr(calibrate, "measure_hbm", lambda *a, **kw: {
        "hbm_bytes_per_s": 3.0e12, "hbm_bytes_per_s_raw": 2.9e12,
        "floor_fallback": False, "buffer_mib": 256, "passes": 256})
    monkeypatch.setattr(calibrate, "_solve_rate",
                        lambda cfg, device, **kw: (2.8e10, True))
    rec = calibrate.run(tmp_path / "cal.json")
    assert rec["sweep_2d"]["overhead_dominated"] is True
    assert rec["sweep_2d"]["vpu_ops_per_s_fit"] is None
    assert rec["sweep_3d"]["ops_rate_3d_fit"] is None
    assert rec["fit_complete"] is False
    assert rec["chip_model"]["calibrated"] is False
    assert rec["chip_model"]["vpu_ops_per_s"] == machine.DEFAULT.vpu_ops_per_s
    assert rec["chip_model"]["ops_rate_3d"] == machine.DEFAULT.ops_rate_3d
    assert rec["chip_model"]["hbm_bytes_per_s"] == 3.0e12
    assert rec["vs_table"]["hbm_ratio"] == pytest.approx(3.0e12 / 3.35e12)
    assert cli.main(["calibrate", "--out", str(tmp_path / "b.json")]) == 1


def test_calibrate_quick_on_the_cpu_is_untrustworthy(tmp_path, fresh_models):
    """``calibrate --quick --device cpu`` writes a record labelled
    untrustworthy, which both packages load uncalibrated."""
    path = tmp_path / "cal.json"
    rc = cli.main(["calibrate", "--quick", "--device", "cpu", "--out",
                   str(path)])
    rec = json.loads(path.read_text())
    assert rc == (0 if rec["fit_complete"] else 1)
    assert rec["trustworthy"] is False and rec["platform"] == "cpu"
    assert rec["chip_model"]["calibrated"] is False
    assert rec["chip_model"]["name"] == "v5e-proxy"
    assert "vs_table" not in rec
    assert rec["params"] == {"n2d": 256, "n3d": 32, "steps2": 16,
                             "steps3": 16, "hbm_mib": 8, "hbm_passes": 2}
    for key in ("stream", "sweep_2d", "sweep_3d", "hbm_fitted",
                "fit_complete", "device_kind", "chip_class", "ts"):
        assert key in rec
    assert not machine.from_calibration(path).calibrated
    assert not ref_machine.from_calibration(str(path)).calibrated
    assert (dataclasses.asdict(machine.from_calibration(path))
            == dataclasses.asdict(ref_machine.from_calibration(str(path))))


def test_calibration_files_load_across_packages(tmp_path, fresh_models):
    """A record of either package loads in the other's
    ``from_calibration``, with the trustworthiness label enforced."""
    ref_rec = {"trustworthy": True, "platform": "tpu",
               "chip_model": dataclasses.asdict(dataclasses.replace(
                   ref_machine.V5E, vpu_ops_per_s=1.23e12, calibrated=True))}
    p = tmp_path / "ref.json"
    p.write_text(json.dumps(ref_rec))
    got = machine.from_calibration(p)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        ref_machine.from_calibration(str(p)))
    assert got.vpu_ops_per_s == 1.23e12 and got.calibrated
    ref_rec["trustworthy"] = False
    p.write_text(json.dumps(ref_rec))
    assert not machine.from_calibration(p).calibrated

    port_rec = {"trustworthy": True, "platform": "cuda",
                "chip_model": dataclasses.asdict(dataclasses.replace(
                    machine.DEFAULT, **_SYNTHETIC))}
    q = tmp_path / "port.json"
    q.write_text(json.dumps(port_rec))
    back = ref_machine.from_calibration(str(q))
    assert back.calibrated and back.ops_rate_3d == 1.5e13
    assert dataclasses.asdict(back) == dataclasses.asdict(
        machine.from_calibration(q))


def test_mistyped_calibration_path_raises(tmp_path, monkeypatch, fresh_models):
    monkeypatch.setenv("HEAT_CHIP_CALIBRATION", str(tmp_path / "nope.json"))
    machine.override(None)
    with pytest.raises(OSError):
        machine.current()
    (tmp_path / "bad.json").write_text("{\"chip_model\": {\"name\": 1}}")
    monkeypatch.setenv("HEAT_CHIP_CALIBRATION", str(tmp_path / "bad.json"))
    with pytest.raises(TypeError):
        machine.current()


def test_a_calibration_loaded_after_a_plan_is_not_ignored(
        tmp_path, monkeypatch, fresh_models):
    """The plan caches are registered with ``machine.register_cache``: a
    model loaded after a first plan replans."""
    shape = (512, 512, 512)
    before = pass_schedule.passes(shape, "bfloat16", 16)
    assert before == [4, 4, 4, 4]
    rec = {"trustworthy": True, "chip_model": dataclasses.asdict(
        dataclasses.replace(machine.DEFAULT, **_SYNTHETIC))}
    (tmp_path / "c.json").write_text(json.dumps(rec))
    monkeypatch.setenv("HEAT_CHIP_CALIBRATION", str(tmp_path / "c.json"))
    machine.override(None)
    assert machine.current().calibrated
    assert pass_schedule.passes(shape, "bfloat16", 16) == [6, 6, 4]
    machine.override(machine.DEFAULT)
    assert pass_schedule.passes(shape, "bfloat16", 16) == before


@pytest.mark.parametrize("ksteps", [5, 16, 40])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plans_under_a_shared_calibration_are_the_references(
        shared_calibration, dt, ksteps):
    assert machine.current().name == "synthetic"
    assert ref_machine.current().name == "synthetic"
    for shape in _SHAPES_2D:
        assert pass_schedule.plan_2d(shape, dt, ksteps) == ps._plan_2d(
            shape, dt, ksteps)
        assert pass_schedule.passes(shape, dt, ksteps) == _ref_passes(
            shape, dt, ksteps)
        assert pass_schedule.effective_chunk_2d(shape, dt, ksteps) == \
            ps.effective_chunk_2d(shape, dt, ksteps)
    for shape in _SHAPES_3D:
        assert pass_schedule.plan_3d(shape, dt, ksteps) == ps._plan_3d(
            shape, dt, ksteps)
        assert pass_schedule.passes(shape, dt, ksteps) == _ref_passes(
            shape, dt, ksteps)


def test_the_shared_calibration_moves_depths(shared_calibration):
    """At least one cut moves from ``DEFAULT``'s, in f32 and in bf16."""
    moved = {dt: [] for dt in ("float32", "bfloat16")}
    for dt in moved:
        for shape in _SHAPES_3D:
            cal = pass_schedule.passes(shape, dt, 16)
            machine.override(machine.DEFAULT)
            base = pass_schedule.passes(shape, dt, 16)
            machine.override(None)
            if cal != base:
                moved[dt].append((shape, base, cal))
    assert moved["float32"] and moved["bfloat16"], moved
    assert ((24, 24, 24), [3, 3, 3, 3, 3, 1], [4, 4, 4, 4]) in moved["bfloat16"]


def test_bf16_bytes_under_the_shared_calibration_are_the_references(
        shared_calibration):
    """At 24^3 bf16 the calibration moves 16 fused steps from passes of 3
    to passes of 4, so it moves the bf16 rounding points: the port's
    ``cuda`` solve on the CPU gives the bytes of the reference's
    interpret-mode ``pallas`` solve under the same file."""
    over = dict(n=24, ndim=3, ntime=32, dtype="bfloat16", sigma=0.15,
                fuse_steps=16, heartbeat_every=0)
    assert pass_schedule.passes((24,) * 3, "bfloat16", 16) == [4, 4, 4, 4]
    got = solve(HeatConfig(backend="cuda", **over), device="cpu")
    want = ref_solve(RefConfig(backend="pallas", **over))
    np.testing.assert_array_equal(got.T, np.asarray(want.T, np.float32))
    machine.override(machine.DEFAULT)
    base = solve(HeatConfig(backend="cuda", **over), device="cpu")
    assert not np.array_equal(base.T, got.T)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend,extra", [("cuda", {}), ("torch", {}),
                                           ("sharded",
                                            {"virtual_devices": 4})])
def test_two_point_repeats_keep_the_solves_bytes(backend, extra, dt):
    """The benchmark mode's protocol runs on a clone of the final state;
    ``fetch=False`` returns no field."""
    cfg = HeatConfig(n=40, ntime=24, dtype=dt, backend=backend, fuse_steps=8,
                     report_sum=True)
    plain = solve(cfg, device="cpu", **extra)
    timed = solve(cfg, device="cpu", two_point_repeats=2, **extra)
    np.testing.assert_array_equal(plain.T, timed.T)
    assert plain.timing.points_per_s_two_point is None
    assert plain.timing.two_point_fell_back is None
    assert timed.timing.points_per_s_two_point > 0
    assert isinstance(timed.timing.two_point_fell_back, bool)
    bare = solve(cfg, device="cpu", fetch=False, warm_exec=True, **extra)
    assert bare.T is None
    assert bare.gsum == plain.gsum and bare.gsum_dtype == "float64"


def test_two_point_rate_on_the_cpu_times_the_host_clock():
    from heat_tpu_torch.runtime.timing import two_point_rate

    calls = []

    def call(x):
        calls.append(1)
        return x + 1

    res = two_point_rate(call, torch.zeros(1000), 1000.0, repeats=3)
    assert len(calls) == 1 + 3 * 3
    rate, raw = res
    assert rate > 0 and raw > 0 and isinstance(res.fell_back, bool)
    if res.fell_back:
        assert rate == raw
