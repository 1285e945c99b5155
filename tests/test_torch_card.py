"""The card-only cases of heat_tpu_torch: each kernel, and each path that
launches one, against the port's plain version on the same card.

This file imports neither JAX nor heat_tpu, so it runs on the card's host,
which has neither installed (``chip_smoke.py`` runs it there with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_card.py``). The CPU tests hold each plain version against
the reference, so a kernel equal to its plain version is equal to the
reference. On a host without a card every case skips.
"""

import functools
import hashlib
import math
from unittest import mock

import numpy as np
import pytest
import torch

from heat_tpu_torch import config
from heat_tpu_torch.backends import common, pinned, sharded, solve
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.grid import ic_envelope
from heat_tpu_torch.ops import cuda_lab
from heat_tpu_torch.ops import cuda_lanes
from heat_tpu_torch.ops import cuda_stencil as cs
from heat_tpu_torch.runtime import convergence, faults
from heat_tpu_torch.serve import Engine, ServeConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got.view(view), want.view(view))


def test_kernel_matches_plain_on_card():
    for dtype in (torch.float32, torch.bfloat16):
        T = torch.rand(1000, 4099, generator=torch.Generator().manual_seed(0))
        T = (1 + T).to(dtype).cuda()
        for k in (1, 7, 16, 32):
            got = cs.ftcs_multistep_edges_cuda(T, 0.2, k)
            want = cs.ftcs_multistep_edges_cuda(T, 0.2, k, plain=True)
            assert _same_bits(got, want), (dtype, k)


def test_kernel_matches_plain_on_card_3d():
    for dtype in (torch.float32, torch.bfloat16):
        T = torch.rand(67, 45, 129, generator=torch.Generator().manual_seed(0))
        T = (1 + T).to(dtype).cuda()
        for k in (1, 4, 8):
            got = cs.ftcs_multistep_edges_cuda(T, 1 / 6, k)
            want = cs.ftcs_multistep_edges_cuda(T, 1 / 6, k, plain=True)
            assert _same_bits(got, want), (dtype, k)


# the kernel lab: (function, variant) pairs, the TPU geometry the JAX
# functions take, and the inputs of tests/test_torch_lab_kernels.py
_LAB_PAIRS = [
    ("lab_3d_tiled", None), ("lab_3d_rolled", "f32"), ("lab_3d_rolled", "fma"),
    ("lab_thin2d_variant", "shrink"), ("lab_thin2d_variant", "rolled"),
    ("lab_thin2d_variant", "rolledfma"), ("lab_thin2d_variant", "bf16native"),
    ("lab_2d_coltiled", None), ("lab_2d_coltiled_rolled", "f32"),
    ("lab_2d_coltiled_rolled", "fma"), ("lab_2d_coltiled_rolled", "bf16native"),
    ("lab_2d_coltiled_rolled", "bf16fma"),
]
_LAB_GEO = {"2d": dict(R=8, C=128, kr=8, kc=64), "thin": dict(tile=8, kpad=8),
            "3d": dict(R=8, M=4, k=4, km=4)}


def _lab_field(nd: int, seed: int):
    logical, pad = ((40, 200), (40, 256)) if nd == 2 else ((16, 12, 100),
                                                           (16, 12, 128))
    T = np.zeros(pad, np.float32)
    T[tuple(slice(0, s) for s in logical)] = np.random.default_rng(
        seed).uniform(0.0, 2, logical)
    return T, logical


def test_lab_kernels_match_plain_on_the_card():
    for name, variant in _LAB_PAIRS:
        nd = 3 if "3d" in name else 2
        T, logical = _lab_field(nd, seed=4)
        geo = _LAB_GEO["thin" if name == "lab_thin2d_variant"
                       else f"{nd}d"]
        blocks = cuda_lab.BLOCKS_2D if nd == 2 else cuda_lab.BLOCKS_3D[:1]
        k = 8 if nd == 2 else 4
        for dtype in (torch.float32, torch.bfloat16):
            Tp = torch.from_numpy(T).to(dtype).cuda()
            kw = dict(geo, logical=logical)
            if variant is not None:
                kw["variant"] = variant
            fn = getattr(cuda_lab, name)
            for block in blocks:
                # the streamed 2D tile is compiled at a few depths only
                kb = (max(d for d in cuda_lab.STREAM_2D_DEPTHS if d <= k)
                      if block == cuda_lab.STREAM_2D else k)
                got = fn(Tp, 0.15, kb, block=block, **kw)
                want = fn(Tp, 0.15, kb, plain=True, **kw)
                g = got.float().cpu().numpy().view(np.uint32)
                w = want.float().cpu().numpy().view(np.uint32)
                assert int((g != w).sum()) == 0, (name, variant, dtype, block)


def _lane_case(nd, B, k, seed):
    """(fields f32, r, n, rem) of one lane case: four lanes, one with
    n < B, one whose countdown ends inside the chunk, one with none left,
    one with a NaN in its centre."""
    m = B + 2
    f = np.random.default_rng(seed).uniform(1, 2, (4,) + (m,) * nd)
    f = f.astype(np.float32)
    f[(3,) + (1 + B // 2,) * nd] = np.nan
    n = np.array([B - 3, B, B, B], np.int32)
    rem = np.array([k + 3, k // 2 if k > 1 else 0, 0, k + 1], np.int32)
    r = {2: [0.25, 0.2, 0.1, 0.25], 3: [1 / 6, 0.15, 0.1, 1 / 6]}[nd]
    return f, np.array(r, np.float32), n, rem


def _nan_bits(a: np.ndarray) -> np.ndarray:
    a = np.where(np.isnan(a), np.float32(np.nan), a).astype(np.float32)
    return a.view(np.uint32)


def test_lane_kernels_match_plain_on_the_card():
    for nd, B in ((2, 12), (2, 256), (3, 8), (3, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            for k in (1, 16, 37):
                f, r, n, rem = _lane_case(nd, B, k, seed=k)
                args = [torch.from_numpy(a).cuda() for a in (r, n, rem)]
                T = torch.from_numpy(f).to(dtype).cuda()
                fields, fin, stats = (
                    x.float().cpu().numpy() if x.is_floating_point()
                    else x.cpu().numpy()
                    for x in cuda_lanes.lane_multistep(T, *args, k, 1))
                want = cuda_lanes.lane_multistep(T, *args, k, 1, plain=True)
                w_fields = want[0].float().cpu().numpy()
                w_fin = want[1].cpu().numpy().astype(bool)
                w_stats = want[2].cpu().numpy()
                assert int((_nan_bits(fields) != _nan_bits(w_fields)).sum()) == 0
                np.testing.assert_array_equal(fin, w_fin)
                np.testing.assert_array_equal(stats[:3, w_fin],
                                              w_stats[:3, w_fin])
                np.testing.assert_allclose(stats[3, w_fin], w_stats[3, w_fin],
                                           rtol=1e-5)


def _matrix_requests(ndim, dtype, bcs):
    """tests/test_serve_lane_kernel.py:78-92, as keyword sets."""
    small = 6 if ndim == 3 else 8
    big = 8 if ndim == 3 else 12
    return [
        dict(n=big, ntime=13, ndim=ndim, dtype=dtype, bc=bcs[0], ic="hat"),
        dict(n=small, ntime=21, ndim=ndim, dtype=dtype, bc=bcs[1],
             ic="uniform", nu=0.1),
        dict(n=big - 2, ntime=5, ndim=ndim, dtype=dtype, bc=bcs[0],
             ic="hat_small"),
        dict(n=big, ntime=0, ndim=ndim, dtype=dtype, bc=bcs[1], ic="hat"),
        dict(n=small + 1, ntime=30, ndim=ndim, dtype=dtype, bc=bcs[0],
             ic="hat_half", bc_value=2.5),
    ]


def test_serve_on_the_card_matches_the_plain_body():
    """On the card the lane kernels serve the lane matrix to the bytes of
    the plain lane body run on the same card."""
    reqs = (_matrix_requests(2, "float32", ("ghost", "edges"))
            + _matrix_requests(2, "bfloat16", ("edges", "ghost"))
            + _matrix_requests(3, "float32", ("ghost", "edges")))
    out = {}
    for kernel in ("cuda", "torch"):
        cuda_lanes.reset_launches()
        eng = Engine(ServeConfig(lanes=2, chunk=4, buckets=(12,),
                                 lane_kernel=kernel, emit_records=False,
                                 keep_fields=True), device="cuda")
        ids = [eng.submit(HeatConfig(**r)) for r in reqs]
        recs = {r["id"]: r for r in eng.results()}
        assert all(recs[i]["status"] == "ok" for i in ids)
        assert (min(cuda_lanes.launches.values()) > 0) == (kernel == "cuda")
        # the scheduler's count of the chunks' passes = the wrappers' count
        summary = eng.summary()
        assert summary["lane_passes"] == {
            k: v for k, v in cuda_lanes.launches.items() if v}
        assert (sum(summary["lane_passes_by_bucket"].values())
                == sum(cuda_lanes.launches.values()))
        out[kernel] = [recs[i]["T"].tobytes() for i in ids]
    assert out["cuda"] == out["torch"]


def _tol_for(cfg, frac):
    """The steady tolerance whose closed-form admission prediction is
    ``frac * ntime`` steps (``convergence.predict_admission_steps``)."""
    lam = math.exp(convergence.closed_form_log_rate(cfg))
    lo, hi = ic_envelope(cfg)
    r0 = (1 - lam) * max(abs(hi), abs(lo), abs(hi - lo))
    return r0 * lam ** (frac * cfg.ntime)


def _serve_on_card(reqs, kernel, **kw):
    """Drain ``reqs`` (dicts: HeatConfig fields plus id/until/tol) on the
    card; returns (engine, records by id, the wrappers' launch counts)."""
    faults.reset()
    cuda_lanes.reset_launches()
    eng = Engine(ServeConfig(lane_kernel=kernel, emit_records=False,
                             keep_fields=True, **kw), device="cuda")
    for r in reqs:
        r = dict(r)
        rid, until, tol = r.pop("id"), r.pop("until", None), r.pop("tol", None)
        eng.submit(HeatConfig(**r), request_id=rid, until=until, tol=tol)
    recs = {r["id"]: r for r in eng.results()}
    return eng, recs, dict(cuda_lanes.launches)


@pytest.mark.parametrize("depth", [0, 2])
def test_steady_retirement_on_the_card_matches_the_plain_body(depth):
    """until=steady on the lane kernels: the fused residual rows retire each
    request at the same step, with the same bytes, as the plain lane body
    on the same card; a fixed-step lane-mate is untouched."""
    reqs = [dict(id="s2", n=40, ntime=400, ic="sine", bc="edges"),
            dict(id="sb", n=30, ntime=300, ic="sine", bc="edges",
                 dtype="bfloat16"),
            dict(id="f2", n=33, ntime=70, ic="hat", bc="ghost"),
            dict(id="s3", n=14, ntime=200, ndim=3, sigma=0.15, ic="hat",
                 bc="edges")]
    for r in reqs:
        if r["id"].startswith("s"):
            cfg = HeatConfig(**{k: v for k, v in r.items() if k != "id"})
            r.update(until="steady", tol=_tol_for(cfg, 0.4))
    kw = dict(lanes=2, chunk=16, buckets=(16, 48), dispatch_depth=depth)
    got = {k: _serve_on_card(reqs, k, **kw) for k in ("cuda", "torch")}
    eng, recs, launches = got["cuda"]
    assert min(launches.values()) > 0
    assert not any(got["torch"][2].values())
    assert eng.steady_exits == got["torch"][0].steady_exits == 3
    for rid, rec in recs.items():
        other = got["torch"][1][rid]
        assert rec["status"] == other["status"] == "ok"
        assert (rec["exit"], rec["steps_done"]) == (other["exit"],
                                                   other["steps_done"])
        assert rec["T"].tobytes() == other["T"].tobytes(), rid
        assert (rec["exit"] == "steady") == rid.startswith("s")


@pytest.mark.parametrize("depth", [0, 2])
def test_rollback_heals_on_the_card_like_the_plain_body(depth):
    """--serve-on-nan rollback on the lane kernels (keep-input passes, a
    restore from the snapshot row): the poisoned 2D and 3D lanes heal to the
    clean run's bytes, as through the plain lane body, with one rollback
    each and the same launches per chunk as the clean run."""
    reqs = [dict(id="a", n=40, ntime=60, ic="hat", bc="ghost"),
            dict(id="b", n=33, ntime=75, ic="hat_small", bc="edges"),
            dict(id="c", n=14, ntime=40, ndim=3, sigma=0.15, ic="hat"),
            dict(id="d", n=12, ntime=52, ndim=3, sigma=0.1, ic="hat_half",
                 bc="ghost")]
    kw = dict(lanes=2, chunk=16, buckets=(16, 48), dispatch_depth=depth)
    clean = _serve_on_card(reqs, "cuda", **kw)
    for kernel in ("cuda", "torch"):
        eng, recs, launches = _serve_on_card(
            reqs, kernel, on_nan="rollback",
            inject="lane-nan@20:req=b,lane-nan@17:req=c", **kw)
        assert eng.rollbacks == 2 and eng.lanes_quarantined == 0
        for rid, rec in recs.items():
            assert rec["status"] == "ok"
            assert rec["T"].tobytes() == clean[1][rid]["T"].tobytes(), rid
        if kernel == "cuda":
            assert launches == eng.summary()["lane_passes"]
            chunks = eng.summary()["lane_chunks"]
            for name, nd in (("lanes2d", 2), ("lanes3d", 3)):
                assert launches[name] <= len(cuda_lanes.passes(nd, 16)) * \
                    chunks[name]


@pytest.mark.parametrize("ndim", [2, 3])
def test_cuda_solve_on_card_is_the_plain_version(ndim):
    """On the card the solve goes through the kernel, and ends on the bytes
    the plain version computes on the CPU in the same passes."""
    cs.reset_launches()
    port = config.variant_config("python_cuda").with_(
        backend="cuda", n=40 if ndim == 3 else 67, ntime=40, ndim=ndim,
        sigma=0.15, heartbeat_every=0, write_int=False)
    got = solve(port, device="cuda")
    name = "ftcs2d" if ndim == 2 else "ftcs3d"
    assert got.timing.kernel == f"cuda {name}" and cs.launches[name]
    np.testing.assert_array_equal(got.T, solve(port, device="cpu").T)


@pytest.mark.parametrize("ndim,dtype", [(2, "float32"), (2, "bfloat16"),
                                        (3, "float32"), (3, "bfloat16")])
def test_mega_machinery_on_the_card_is_its_plain_local_kernel(ndim, dtype):
    """A mega-lane on 4 shards of the card: every boundary vector and the
    final field equal those of the same machinery on the kernel's plain
    bounded version, on the card (a fuse depth of 5 cuts each 16-step
    chunk into blocks of 5, 5, 5 and the final step)."""
    from heat_tpu_torch.serve.engine import MegaLaneEngine, fetch_boundary

    cfg = HeatConfig(n=256 if ndim == 2 else 64, ndim=ndim, ntime=37,
                     dtype=dtype, sigma=0.2 if ndim == 2 else 0.15,
                     bc="edges", fuse_steps=5)

    def drive():
        eng = MegaLaneEngine(cfg, 4, 16, device="cuda", cache={})
        bounds = [fetch_boundary(eng.dispatch_chunk(k), timeout_s=60)
                  for k in (16, 16, 5)]
        return bounds, fetch_boundary(eng.final_snapshot(), timeout_s=60)

    name = cs._KERNELS[ndim]
    cs.reset_launches()
    got_b, got_T = drive()
    assert cs.launches[name] > 0
    plain = functools.partial(cs.ftcs_multistep_bounded_cuda, plain=True)
    with mock.patch.object(sharded, "ftcs_multistep_bounded_cuda", plain):
        cs.reset_launches()
        want_b, want_T = drive()
        assert cs.launches[name] == 0
    assert [b[0, 0] for b in got_b] == [21, 5, 0]
    for a, b in zip(got_b, want_b):
        assert a.tobytes() == b.tobytes()
    assert got_T.tobytes() == want_T.tobytes()


def _sharded_field(cfg, **kw):
    return solve(cfg, device="cuda", virtual_devices=int(np.prod(cfg.mesh_shape)),
                 **kw).T


@pytest.mark.parametrize("ndim,comm", [(2, "direct"), (2, "staged"),
                                       (3, "direct"), (3, "staged")])
def test_overlap_on_the_card(ndim, comm):
    """``--exchange overlap`` on the card: the kernels on the interior and
    on every region (the staged slabs on a side stream), the bytes of the
    indep exchange in f32; in bf16 the bytes of the same overlap on the
    plain bounded version."""
    cfg = HeatConfig(n=512 if ndim == 2 else 64, ndim=ndim, ntime=37,
                     sigma=0.2 if ndim == 2 else 0.15, bc="ghost",
                     dtype="float32", backend="sharded", comm=comm,
                     mesh_shape=(2, 2) if ndim == 2 else (2, 2, 1))
    name = "ftcs2d" if ndim == 2 else "ftcs3d"
    cs.reset_launches()
    got = _sharded_field(cfg.with_(exchange="overlap"))
    assert cs.launches[name] > 0
    want = _sharded_field(cfg)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    bf16 = cfg.with_(dtype="bfloat16", exchange="overlap")
    got = _sharded_field(bf16)
    plain = functools.partial(cs.ftcs_multistep_bounded_cuda, plain=True)
    with mock.patch.object(sharded, "ftcs_multistep_bounded_cuda", plain):
        cs.reset_launches()
        want = _sharded_field(bf16)
        assert cs.launches[name] == 0
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_memory_watermark_reads_the_device_allocator():
    from heat_tpu_torch.runtime import prof

    dev = torch.device("cuda")
    before, source = prof.device_memory_bytes(dev)
    assert source == "device" and before >= 0
    block = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    after, _ = prof.device_memory_bytes(dev)
    assert after >= before + (64 << 20)
    obs = prof.Observatory(mem_poll_every=1, device=dev)
    obs.maybe_sample_memory(0.0)
    snap = obs.mem.snapshot()
    assert snap["source"] == "device" and snap["last_bytes"] >= 64 << 20
    del block


@pytest.mark.parametrize("ndim,dtype", [(2, "float32"), (2, "bfloat16"),
                                        (3, "float32"), (3, "bfloat16")])
def test_checkpoint_field_d2h_equals_the_live_stack(ndim, dtype):
    """An engine checkpoint's lane field (``snapshot_lane`` at the cut, the
    D2H fetched later while the chunks ping-pong the stacks on) holds the
    bytes the stack held at the cut."""
    from heat_tpu_torch.serve.engine import BucketKey, LaneEngine

    n = 20 if ndim == 2 else 12
    key = BucketKey(ndim=ndim, n=24 if ndim == 2 else 16, dtype=dtype,
                    bc="edges")
    eng = LaneEngine(key, 2, 8, kernel="cuda", device="cuda")
    for lane in range(2):
        cfg = HeatConfig(n=n - lane, ndim=ndim, ntime=200, dtype=dtype,
                         ic="hat_half")
        from heat_tpu_torch.grid import initial_condition_device

        eng.load_lane(lane, initial_condition_device(cfg, "cuda"),
                      cfg.r, 200, 0.0)
    for _ in range(3):
        eng.dispatch_chunk()
    region = (1,) + (slice(1, 1 + n - 1),) * ndim
    want = eng._fields[region].clone()      # the stack at the cut
    snap = eng.snapshot_lane(1, n - 1)
    for _ in range(5):                      # overwrite both stacks
        eng.dispatch_chunk()
    got = LaneEngine.extract(snap)
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    assert got.tobytes() == want.view(view).cpu().numpy().tobytes()
    assert not torch.equal(eng._fields[region].view(view), want.view(view))


@pytest.mark.parametrize("case", [
    dict(n=200, ntime=141, dtype="float32", sigma=0.2),
    dict(n=190, ntime=133, dtype="bfloat16", sigma=0.2, bc="ghost",
         bc_value=1.0),
    dict(n=40, ndim=3, ntime=77, dtype="float32", sigma=1 / 6),
    dict(n=36, ndim=3, ntime=69, dtype="bfloat16", sigma=1 / 6,
         ic="hat_half")], ids=["K4-f32", "K4-bf16", "K5-f32", "K5-bf16"])
def test_cache_prefix_seed_into_a_lane_kernel(case, tmp_path):
    """A lane seeded from a cached prefix (cut inside a chunk) and stepped
    the rest of the way by the lane kernels gives the bytes of the plain
    lane body's uninterrupted run on the card."""
    cut = 45
    kw = dict(lanes=2, chunk=16, buckets=(64, 256), emit_records=False)

    def serve(kernel, ntime, out, **extra):
        cuda_lanes.reset_launches()
        eng = Engine(ServeConfig(lane_kernel=kernel, out_dir=str(out),
                                 **kw, **extra), device="cuda")
        eng.submit(HeatConfig(**dict(case, ntime=ntime)), request_id="x")
        (rec,) = eng.results()
        assert rec["status"] == "ok"
        return eng, (out / "x.npz").read_bytes(), dict(cuda_lanes.launches)

    cache = dict(cache=True, cache_dir=str(tmp_path / "c"))
    serve("cuda", cut, tmp_path / "o0", **cache)
    eng, got, launches = serve("cuda", case["ntime"], tmp_path / "o1",
                               **cache)
    assert eng.summary()["cache"]["hits_prefix"] == 1
    assert launches["lanes3d" if case.get("ndim") == 3 else "lanes2d"] > 0
    _, want, _ = serve("torch", case["ntime"], tmp_path / "o2")
    assert got == want


def test_fleet_router_over_two_card_gateways_matches_the_plain_body(
        tmp_path):
    """Two gateways whose engines run the lane kernels on the card behind
    one router: the router spreads the lane matrix over both, every npz
    holds the bytes of the plain lane body on the same card, and the lane
    kernels launched."""
    import http.client
    import json
    import time

    from heat_tpu_torch.fleet.registry import BackendRegistry, parse_backends
    from heat_tpu_torch.fleet.router import FleetConfig, Router
    from heat_tpu_torch.serve.gateway import Gateway

    reqs = (_matrix_requests(2, "float32", ("ghost", "edges"))
            + _matrix_requests(2, "bfloat16", ("edges", "ghost"))
            + _matrix_requests(3, "float32", ("ghost", "edges")))
    lines = [dict(r, id=f"m{i}") for i, r in enumerate(reqs)]
    faults.reset()
    cuda_lanes.reset_launches()
    gws, rt = [], None
    try:
        for i in range(2):
            out = tmp_path / f"g{i}"
            gws.append(Gateway(Engine(ServeConfig(
                lanes=2, chunk=4, buckets=(12,), emit_records=False,
                out_dir=str(out)), device="cuda"), "127.0.0.1", 0).start())
        spec = ",".join(f"b{i}={gw.address}" for i, gw in enumerate(gws))
        rt = Router(BackendRegistry(parse_backends(spec)), "127.0.0.1", 0,
                    FleetConfig(health_interval_s=0.1)).start()
        deadline = time.monotonic() + 60
        while not all(b.status for b in rt.registry.snapshot()):
            assert time.monotonic() < deadline, "no status probe"
            time.sleep(0.05)
        conn = http.client.HTTPConnection(rt.host, rt.port, timeout=120)
        conn.request("POST", "/v1/solve", body="".join(
            json.dumps(ln) + "\n" for ln in lines).encode())
        recs = [json.loads(x) for x in conn.getresponse().read().splitlines()
                if x.strip()]
        conn.close()
        assert sorted(r["id"] for r in recs) == sorted(ln["id"]
                                                       for ln in lines)
        assert all(r["status"] == "ok" for r in recs), recs
        snap = rt.snapshot()
        assert all(b["delivered"] > 0 for b in snap["backends"].values())
        assert snap["router"]["duplicates"] == 0
    finally:
        if rt is not None:
            rt.close()
        for gw in gws:
            try:
                gw.request_drain()
                gw.wait_drained(120)
            finally:
                gw.close()
                gw.engine.shutdown(timeout=120)
    assert cuda_lanes.launches["lanes2d"] > 0
    assert cuda_lanes.launches["lanes3d"] > 0
    plain = Engine(ServeConfig(lanes=2, chunk=4, buckets=(12,),
                               lane_kernel="torch", emit_records=False,
                               out_dir=str(tmp_path / "plain")),
                   device="cuda")
    for ln in lines:
        r = dict(ln)
        plain.submit(HeatConfig(**{k: v for k, v in r.items() if k != "id"}),
                     request_id=r["id"])
    assert all(r["status"] == "ok" for r in plain.results())
    for ln in lines:
        got = [tmp_path / f"g{i}" / f"{ln['id']}.npz" for i in range(2)
               if (tmp_path / f"g{i}" / f"{ln['id']}.npz").exists()]
        assert len(got) == 1
        assert got[0].read_bytes() == \
            (tmp_path / "plain" / f"{ln['id']}.npz").read_bytes()


def test_audit_on_the_card_holds_every_contract():
    """``audit`` on the card: every family dispatched under
    ``set_sync_debug_mode("error")`` holds every contract, and the hand
    kernels run."""
    from heat_tpu_torch.analysis import programs

    vs, report = programs.audit(device="cuda")
    assert vs == [], [v.format() for v in vs]
    assert report["dispatched"] == report["families"]
    launched = {k for fam in report["programs"].values()
                for k, n in fam["launches"].items() if n}
    assert launched >= {"ftcs2d", "ftcs3d", "lanes2d", "lanes3d"}


def test_armed_engine_on_the_card_has_no_violation(monkeypatch, tmp_path):
    """An engine built with the lock-order watchdog and the race sanitizer
    armed (raising mode) serves the lane matrix on the card, with the
    solve cache on, to the bytes of the unarmed plain lane body: zero
    inversions, zero races, and the engine, writer, cache and observatory
    ranks all taken."""
    from heat_tpu_torch.runtime import debug

    reqs = (_matrix_requests(2, "float32", ("ghost", "edges"))
            + _matrix_requests(3, "bfloat16", ("edges", "ghost")))
    plain = Engine(ServeConfig(lanes=2, chunk=4, buckets=(12,),
                               lane_kernel="torch", emit_records=False,
                               keep_fields=True), device="cuda")
    plain_ids = [plain.submit(HeatConfig(**r)) for r in reqs]
    got = {r["id"]: r for r in plain.results()}
    want = [got[i]["T"].tobytes() for i in plain_ids]
    monkeypatch.setenv("HEAT_TPU_LOCKCHECK", "1")
    monkeypatch.setenv("HEAT_TPU_RACECHECK", "1")
    debug.reset_lock_order_stats()
    debug.reset_race_stats()
    try:
        cuda_lanes.reset_launches()
        eng = Engine(ServeConfig(lanes=2, chunk=4, buckets=(12,),
                                 emit_records=False, keep_fields=True,
                                 out_dir=str(tmp_path / "out"), cache=True,
                                 cache_dir=str(tmp_path / "cache")),
                     device="cuda")
        ids = [eng.submit(HeatConfig(**r)) for r in reqs]
        recs = {r["id"]: r for r in eng.results()}
        assert all(recs[i]["status"] == "ok" for i in ids)
        assert [recs[i]["T"].tobytes() for i in ids] == want
        assert min(cuda_lanes.launches.values()) > 0
        locks, races = debug.lock_order_stats(), debug.race_stats()
    finally:
        debug.reset_lock_order_stats()
        debug.reset_race_stats()
    assert locks["violations"] == [] and races["findings"] == []
    assert set(locks["taken"]) >= {"engine", "writer", "cache",
                                   "observatory"}
    assert races["instrumented"] >= 4


# --- the drive loop's page-locked transfers (backends/pinned.py) -------------

def _pinned_cfg(dtype="float32", ntime=32):
    return config.variant_config("python_cuda").with_(
        backend="cuda", n=4096, ntime=ntime, dtype=dtype, sigma=0.2,
        heartbeat_every=0, write_int=False)


def _host_field(seed, n=4096):
    return np.random.default_rng(seed).random((n, n), dtype=np.float32) + 0.5


@pytest.fixture
def fresh_pool(monkeypatch):
    """A pool of its own for the drive loop, at the shipped cap."""
    pool = pinned.PinnedPool()
    monkeypatch.setattr(pinned, "POOL", pool)
    return pool


def test_pinned_transfers_move_the_pageable_path_s_bytes():
    pool = pinned.PinnedPool()
    arr = _host_field(11)
    first, was_pinned = common.upload_field(arr, "cuda", pool)
    assert not was_pinned
    T, was_pinned = common.upload_field(arr, "cuda", pool)
    assert was_pinned
    assert torch.equal(T.view(torch.int32), first.view(torch.int32))
    assert not common.fetch_field(T, pool)[1]      # the first: pageable
    for dtype in (torch.float32, torch.bfloat16):
        x = (T * 3 - 2).to(dtype)
        got, was_pinned = common.fetch_field(x, pool)
        assert was_pinned and torch.from_numpy(got).is_pinned()
        want = common.host_fetch(x)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    assert pool.tally == {"upload.pinned": 1, "upload.pageable": 1,
                          "fetch.pinned": 2, "fetch.pageable": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_solve_through_the_pool_ends_on_the_pageable_path_s_bytes(
        fresh_pool, dtype):
    cfg, T0 = _pinned_cfg(dtype), _host_field(12)
    want = solve(cfg, T0=T0, device="cuda")
    got = solve(cfg, T0=T0, device="cuda")
    assert fresh_pool.tally == {"upload.pinned": 1, "upload.pageable": 1,
                                "fetch.pinned": 1, "fetch.pageable": 1}
    assert got.T.tobytes() == want.T.tobytes()


def test_a_held_result_is_untouched_by_the_next_solve(fresh_pool):
    cfg = _pinned_cfg()
    solve(cfg, T0=_host_field(13), device="cuda")
    a = solve(cfg, T0=_host_field(13), device="cuda").T
    kept = a.copy()
    b = solve(cfg, T0=_host_field(14), device="cuda").T
    assert fresh_pool.tally["fetch.pinned"] == 2
    assert not np.shares_memory(a, b) and not np.array_equal(a, b)
    assert a.tobytes() == kept.tobytes()


def test_the_pool_keeps_its_cap_over_fifty_held_results(monkeypatch):
    cfg, base = _pinned_cfg(ntime=8), _host_field(15)
    field = base.nbytes
    # a cap of 16 fields, below the host's, so 50 held results reach it
    pool = pinned.PinnedPool(cap_bytes=16 * field)
    monkeypatch.setattr(pinned, "POOL", pool)
    kept = []
    for i in range(50):
        T = solve(cfg, T0=base + np.float32(i), device="cuda").T
        kept.append((T, hashlib.sha1(T).hexdigest()))
        assert pool.held_bytes <= pool.cap_bytes
        assert pool.held_bytes == min(i, 16) * field
    # the first solve moves its fields pageable; from the second, each
    # upload stages in the block its solve's fetch then keeps: 16 results
    # fill the cap, and from the 18th solve both fall back
    assert pool.tally == {"upload.pinned": 16, "upload.pageable": 34,
                          "fetch.pinned": 16, "fetch.pageable": 34}
    for T, digest in kept:
        assert hashlib.sha1(T).hexdigest() == digest


def test_a_refused_pinned_allocation_leaves_the_next_solve_clean(
        monkeypatch):
    def refuse(shape, dtype):
        # more than a process can address: CUDA refuses it at once
        return torch.empty(1 << 50, dtype=torch.uint8, pin_memory=True)

    pool = pinned.PinnedPool(cap_bytes=1 << 60, alloc=refuse)
    monkeypatch.setattr(pinned, "POOL", pool)
    cfg, T0 = _pinned_cfg(), _host_field(16)
    runs = [solve(cfg, T0=T0, device="cuda") for _ in range(3)]
    torch.cuda.synchronize()
    assert pool.tally == {"upload.pinned": 0, "upload.pageable": 3,
                          "fetch.pinned": 0, "fetch.pageable": 3}
    assert pool.held_bytes == 0
    assert runs[2].T.tobytes() == runs[0].T.tobytes()
