"""The solve cache of the port against heat_tpu's.

Both engines serve the same requests with ``cache=True`` into directories
of their own: the entries must have the same names, members, bytes and
``sha256``. A repeat is a full hit, replayed byte for byte with no chunk
dispatched; a request whose trajectory prefix is stored is seeded from it
and must give the bytes of an uninterrupted run — in f32 and bf16, at r =
0.2 (2D) and 1/6 (3D), from a prefix cut inside a chunk. Eviction and the
``cache-corrupt`` / ``cache-stale`` quarantine behave as the reference's.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from heat_tpu.config import HeatConfig as JHeatConfig
from heat_tpu.runtime import faults as jfaults
from heat_tpu.serve import Engine as JEngine
from heat_tpu.serve import ServeConfig as JServeConfig
from heat_tpu.serve import solvecache as jsc
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.runtime import faults
from heat_tpu_torch.serve import Engine, ServeConfig
from heat_tpu_torch.serve import solvecache as sc

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_faults():
    jfaults.reset()
    faults.reset()
    yield
    jfaults.reset()
    faults.reset()


REQS = [dict(id="a", n=12, ntime=37, dtype="float32", bc="edges"),
        dict(id="b", n=9, ntime=20, dtype="bfloat16", bc="ghost",
             bc_value=1.0),
        dict(id="c", n=7, ntime=16, ndim=3, sigma=1 / 6, bc="edges")]


def _serve(port: bool, reqs, out_dir, cache_dir, **kw):
    cfg_cls = HeatConfig if port else JHeatConfig
    kw = dict(dict(lanes=2, chunk=8, buckets=(16,), emit_records=False,
                   out_dir=str(out_dir), cache=True,
                   cache_dir=str(cache_dir)), **kw)
    if port:
        eng = Engine(ServeConfig(**kw), device="cpu")
    else:
        eng = JEngine(JServeConfig(mega_lanes=0, **kw))
    for r in reqs:
        r = dict(r)
        rid = r.pop("id")
        eng.submit(cfg_cls(**r), request_id=rid)
    return eng, {r["id"]: r for r in eng.results()}


def test_entries_equal_the_reference_entries(tmp_path):
    _serve(True, REQS, tmp_path / "po", tmp_path / "pc")
    _serve(False, REQS, tmp_path / "jo", tmp_path / "jc")
    names = sorted(p.name for p in (tmp_path / "pc").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jc").iterdir())
    assert len(names) == 2 * len(REQS)
    for name in names:
        got = (tmp_path / "pc" / name).read_bytes()
        want = (tmp_path / "jc" / name).read_bytes()
        assert got == want, name
        if name.endswith(".npz"):
            with zipfile.ZipFile(tmp_path / "pc" / name) as z:
                assert sorted(z.namelist()) == [
                    "T.npy", "dtype.npy", "n.npy", "ndim.npy", "step.npy"]
        else:
            meta = json.loads(got)
            assert meta["kind"] == "result"
            assert meta["sha256"] == sc._sha256_file(
                tmp_path / "pc" / name.replace(".json", ".npz"))
    # the entry is the published result's bytes
    fp = sc.config_fingerprint(HeatConfig(n=12, ntime=37))
    assert (tmp_path / "pc" / sc.entry_name(fp, 37)).read_bytes() == (
        tmp_path / "po" / "a.npz").read_bytes()


def test_a_repeat_is_a_full_hit_replayed_byte_for_byte(tmp_path):
    _, first = _serve(True, REQS, tmp_path / "o1", tmp_path / "c")
    eng, again = _serve(True, [dict(r, id=r["id"] + "2") for r in REQS],
                        tmp_path / "o2", tmp_path / "c")
    assert eng.chunks_dispatched == 0
    for r in REQS:
        rec = again[r["id"] + "2"]
        assert rec["status"] == "ok" and rec["cached"] and rec["exit"] == "cached"
        assert rec["usage"] == {"lane_s": 0.0, "steps": 0, "chunks": 0,
                                "bytes_written": rec["usage"]["bytes_written"],
                                "steps_saved": r["ntime"], "cached": True}
        assert (tmp_path / "o2" / f"{r['id']}2.npz").read_bytes() == (
            tmp_path / "o1" / f"{r['id']}.npz").read_bytes()
    st = eng.summary()["cache"]
    assert st["hits_full"] == len(REQS) and st["misses"] == 0
    # the same with results kept in memory (no out dir)
    eng = Engine(ServeConfig(buckets=(16,), cache=True,
                             cache_dir=str(tmp_path / "c"),
                             emit_records=False), device="cpu")
    eng.submit(HeatConfig(n=12, ntime=37), request_id="mem")
    (rec,) = eng.results()
    with np.load(tmp_path / "o1" / "a.npz") as z:
        assert rec["cached"] and rec["T"].tobytes() == z["T"].tobytes()


PREFIX_CASES = [
    dict(n=12, ntime=43, dtype="float32", sigma=0.2, bc="edges"),
    dict(n=11, ntime=41, dtype="bfloat16", sigma=0.2, bc="ghost",
         bc_value=1.0),
    dict(n=7, ntime=23, ndim=3, dtype="float32", sigma=1 / 6, bc="edges"),
    dict(n=6, ntime=21, ndim=3, dtype="bfloat16", sigma=1 / 6, bc="ghost",
         ic="hat_half"),
]


@pytest.mark.parametrize("case", PREFIX_CASES,
                         ids=lambda c: f"{c.get('ndim', 2)}d-{c['dtype']}")
def test_prefix_seed_gives_the_bytes_of_an_uninterrupted_run(case,
                                                             tmp_path):
    cut = 13        # inside a chunk of 8: not a pass boundary either
    cdir = tmp_path / "c"
    _serve(True, [dict(case, id="p", ntime=cut)], tmp_path / "o0", cdir)
    eng, recs = _serve(True, [dict(case, id="x")], tmp_path / "o1", cdir)
    rec = recs["x"]
    assert eng.summary()["cache"]["hits_prefix"] == 1
    assert rec["usage"]["steps"] == case["ntime"] - cut
    assert rec["usage"]["steps_saved"] == cut
    assert rec["steps_done"] == case["ntime"]
    # the uninterrupted run, by the port and by the reference
    _serve(True, [dict(case, id="x")], tmp_path / "o2", tmp_path / "c2",
           cache=False)
    _serve(False, [dict(case, id="x")], tmp_path / "o3", tmp_path / "c3",
           cache=False)
    got = (tmp_path / "o1" / "x.npz").read_bytes()
    assert got == (tmp_path / "o2" / "x.npz").read_bytes()
    assert got == (tmp_path / "o3" / "x.npz").read_bytes()


def _cache_pair(tmp_path, **kw):
    return (sc.SolveCache(tmp_path / "p", **kw),
            jsc.SolveCache(tmp_path / "j", **kw))


def test_eviction_order_matches_the_reference(tmp_path):
    T = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    caches = _cache_pair(tmp_path, max_bytes=0)
    cfgs = [(HeatConfig, JHeatConfig)[i](n=8, ntime=10 + j)
            for j in range(5) for i in range(2)]
    for j in range(5):
        for i, c in enumerate(caches):
            p = c.put(cfgs[2 * j + i], 10 + j, T=T)
            os.utime(p, (1000 + j, 1000 + j))
    # a hit touches its entry: step 10 becomes the newest
    for i, c in enumerate(caches):
        hit = c.lookup((HeatConfig, JHeatConfig)[i](n=8, ntime=10))
        assert hit["kind"] == "full"
        os.utime(hit["path"], (2000, 2000))
    size = sum(p.stat().st_size for p in (tmp_path / "p").iterdir())
    for c in caches:
        c.max_bytes = size * 3 // 5
        c._evict()
    left_p = sorted(p.name for p in (tmp_path / "p").iterdir())
    left_j = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert left_p == left_j
    steps = sorted(int(n.split("-")[1][:8]) for n in left_p
                   if n.endswith(".npz"))
    assert steps == [10, 13, 14]
    assert caches[0].evictions == caches[1].evictions == 2


@pytest.mark.parametrize("kind", ["cache-corrupt", "cache-stale"])
def test_damaged_entry_is_quarantined_and_recomputed(kind, tmp_path):
    cdir = tmp_path / "c"
    _, first = _serve(True, REQS[:1], tmp_path / "o1", cdir)
    eng, recs = _serve(True, [dict(REQS[0], id="again")], tmp_path / "o2",
                       cdir, inject=kind)
    rec = recs["again"]
    assert rec["status"] == "ok" and not rec["cached"]
    st = eng.summary()["cache"]
    assert st["quarantined"] == 1 and st["hits_full"] == 0
    assert len(list(cdir.glob("*.corrupt"))) == 2
    assert (tmp_path / "o2" / "again.npz").read_bytes() == (
        tmp_path / "o1" / "a.npz").read_bytes()
    # the reference quarantines the same way, for the same reason
    jdir = tmp_path / "jc"
    _serve(False, REQS[:1], tmp_path / "jo1", jdir)
    jeng, jrecs = _serve(False, [dict(REQS[0], id="again")],
                         tmp_path / "jo2", jdir, inject=kind)
    assert not jrecs["again"]["cached"]
    assert jeng.summary()["cache"]["quarantined"] == 1
    assert sorted(p.name for p in cdir.iterdir()) == sorted(
        p.name for p in jdir.iterdir())


def test_cache_off_touches_no_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    eng = Engine(ServeConfig(buckets=(16,), emit_records=False), device="cpu")
    eng.submit(HeatConfig(n=8, ntime=4))
    eng.results()
    assert eng.solvecache is None and eng.summary()["cache"] is None
    assert list(tmp_path.iterdir()) == []
