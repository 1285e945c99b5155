"""The drive loop's pool of page-locked field buffers
(``heat_tpu_torch/backends/pinned.py``) and the transfers through it
(``backends/common.upload_field`` / ``fetch_field``), on the CPU: a pool
built with plain host tensors for ``device_type="cpu"`` runs the same
first-request, release, cap and fallback logic as the card's pool of
pinned buffers. The card's pinned copies themselves are in
``tests/test_torch_card.py``."""

import sys
import threading

import numpy as np
import pytest
import torch

from heat_tpu_torch import backends
from heat_tpu_torch.backends import common, pinned
from heat_tpu_torch.config import HeatConfig
from heat_tpu_torch.runtime import debug, trace

F32 = torch.float32
SIDE = 512                       # a 512² f32 field is pinned.MIN_BYTES
FIELD = SIDE * SIDE * 4


class Heap:
    """An allocator of plain host tensors that counts its calls, or
    refuses each as PyTorch's pinned allocator refuses, by raising."""

    def __init__(self, refuse: bool = False):
        self.calls, self.refuse = 0, refuse

    def alloc(self, shape, dtype):
        self.calls += 1
        if self.refuse:
            raise RuntimeError("CUDA error: out of memory")
        return torch.empty(shape, dtype=dtype)


def _pool(fields=4, heap=None):
    heap = heap or Heap()
    return pinned.PinnedPool(int(fields * FIELD), alloc=heap.alloc,
                             device_type="cpu"), heap


def _primed(fields=4, heap=None, shape=(SIDE, SIDE), uses=("fetch",)):
    """A pool whose first request of ``shape`` for each use is made."""
    pool, heap = _pool(fields, heap)
    for use in uses:
        assert pool.lend(use, shape, F32) is None
    return pool, heap


def _addr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def test_the_first_request_of_each_use_shape_and_dtype_is_declined():
    pool, heap = _pool()
    assert pool.lend("fetch", (SIDE, SIDE), F32) is None
    assert pool.lend("fetch", (SIDE, SIDE), F32) is not None
    # another use, another shape and another dtype are each new
    assert pool.lend("upload", (SIDE, SIDE), F32) is None
    assert pool.lend("fetch", (SIDE, SIDE + 8), F32) is None
    assert pool.lend("fetch", (SIDE, SIDE), torch.float64) is None
    assert heap.calls == 1 and pool.held_bytes == FIELD


def test_the_cap_is_never_exceeded():
    pool, _ = _primed(fields=3, uses=("fetch", "upload"))
    held = []
    for i in range(6):
        a = pool.lend("fetch", (SIDE, SIDE), F32)
        assert pool.held_bytes <= pool.cap_bytes
        if i < 3:
            held.append(a)
        else:
            assert a is None                   # three are held: no room
    held.pop()
    # a freed block is cached by the allocator: its bytes stay counted,
    # and it serves the next request of its size class, whatever the use
    assert pool.lend("upload", (SIDE, SIDE), F32) is not None
    assert pool.held_bytes == 3 * FIELD
    # a size class of its own does not fit beside three cached blocks
    pool.lend("fetch", (SIDE // 2, SIDE), F32)
    assert pool.lend("fetch", (SIDE // 2, SIDE), F32) is None


def test_the_cap_counts_each_block_at_the_allocator_s_size():
    assert pinned.block_bytes(FIELD) == FIELD
    assert pinned.block_bytes(FIELD + 1) == 2 * FIELD
    assert pinned.block_bytes(1) == 1
    shape = (SIDE + 1, SIDE)                   # rounded up to two fields
    pool, _ = _primed(fields=3, shape=shape)
    a = pool.lend("fetch", shape, F32)
    assert a.shape == shape and pool.held_bytes == 2 * FIELD
    assert pool.lend("fetch", shape, F32) is None
    del a
    assert pool.lend("fetch", shape, F32) is not None


def test_a_buffer_comes_back_only_when_every_view_is_gone():
    pool, _ = _primed(fields=1)
    a = pool.lend("fetch", (SIDE, SIDE), F32)
    view = a[1:, ::2]
    as_tensor = torch.from_numpy(a)
    del a
    assert pool.lend("fetch", (SIDE, SIDE), F32) is None
    del view
    assert pool.lend("fetch", (SIDE, SIDE), F32) is None
    del as_tensor
    assert pool.lend("fetch", (SIDE, SIDE), F32) is not None
    assert pool.held_bytes == FIELD


def test_a_held_result_is_never_lent_again_nor_written():
    pool, _ = _primed(fields=6)
    held = []
    for i in range(5):
        a = pool.lend("fetch", (SIDE, SIDE), F32)
        a[...] = i
        held.append(a)
    for _ in range(20):                        # lend and drop the sixth
        b = pool.lend("fetch", (SIDE, SIDE), F32)
        assert _addr(b) not in {_addr(h) for h in held}
        b[...] = -1
        del b
    for i, a in enumerate(held):
        assert (a == i).all()


def test_a_refused_allocation_gives_its_bytes_back():
    heap = Heap(refuse=True)
    pool, _ = _primed(heap=heap)
    assert pool.lend("fetch", (SIDE, SIDE), F32) is None
    assert heap.calls == 1 and pool.held_bytes == 0
    heap.refuse = False
    assert pool.lend("fetch", (SIDE, SIDE), F32) is not None
    assert pool.held_bytes == FIELD


def _fields(dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    return torch.rand(SIDE, SIDE, generator=g).to(dtype)


def test_fetch_takes_the_pool_and_falls_back():
    pool, _ = _pool(fields=2)
    x = _fields()
    a, p0 = common.fetch_field(x, pool)        # the first: pageable
    b, p1 = common.fetch_field(x, pool)
    c, p2 = common.fetch_field(x, pool)
    d, p3 = common.fetch_field(x, pool)        # two held: the pool is out
    assert (p0, p1, p2, p3) == (False, True, True, False)
    for got in (a, b, c, d):
        assert got.dtype == np.float32 and np.array_equal(got, x.numpy())
    # below the floor, a tensor on another device, and no tensor at all
    small = torch.ones(SIDE // 2, SIDE)
    assert small.numel() * 4 < pinned.MIN_BYTES
    assert not common.fetch_field(small, pool)[1]
    card_pool = pinned.PinnedPool(alloc=pool._alloc)
    assert not common.fetch_field(x, card_pool)[1]
    assert not common.fetch_field(x.numpy(), pool)[1]
    assert pool.tally == {"upload.pinned": 0, "upload.pageable": 0,
                          "fetch.pinned": 2, "fetch.pageable": 4}
    assert card_pool.tally["fetch.pageable"] == 1
    del b
    assert common.fetch_field(x, pool)[1]      # back after a release


def test_fetch_widens_bf16_to_the_same_bits_as_host_fetch():
    pool, _ = _primed()
    x = _fields(torch.bfloat16) * 3 - 1
    got, was_pinned = common.fetch_field(x, pool)
    want = common.host_fetch(x)
    assert was_pinned and got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
@pytest.mark.parametrize("layout", ["contiguous", "read-only", "strided"])
def test_upload_copies_the_array_exactly(dtype, layout):
    pool, _ = _pool(fields=32)
    rng = np.random.default_rng(7)
    arr = rng.random((SIDE + 3, 4 * SIDE)).astype(dtype)
    if layout == "read-only":
        arr.flags.writeable = False
    elif layout == "strided":
        arr = arr[:, ::2]
    assert not common.upload_field(arr, "cpu", pool)[1]    # the first
    T, was_pinned = common.upload_field(arr, "cpu", pool)
    assert was_pinned and pool.tally["upload.pinned"] == 1
    assert T.dtype == common._TORCH_DTYPES[arr.dtype]
    assert T.numpy().tobytes() == np.ascontiguousarray(arr).tobytes()
    # a copy: the caller's array and the staging buffer are not aliased
    assert not np.shares_memory(T.numpy(), arr)
    # the staging buffer is back: the next upload fits in the same block
    held = pool.held_bytes
    assert common.upload_field(arr, "cpu", pool)[1]
    assert pool.held_bytes == held


def test_upload_falls_back_below_the_floor_and_off_the_device():
    pool, heap = _pool()
    small = np.ones((8, 8), np.float32)
    big = np.ones((SIDE, SIDE), np.float32)
    for _ in range(2):
        assert not common.upload_field(small, "cpu", pool)[1]
        assert not common.upload_field(
            big, "cpu", pinned.PinnedPool(device_type="cuda"))[1]
        assert not common.upload_field(big.astype(np.int32), "cpu",
                                       pool)[1]
    assert pool.tally["upload.pageable"] == 4
    assert pool.held_bytes == 0 and heap.calls == 0


@pytest.fixture
def cpu_pool(monkeypatch):
    """The drive loop's pool replaced by one for the CPU."""
    pool, _ = _pool(fields=8)
    monkeypatch.setattr(pinned, "POOL", pool)
    return pool


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drive_through_the_pool_gives_the_pageable_path_s_bits(cpu_pool,
                                                                dtype):
    cfg = HeatConfig(n=SIDE, ntime=6, backend="cuda", dtype=dtype,
                     sigma=0.2)
    T0 = np.random.default_rng(5).random((SIDE, SIDE), dtype=np.float32)
    want = backends.solve(cfg, T0=T0, device="cpu")
    got = backends.solve(cfg, T0=T0, device="cpu")
    assert cpu_pool.tally == {"upload.pinned": 1, "upload.pageable": 1,
                              "fetch.pinned": 1, "fetch.pageable": 1}
    assert got.T.dtype == want.T.dtype == np.float32
    assert got.T.tobytes() == want.T.tobytes()
    assert got.T.tobytes() == common.host_fetch(got.T_dev).tobytes()


def test_drive_on_the_cpu_takes_the_pageable_path_unchanged():
    before = dict(pinned.TALLY)
    cfg = HeatConfig(n=SIDE, ntime=4, backend="cuda", sigma=0.2)
    T0 = np.random.default_rng(6).random((SIDE, SIDE), dtype=np.float32)
    for _ in range(2):
        res = backends.solve(cfg, T0=T0, device="cpu")
        assert res.T.tobytes() == common.host_fetch(res.T_dev).tobytes()
    after = pinned.TALLY
    assert after["upload.pageable"] - before["upload.pageable"] == 2
    assert after["fetch.pageable"] - before["fetch.pageable"] == 2
    assert after["upload.pinned"] == before["upload.pinned"]
    assert after["fetch.pinned"] == before["fetch.pinned"]
    assert pinned.POOL.held_bytes == 0


def test_results_held_across_solves_stay_as_they_were(cpu_pool):
    cfg = HeatConfig(n=SIDE, ntime=2, backend="cuda", sigma=0.2)
    rng = np.random.default_rng(8)
    kept = []
    for _ in range(10):
        res = backends.solve(cfg, T0=rng.random((SIDE, SIDE),
                                                dtype=np.float32),
                             device="cpu")
        kept.append((res.T, res.T.copy()))
        assert cpu_pool.held_bytes <= cpu_pool.cap_bytes
    # the first solve moves its fields pageable; from the second, each
    # fetch takes the block its upload staged in: 8 fields of room hold 8
    # results, and then both transfers fall back
    assert cpu_pool.tally == {"upload.pinned": 8, "upload.pageable": 2,
                              "fetch.pinned": 8, "fetch.pageable": 2}
    for got, snapshot in kept:
        assert np.array_equal(got, snapshot)


def test_the_spans_say_which_path_and_how_many_bytes(cpu_pool):
    tracer = trace.configure()
    try:
        cfg = HeatConfig(n=SIDE, ntime=2, backend="cuda", sigma=0.2)
        T0 = np.ones((SIDE, SIDE), np.float32)
        for _ in range(2):
            backends.solve(cfg, T0=T0, device="cpu")
        backends.solve(cfg.with_(n=32), T0=T0[:32, :32].copy(),
                       device="cpu")
        spans, paths = {}, {}
        for ev in tracer.to_chrome()["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            if ev["name"] in ("upload", "fetch"):
                spans.setdefault(ev["name"], []).append(ev["args"])
            elif ev["name"] in pinned.PATHS:
                use, _, path = ev["name"].partition(".")
                paths.setdefault(use, []).append(path)
    finally:
        trace.configure()
    # the bytes on the outer span, the path in the name of the one inside
    for name in ("upload", "fetch"):
        assert spans[name] == [{"bytes": FIELD}, {"bytes": FIELD},
                               {"bytes": 32 * 32 * 4}]
        assert paths[name] == ["pageable", "pinned", "pageable"]


def test_the_pool_s_lock_has_a_rank_of_its_own(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_LOCKCHECK", "1")
    debug.reset_lock_order_stats()
    try:
        pool, _ = _primed()
        # a leaf: taken under the highest rank of the serving stack
        with debug.make_lock("observatory:test"):
            a = pool.lend("fetch", (SIDE, SIDE), F32)
        stats = debug.lock_order_stats()
    finally:
        debug.reset_lock_order_stats()
    assert a is not None and stats["violations"] == []
    assert ("observatory:test", "pinned:pool") in stats["edges"]
    assert "writer" not in stats["taken"] and stats["taken"]["pinned"] >= 1


def test_lending_from_many_threads_keeps_the_cap_and_lends_once():
    pool, _ = _pool(fields=3)
    for shape in ((SIDE, SIDE), (SIDE // 2, SIDE)):
        pool.lend("fetch", shape, F32)
    out = set()
    guard = threading.Lock()
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            shape = (SIDE, SIDE) if rng.random() < 0.7 else (SIDE // 2, SIDE)
            a = pool.lend("fetch", shape, F32)
            if pool.held_bytes > pool.cap_bytes:
                errors.append(("over the cap", pool.held_bytes))
            if a is None:
                continue
            with guard:
                if _addr(a) in out:
                    errors.append("lent twice")
                out.add(_addr(a))
            a[0, 0] = seed
            with guard:
                out.discard(_addr(a))
            del a

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert pool.held_bytes <= pool.cap_bytes
    # every buffer came back: only one lent here may be counted
    a = pool.lend("fetch", (SIDE, SIDE), F32)
    assert sum(pool._lent.values()) == (a is not None)


GIB = 1 << 30


@pytest.mark.parametrize("memory,cap", [
    (0, GIB), (4 * GIB, GIB), (8 * GIB, GIB), (9 * GIB, 9 * GIB // 8),
    (96 * GIB, 12 * GIB), (2048 * GIB, 256 * GIB)])
def test_the_cap_is_a_share_of_the_host_s_memory(memory, cap):
    assert pinned.host_cap_bytes(memory) == cap


def test_the_cap_takes_the_smaller_of_the_host_and_its_cgroup(monkeypatch):
    monkeypatch.setattr(pinned.os, "sysconf",
                        {"SC_PAGE_SIZE": 4096,
                         "SC_PHYS_PAGES": 64 * GIB // 4096}.__getitem__)
    monkeypatch.setattr(pinned, "cgroup_limit_bytes", lambda: None)
    assert pinned.host_memory_bytes() == 64 * GIB
    assert pinned.host_cap_bytes() == 8 * GIB
    monkeypatch.setattr(pinned, "cgroup_limit_bytes", lambda: 24 * GIB)
    assert pinned.host_cap_bytes() == 3 * GIB
    monkeypatch.setattr(pinned, "cgroup_limit_bytes", lambda: 1 << 62)
    assert pinned.host_cap_bytes() == 8 * GIB
    assert pinned.POOL.cap_bytes == pinned.CAP_BYTES >= pinned.MIN_CAP_BYTES


def test_the_cgroup_limit_is_the_lowest_on_the_path(tmp_path):
    proc = tmp_path / "cgroup"
    # v2: the process's cgroup and its parent limited, the root not
    for d, text in (("", "max"), ("a", "8589934592"), ("a/b", "max\n")):
        (tmp_path / "v2" / d).mkdir(parents=True, exist_ok=True)
        (tmp_path / "v2" / d / "memory.max").write_text(text)
    proc.write_text("0::/a/b\n")
    assert pinned.cgroup_limit_bytes(str(proc), str(tmp_path / "v2")) == 8 * GIB
    # v1: the memory controller's own hierarchy; other controllers ignored
    (tmp_path / "v1" / "memory" / "jobs").mkdir(parents=True)
    (tmp_path / "v1" / "memory" / "memory.limit_in_bytes").write_text(
        str(1 << 62))
    (tmp_path / "v1" / "memory" / "jobs" / "memory.limit_in_bytes").write_text(
        str(3 * GIB))
    proc.write_text("5:cpu,cpuacct:/other\n4:memory:/jobs\n")
    assert pinned.cgroup_limit_bytes(str(proc), str(tmp_path / "v1")) == 3 * GIB
    # nothing set, nothing readable
    proc.write_text("4:memory:/gone\n")
    (tmp_path / "v1" / "memory" / "memory.limit_in_bytes").unlink()
    assert pinned.cgroup_limit_bytes(str(proc), str(tmp_path / "v1")) is None
    assert pinned.cgroup_limit_bytes(str(tmp_path / "none")) is None


# The benchmark's solves loop on the 512³ f32 deployment at 1/512 scale:
# 64³ f32 fields (1 MiB, the pool's floor, for 512 MiB), 4 distinct
# initial fields, set-up's solve, then 24 window solves, 3 results kept by
# the loop's reservoir draw. The card's host has 96 GiB.
CUBE = 64
CUBE_FIELD = CUBE ** 3 * 4
SCALE = (512 ** 3 * 4) // CUBE_FIELD


def _replay(cap_bytes, seed, window=24, keep=3):
    """The window's transfers by path and the most bytes the pool held."""
    import random

    pool = pinned.PinnedPool(cap_bytes, alloc=Heap().alloc, device_type="cpu")
    cfg = HeatConfig(n=CUBE, ndim=3, ntime=1, backend="cuda", sigma=1 / 6)
    rng = np.random.default_rng(seed)
    ics = [rng.random((CUBE,) * 3, dtype=np.float32) for _ in range(4)]
    old = pinned.POOL
    pinned.POOL = pool
    try:
        backends.solve(cfg, T0=ics[0], device="cpu")
        before = dict(pool.tally)
        draw = random.Random(f"{seed}:compare_sample")
        sample, held = [], 0
        for i in range(window):
            res = backends.solve(cfg, T0=ics[i % len(ics)], device="cpu")
            if len(sample) < keep:
                sample.append(res.T)
            else:
                slot = draw.randrange(i + 1)
                if slot < keep:
                    sample[slot] = res.T
            del res
            held = max(held, pool.held_bytes)
    finally:
        pinned.POOL = old
    return {k: v - before[k] for k, v in pool.tally.items()}, held


@pytest.mark.parametrize("seed", [2, 3, 5, 2147500001])
def test_every_window_transfer_of_the_cube_is_pinned(seed):
    cap = pinned.host_cap_bytes(96 * GIB) // SCALE
    paths, held = _replay(cap, seed)
    assert paths == {"upload.pinned": 24, "upload.pageable": 0,
                     "fetch.pinned": 24, "fetch.pageable": 0}
    # three results kept and one in flight
    assert held <= 4 * CUBE_FIELD


def test_a_cap_of_two_cube_fields_mixes_the_paths():
    """The fixed 1 GiB cap held two 512³ f32 fields: which window solves
    went pinned depended on the results the reservoir held."""
    pinned_solves = []
    for seed in (2, 3, 5, 2147500001):
        paths, held = _replay(2 * CUBE_FIELD, seed)
        assert held <= 2 * CUBE_FIELD
        assert paths["upload.pinned"] + paths["upload.pageable"] == 24
        assert 0 < paths["fetch.pinned"] < 24
        assert 0 < paths["upload.pageable"]
        pinned_solves.append(paths["fetch.pinned"])
    assert sum(pinned_solves) < 24 * 4 // 2
