"""Program auditor: dispatch-level contracts for every program family — the
runtime tier of the invariant guard.

The AST suite (``heat-tpu-torch check``) checks what the *source text*
promises; this module checks what a *dispatch actually does*. The port has
no traced program to inspect (no jaxpr, no lowered module), so every
registered family is dispatched for real, at a small shape: on the card it
runs its hand kernels (``ftcs2d``, ``ftcs3d``, ``lanes2d``, ``lanes3d``),
with ``device="cpu"`` their plain versions. The families:

- the solo chunked advance (``backends/cuda.make_advance``: the fused
  passes over the edges ping-pong buffer), 2D, 2D wide, 3D, in f32, bf16
  and f64 (the torch step);
- the packed-lane chunk (``serve/engine.LaneEngine``): the stepping chunk,
  the tail, the rollback (keep-input) chunk, and the loader;
- the mega-lane (``MegaLaneEngine`` over ``backends/sharded.
  make_mega_machinery``'s shard body and boundary, two shards).

Four contract families, exposed as ``heat-tpu-torch audit``:

``program-sync``
    A family's dispatch makes no host sync. On the card it runs under
    ``torch.cuda.set_sync_debug_mode("error")``; everywhere, spies on
    ``host_fetch`` (both seams), ``Tensor.item``, ``.cpu``, ``.numpy``,
    ``.tolist`` and ``torch.cuda.synchronize`` count zero calls.
``program-aliasing``
    The double buffers (the packed stack and its spare, the solo edges
    ping-pong, the loader's stack) keep their storages across a dispatch
    (storage pointers, everywhere), and the packed families that run a
    hand kernel allocate no field-sized tensor per chunk (on the card, the
    caching allocator's ``allocated_bytes`` delta over the dispatch; the
    plain torch body of an f64 bucket allocates its intermediates, and a
    solo chunk of several passes its intermediate field, both reported
    in the family's ``alloc_bytes``, not gated). A rollback
    snapshot (``LaneEngine.snapshot_stack``,
    ``MegaLaneEngine.snapshot_state``) shares no storage with the state the
    next chunk leaves, and its restorable cells keep their bytes across
    that chunk (the mega exchange refills a held shard's margins, which a
    restore refills itself; its owned cells are the state).
``program-dtype``
    Every field a family writes keeps its storage dtype; a non-f64 family
    holds no f64 tensor and an f64 family carries f64; the boundary stats
    are f32 (int32 rows bitcast).
``launch-budget``
    The lane-kernel launch-key space a ``ServeConfig`` implies (bucket x
    tier x pass depth x dtype x kernel, every bucket/dtype/bc and the
    chunk and the tail) is enumerated through the engine's own seams
    (``lane_tier``, ``tail_size``, ``resolve_lane_kernel`` and the pass
    cut ``cuda_lanes.passes`` that ``lane_chunk`` launches by) and gated
    against the budget committed in ``analysis/digests/launches.json``
    (``--update-digests`` rewrites it). Every key, and every pass depth a
    family's dispatch takes, must be an instance ``_build`` compiles
    (``lanes2d`` 1..16, ``lanes3d`` 1..8, ``ftcs2d`` 1..32, ``ftcs3d``
    1..8); on the card each family launches each of its kernels. Mega keys
    stay outside the budget: admission, not the kernels' instances, bounds
    them.

The reference's ``program-digest`` (a canonical jaxpr per family) has no
counterpart: the port has no traced program to digest, and the kernels'
bytes are held to their plain versions on the card instead.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from .core import Violation

# contract id -> one-line doc
CONTRACTS: Dict[str, str] = {
    "program-sync": "a family's dispatch makes no host sync (sync debug "
                    "mode 'error' on the card; spies count zero fetches)",
    "program-aliasing": "double buffers swap without a fresh field-sized "
                        "allocation; rollback snapshots share no storage "
                        "with the next chunk's state and keep their bytes",
    "program-dtype": "fields keep their storage dtype; no f64 in a "
                     "non-f64 family, f64 in an f64 one; f32 stats",
    "launch-budget": "lane-kernel launch keys a ServeConfig implies, "
                     "gated against digests/launches.json; every key a "
                     "compiled instance; each family launches its kernels",
}
# the cheap tier: everything but the dtype sweep
FAST_CONTRACTS: Tuple[str, ...] = ("program-sync", "program-aliasing",
                                   "launch-budget")
# the fields of one launch key, in order (a new dimension is a budget
# change, reviewed through --update-digests)
LAUNCH_KEY_DIMS: Tuple[str, ...] = ("kernel", "ndim", "bucket", "dtype",
                                    "bc", "tier", "depth")

_FLOAT_DTYPES = ("float64", "float32", "bfloat16")


def compiled_depths() -> Dict[str, int]:
    """kernel -> the deepest pass ``_build`` compiles an instance of (every
    depth 1..that is one): the wrappers' launch limits."""
    from ..ops import cuda_lanes, cuda_stencil

    return {"lanes2d": cuda_lanes.KMAX_2D, "lanes3d": cuda_lanes.KMAX_3D,
            "ftcs2d": cuda_stencil._KMAX_2D, "ftcs3d": cuda_stencil._KMAX_3D}


# --- the program interface ---------------------------------------------------

class Program:
    """One built family, ready to dispatch. Subclasses fill:

    - ``dispatch()``: one chunk (the hot path the contracts watch);
    - ``finish()``: wait for the last dispatch (outside every watch);
    - ``held()``: name -> every tensor the family holds;
    - ``written()``: name -> the tensors the last dispatch left as state;
    - ``buffers()``: the double buffer's storage pointers (or None);
    - ``snapshot()``: a rollback snapshot as a list of tensors whose
      restorable cells ``restorable(snap)`` names (or None);
    - ``stats``: the last fetched boundary's f32 stats (or None);
    - ``pass_depths()``: (kernel, depth) of each launch its chunk
      makes on the card."""

    field_nbytes = 0
    stats = None

    def dispatch(self) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        pass

    def held(self) -> Dict[str, object]:
        return {}

    def written(self) -> Dict[str, object]:
        return {}

    def buffers(self) -> Optional[frozenset]:
        return None

    def snapshot(self) -> Optional[list]:
        return None

    def restorable(self, snap) -> list:
        return list(snap)

    def pass_depths(self) -> List[Tuple[str, int]]:
        return []


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One registered program family. ``build(device)`` returns a
    :class:`Program`; ``kernels`` are the hand kernels its dispatch
    launches on the card."""

    name: str
    build: Callable[[object], Program]
    family: str = "lane"            # solo | lane | loader | mega
    dtype: str = "float32"
    kernels: Tuple[str, ...] = ()
    steps: int = 0
    double_buffer: bool = False     # aliasing: the buffers only swap
    no_alloc: bool = False          # aliasing: no field-sized allocation
    rollback: bool = False          # aliasing: the snapshot contract


def _ptr(t) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(obj) -> list:
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    shards = getattr(obj, "shards", None)
    return _tensors(shards) if shards is not None else []


def _bits(t):
    """A tensor's bytes as an integer view (NaN-safe equality)."""
    import torch

    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    return t.contiguous().view(ints[t.element_size()])


def _field(shape, dtype: str, device, seed: int):
    """A deterministic smooth field in [0, 1] of ``dtype`` on ``device``."""
    import torch

    from ..utils.dtypes import torch_dtype

    g = torch.Generator().manual_seed(seed)
    T = torch.rand(shape, generator=g, dtype=torch.float64)
    return T.to(torch_dtype(dtype)).to(device)


# --- the families ------------------------------------------------------------

class _SoloProgram(Program):
    """``backends/cuda.make_advance`` on an edges field: the fused passes
    over its ping-pong buffer."""

    def __init__(self, device, ndim: int, n: int, dtype: str, k: int,
                 shape=None):
        from ..backends.cuda import make_advance
        from ..config import HeatConfig

        self.cfg = HeatConfig(n=n, ndim=ndim, ntime=4 * k, dtype=dtype,
                              bc="edges", sigma=0.2 if ndim == 2 else 0.15)
        self.k = k
        self.shape = tuple(shape or (n,) * ndim)
        self.advance, _ = make_advance(self.cfg)
        self.T = _field(self.shape, dtype, device, seed=11 * ndim + n)
        self.field_nbytes = self.T.numel() * self.T.element_size()
        # the storages the field has lived in: the first chunks allocate
        # the spare, after which the two only swap
        self._seen = {_ptr(self.T)}
        for _ in range(2):
            self.dispatch()

    def dispatch(self) -> None:
        self.T = self.advance(self.T, self.k)
        self._seen.add(_ptr(self.T))

    def finish(self) -> None:
        if self.T.device.type == "cuda":
            import torch

            torch.cuda.current_stream(self.T.device).synchronize()

    def held(self):
        return {"T": self.T}

    def written(self):
        return {"T": self.T}

    def buffers(self):
        return frozenset(self._seen)

    def pass_depths(self):
        from ..backends.cuda import fuse_depth
        from ..ops import pass_schedule
        from ..ops.cuda_stencil import kernel_available

        if not kernel_available(self.shape, self.T.dtype):
            return []
        name = "ftcs2d" if len(self.shape) == 2 else "ftcs3d"
        # as make_advance cuts a chunk: fused calls of fuse_depth steps,
        # then one-step calls, each cut into passes by the planner
        kf = fuse_depth(self.cfg)
        n_fused, rem = divmod(self.k, kf) if kf > 1 else (0, self.k)
        calls = [kf] * n_fused + [1] * rem
        return [(name, d) for c in calls
                for d in pass_schedule.passes(self.shape, self.T.dtype, c)]


class _LaneProgram(Program):
    """``serve/engine.LaneEngine``: a packed stack of ``lanes`` lanes, every
    lane loaded, one chunk per dispatch (``k`` steps: the chunk or the
    tail); ``keep_input`` is the rollback engine."""

    def __init__(self, device, ndim: int, side: int, dtype: str, lanes: int,
                 chunk: int, k: int, kernel: str, keep_input: bool = False,
                 loader: bool = False):
        from ..serve.engine import BucketKey, LaneEngine

        self.key = BucketKey(ndim, side, dtype, "edges")
        self.k = k
        self.loader = loader
        self.eng = LaneEngine(self.key, lanes, chunk, kernel=kernel,
                              device=device, keep_input=keep_input)
        n = side - 2
        self.n = n
        r = 0.2 if ndim == 2 else 0.15
        self._fields = [_field((n,) * ndim, dtype, self.eng.device,
                               seed=100 + lane) for lane in range(lanes)]
        for lane, T in enumerate(self._fields):
            self.eng.load_lane(lane, T, r, 1000, 0.0)
        stack = self.eng._fields
        self.field_nbytes = stack.numel() * stack.element_size()
        # one chunk before the watch: the spare's first use
        self._handle = self.eng.dispatch_chunk(self.k)
        self.finish()

    def dispatch(self) -> None:
        if self.loader:
            self.eng.load_lane(0, self._fields[0], 0.2, 1000, 0.0)
            self._handle = None
            return
        self._handle = self.eng.dispatch_chunk(self.k)

    def finish(self) -> None:
        from ..serve.engine import unpack_boundary

        if self._handle is not None:
            b = self.eng.fetch_remaining(self._handle)
            self.stats = unpack_boundary(b)
            self._handle = None
        elif self.eng.device.type == "cuda":
            import torch

            torch.cuda.current_stream(self.eng.device).synchronize()

    def held(self):
        e = self.eng
        return {"fields": e._fields, "spare": e._spare, "r": e._r,
                "n": e._n, "remaining": e._rem}

    def written(self):
        return {"fields": self.eng._fields, "remaining": self.eng._rem}

    def buffers(self):
        e = self.eng
        return frozenset(_ptr(t) for t in (e._fields, e._spare)
                         if t is not None)

    def snapshot(self):
        return [self.eng.snapshot_stack()] if self.eng.keep_input else None

    def pass_depths(self):
        from ..ops import cuda_lanes

        if self.loader or self.eng.kernel != "cuda":
            return []
        name = cuda_lanes._KERNELS[self.key.ndim]
        return [(name, d) for d in cuda_lanes.passes(self.key.ndim, self.k)]


class _MegaProgram(Program):
    """``serve/engine.MegaLaneEngine`` over ``nshards`` shards of one
    request: the sharded padded-carry advance and its boundary."""

    def __init__(self, device, ndim: int, n: int, dtype: str, k: int,
                 nshards: int = 2):
        from ..config import HeatConfig
        from ..serve.engine import MegaLaneEngine

        self.cfg = HeatConfig(n=n, ndim=ndim, ntime=1000, dtype=dtype,
                              bc="edges", ic="hat_half",
                              sigma=0.2 if ndim == 2 else 0.15)
        self.k = k
        self.eng = MegaLaneEngine(self.cfg, nshards, k, device=device)
        self._handle = self.eng.dispatch_chunk(k)
        self.finish()

    def dispatch(self) -> None:
        self._handle = self.eng.dispatch_chunk(self.k)

    def finish(self) -> None:
        from ..serve.engine import fetch_boundary, unpack_boundary

        if self._handle is not None:
            self.stats = unpack_boundary(fetch_boundary(self._handle))
            self._handle = None

    def held(self):
        return {"shards": list(self.eng._F.shards),
                "remaining": self.eng._rem}

    def written(self):
        return {"shards": list(self.eng._F.shards)}

    def snapshot(self):
        return list(self.eng.snapshot_state().shards)

    def restorable(self, snap):
        m = self.eng.kf
        ctr = (slice(m, -m),) * self.cfg.ndim
        return [s[ctr] for s in snap]

    def pass_depths(self):
        from ..ops import pass_schedule
        from ..utils.dtypes import torch_dtype

        if self.eng.kernel != "cuda":
            return []
        name = "ftcs2d" if self.cfg.ndim == 2 else "ftcs3d"
        kf = self.eng.kf
        shape = tuple(s.shape for s in self.eng._F.shards)[0]
        blocks = []
        if self.k > 1:
            nf, r_ = divmod(self.k - 1, kf)
            blocks = [kf] * nf + ([r_] if r_ else [])
        blocks.append(1)
        out = []
        for b in blocks:
            plan = pass_schedule.passes(shape, torch_dtype(self.cfg.dtype),
                                        b) or [b]
            out += [(name, d) for d in plan]
        return out


def _lane_kernel(device, dtype: str) -> str:
    """The body the engine runs for a bucket on ``device``: the kernels on
    the card (f32/bf16), the plain version elsewhere."""
    import torch

    if dtype == "float64" or torch.device(device).type != "cuda":
        return "torch"
    return "cuda"


def iter_program_specs() -> List[ProgramSpec]:
    """Every registered family (building them is deferred to ``build``)."""
    specs: List[ProgramSpec] = []
    for nd, n, dt, k, shape, tag in (
            (2, 64, "float32", 16, None, ""),
            (2, 64, "bfloat16", 16, None, ""),
            (2, 64, "float64", 16, None, ""),
            (2, 512, "float32", 16, (64, 2048), "-wide"),
            (3, 24, "float32", 16, None, ""),
            (3, 24, "bfloat16", 16, None, "")):
        # f64 has no kernel: the plain torch step, a fresh tensor a step
        f64 = dt == "float64"
        specs.append(ProgramSpec(
            f"solo/{nd}d/{dt}{tag}",
            lambda dev, nd=nd, n=n, dt=dt, k=k, shape=shape: _SoloProgram(
                dev, nd, n, dt, k, shape),
            family="solo", dtype=dt, kernels=() if f64 else (f"ftcs{nd}d",),
            steps=k, double_buffer=not f64))
    for nd, side, dt, lanes, chunk, k, mode in (
            (2, 34, "float32", 4, 16, 16, "chunk"),
            (2, 34, "float32", 4, 16, 4, "tail"),
            (2, 34, "bfloat16", 4, 16, 16, "chunk"),
            (2, 34, "float64", 2, 16, 16, "chunk"),
            (3, 18, "float32", 2, 8, 8, "chunk"),
            (3, 18, "bfloat16", 2, 8, 2, "tail"),
            (2, 34, "float32", 2, 16, 16, "rollback"),
            (3, 18, "bfloat16", 2, 8, 8, "rollback"),
            (2, 34, "float32", 4, 16, 16, "loader"),
            (3, 18, "bfloat16", 2, 8, 8, "loader")):
        fam = "loader" if mode == "loader" else "lane"
        kern = (() if dt == "float64" or mode == "loader"
                else (f"lanes{nd}d",))
        specs.append(ProgramSpec(
            f"{fam}/{nd}d/n{side}/{dt}/{mode}",
            lambda dev, nd=nd, side=side, dt=dt, lanes=lanes, chunk=chunk,
            k=k, mode=mode: _LaneProgram(
                dev, nd, side, dt, lanes, chunk, k, _lane_kernel(dev, dt),
                keep_input=mode == "rollback", loader=mode == "loader"),
            family=fam, dtype=dt, kernels=kern, steps=k,
            double_buffer=mode in ("chunk", "tail", "loader"),
            no_alloc=(mode == "loader" or bool(kern)) and mode != "rollback",
            rollback=mode == "rollback"))
    for nd, n, dt, k in ((2, 48, "float32", 8), (2, 48, "bfloat16", 8),
                         (3, 16, "float32", 4)):
        specs.append(ProgramSpec(
            f"mega/{nd}d/n{n}/{dt}",
            lambda dev, nd=nd, n=n, dt=dt, k=k: _MegaProgram(
                dev, nd, n, dt, k),
            family="mega", dtype=dt, kernels=(f"ftcs{nd}d",), steps=k,
            rollback=True))
    return specs


# --- watching one dispatch ---------------------------------------------------

def _launch_counts() -> Dict[str, int]:
    from ..ops import cuda_lanes, cuda_stencil

    return {**cuda_stencil.launches, **cuda_lanes.launches}


@contextlib.contextmanager
def sync_spies(device):
    """Count every host-sync entry point called inside the block; on the
    card, also run it under ``set_sync_debug_mode("error")`` (a sync the
    spies cannot see raises)."""
    import torch

    from ..backends import common
    from ..serve import engine as engine_mod

    counts: collections.Counter = collections.Counter()
    patched = []

    def spy(owner, attr, label):
        orig = getattr(owner, attr)

        def wrapped(*a, **kw):
            counts[label] += 1
            return orig(*a, **kw)

        setattr(owner, attr, wrapped)
        patched.append((owner, attr, orig))

    for attr in ("item", "cpu", "numpy", "tolist"):
        spy(torch.Tensor, attr, f"Tensor.{attr}")
    spy(engine_mod, "host_fetch", "serve.engine.host_fetch")
    spy(common, "host_fetch", "backends.common.host_fetch")
    spy(torch.cuda, "synchronize", "torch.cuda.synchronize")
    on_card = torch.device(device).type == "cuda"
    prev = torch.cuda.get_sync_debug_mode() if on_card else None
    try:
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        yield counts
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(prev)
        for owner, attr, orig in reversed(patched):
            setattr(owner, attr, orig)


def _allocated_bytes(device) -> Optional[int]:
    import torch

    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.memory_stats(device).get(
        "allocated_bytes.all.allocated", 0))


def observe(spec: ProgramSpec, device) -> dict:
    """Build ``spec`` on ``device`` and watch one dispatch (and, for a
    rollback family, the chunk after a snapshot): sync calls, allocation,
    storage, dtypes, launches. The contracts judge the returned dict."""
    prog = spec.build(device)
    obs: dict = {"name": spec.name, "sync_error": None}
    snap = prog.snapshot() if spec.rollback else None
    snap_bits = ([_bits(t).clone() for t in prog.restorable(snap)]
                 if snap is not None else None)
    before_buffers = prog.buffers()
    launches0 = _launch_counts()
    alloc0 = _allocated_bytes(device)
    try:
        with sync_spies(device) as counts:
            prog.dispatch()
    except RuntimeError as e:   # the sync debug mode's error
        obs["sync_error"] = f"{type(e).__name__}: {e}"
        counts = collections.Counter()
    alloc1 = _allocated_bytes(device)
    launches1 = _launch_counts()
    prog.finish()
    obs["sync_calls"] = dict(counts)
    obs["alloc_bytes"] = (None if alloc0 is None else alloc1 - alloc0)
    obs["field_nbytes"] = prog.field_nbytes
    obs["buffers_before"] = before_buffers
    obs["buffers_after"] = prog.buffers()
    obs["launches"] = {k: launches1[k] - launches0.get(k, 0)
                       for k in launches1 if launches1[k] != launches0.get(
                           k, 0)}
    obs["pass_depths"] = prog.pass_depths()
    obs["held"] = {k: [str(t.dtype).replace("torch.", "")
                       for t in _tensors(v)]
                   for k, v in prog.held().items()}
    obs["written"] = {k: [str(t.dtype).replace("torch.", "")
                          for t in _tensors(v)]
                      for k, v in prog.written().items()}
    obs["stats_dtype"] = (None if prog.stats is None
                          else str(prog.stats.dtype))
    if snap is not None:
        after = {_ptr(t) for t in _tensors(list(prog.written().values()))}
        obs["snapshot_shared"] = sorted(
            {_ptr(t) for t in snap} & after)
        obs["snapshot_changed"] = [
            i for i, (t, b) in enumerate(zip(prog.restorable(snap),
                                             snap_bits))
            if not bool((_bits(t) == b).all())]
    return obs


# --- the contract checkers ---------------------------------------------------
# Each takes (spec, observation) and returns Violations with the family
# name as the path, so seeded fixtures exercise them without the registry.

def check_sync(spec: ProgramSpec, obs: dict) -> List[Violation]:
    loc = f"<{spec.name}>"
    out = []
    if obs.get("sync_error"):
        out.append(Violation(
            "program-sync", loc, 0,
            f"the dispatch synchronized with the host under "
            f"set_sync_debug_mode('error'): {obs['sync_error']} — a fence "
            f"per chunk re-serializes the pipeline"))
    calls = {k: v for k, v in obs.get("sync_calls", {}).items() if v}
    if calls:
        out.append(Violation(
            "program-sync", loc, 0,
            f"the dispatch called host-sync entry points {calls} — the "
            f"only sanctioned D2H is the boundary fetch after the "
            f"dispatch (hot-path-purity's runtime complement)"))
    return out


def check_aliasing(spec: ProgramSpec, obs: dict) -> List[Violation]:
    loc = f"<{spec.name}>"
    out = []
    if spec.double_buffer:
        before, after = obs.get("buffers_before"), obs.get("buffers_after")
        if before is not None and after is not None and before != after:
            out.append(Violation(
                "program-aliasing", loc, 0,
                f"the double buffer changed storage across one dispatch "
                f"({len(before)} -> {len(after)} buffers, "
                f"{len(after - before)} new) — a fresh field-sized tensor "
                f"per chunk instead of a swap"))
    if spec.no_alloc:
        grew = obs.get("alloc_bytes")
        if grew is not None and grew >= max(1, obs.get("field_nbytes", 0)):
            out.append(Violation(
                "program-aliasing", loc, 0,
                f"the dispatch allocated {grew} bytes on the card, at "
                f"least one field ({obs.get('field_nbytes')} bytes) — the "
                f"double buffer should swap, not allocate"))
    if spec.rollback:
        if obs.get("snapshot_shared"):
            out.append(Violation(
                "program-aliasing", loc, 0,
                f"the rollback snapshot shares storage with the state the "
                f"next chunk left ({len(obs['snapshot_shared'])} "
                f"tensor(s)) — a restore would read what the chunk wrote"))
        if obs.get("snapshot_changed"):
            out.append(Violation(
                "program-aliasing", loc, 0,
                f"the next chunk changed the rollback snapshot's "
                f"restorable cells (tensor(s) "
                f"{obs['snapshot_changed']}) — the snapshot is no longer "
                f"the verified boundary"))
    return out


def check_dtype(spec: ProgramSpec, obs: dict) -> List[Violation]:
    loc = f"<{spec.name}>"
    out = []
    floats = [d for ds in obs.get("held", {}).values() for d in ds
              if d in _FLOAT_DTYPES]
    for name, ds in obs.get("written", {}).items():
        bad = sorted({d for d in ds if d in _FLOAT_DTYPES
                      and name != "r" and d != spec.dtype})
        if bad:
            out.append(Violation(
                "program-dtype", loc, 0,
                f"written {name!r} is {bad}, not the storage dtype "
                f"{spec.dtype} — the field left its storage type"))
    if spec.dtype != "float64" and "float64" in floats:
        out.append(Violation(
            "program-dtype", loc, 0,
            f"silent f64 promotion: a {spec.dtype} family holds float64 "
            f"tensors ({obs.get('held')})"))
    if spec.dtype == "float64" and "float64" not in floats:
        out.append(Violation(
            "program-dtype", loc, 0,
            f"float64 family holds no float64 tensor ({obs.get('held')}) "
            f"— the storage dtype was lost"))
    sd = obs.get("stats_dtype")
    if sd is not None and sd != "float32":
        out.append(Violation(
            "program-dtype", loc, 0,
            f"boundary stats are {sd}, not float32"))
    return out


def launch_keys(scfg=None) -> set:
    """Every lane-kernel launch key a ``ServeConfig`` implies:
    ``LAUNCH_KEY_DIMS`` per launch of the chunk and the tail chunk in every
    bucket geometry, dtype, bc and lane tier, where the engine resolves
    the bucket to the lane kernels on the card."""
    from ..ops import cuda_lanes
    from ..serve.engine import (_BC_LO, BucketKey, lane_tier,
                                resolve_lane_kernel, tail_size)

    if scfg is None:
        from ..serve.scheduler import ServeConfig

        scfg = ServeConfig()
    tiers = sorted({lane_tier(i, scfg.lanes)
                    for i in range(1, scfg.lanes + 1)})
    ks = [scfg.chunk]
    tail = tail_size(scfg.chunk)
    if tail:
        ks.append(tail)
    keys = set()
    for ndim in (2, 3):
        for side in scfg.buckets:
            for dtype in sorted(_FLOAT_DTYPES):
                for bc in sorted(_BC_LO):
                    bk = BucketKey(ndim, side, dtype, bc)
                    kernel, _ = resolve_lane_kernel(scfg.lane_kernel, bk,
                                                    "cuda")
                    if kernel != "cuda":
                        continue
                    name = cuda_lanes._KERNELS[ndim]
                    for tier in tiers:
                        for k in ks:
                            for d in cuda_lanes.passes(ndim, k):
                                keys.add((name, ndim, side, dtype, bc, tier,
                                          d))
    return keys


def enumerate_launch_keys(scfg=None) -> Dict[str, int]:
    keys = launch_keys(scfg)
    by_kernel = collections.Counter(k[0] for k in keys)
    return {"total": len(keys), **{k: by_kernel[k]
                                   for k in sorted(by_kernel)}}


def check_launch_budget(registry: Optional[dict],
                        keys: Optional[set] = None,
                        key_dims: Tuple[str, ...] = LAUNCH_KEY_DIMS
                        ) -> List[Violation]:
    """Gate the launch-key space against the declared budget, and every
    key against the compiled instances. ``keys`` defaults to the live
    enumeration; tests pass fakes to seed violations."""
    from ..ops import _build

    loc = "analysis/digests/launches.json"
    keys = launch_keys() if keys is None else keys
    out: List[Violation] = []
    decl = (registry or {}).get("launch_budget")
    if not decl:
        out.append(Violation(
            "launch-budget", loc, 0,
            "no declared launch budget in the registry — run "
            "`heat-tpu-torch audit --update-digests` and commit it"))
    else:
        if list(key_dims) != list(decl.get("key_dims", [])):
            out.append(Violation(
                "launch-budget", loc, 0,
                f"launch-key dimensions changed: declared "
                f"{decl.get('key_dims')}, live {list(key_dims)} — a new "
                f"dimension multiplies the instances a config can launch; "
                f"if intentional, `heat-tpu-torch audit --update-digests` "
                f"and commit the reviewed budget"))
        if len(keys) > decl.get("max_launch_keys", 0):
            out.append(Violation(
                "launch-budget", loc, 0,
                f"enumerated launch-key space ({len(keys)}) exceeds the "
                f"declared budget ({decl.get('max_launch_keys')}) — if the "
                f"growth is intentional, `heat-tpu-torch audit "
                f"--update-digests` re-declares the budget"))
    depths = compiled_depths()
    for key in sorted(keys):
        name, depth = key[0], key[-1]
        if name not in _build.KERNELS or not 1 <= depth <= depths.get(
                name, 0):
            out.append(Violation(
                "launch-budget", loc, 0,
                f"launch key {key} is not an instance _build compiles "
                f"({name} depths 1..{depths.get(name)})"))
    return out


def check_family_launches(spec: ProgramSpec, obs: dict, device
                          ) -> List[Violation]:
    """A family's pass depths are compiled instances; on the card its
    dispatch launches each of its kernels."""
    import torch

    loc = f"<{spec.name}>"
    out = []
    depths = compiled_depths()
    for name, d in obs.get("pass_depths", []):
        if not 1 <= d <= depths.get(name, 0):
            out.append(Violation(
                "launch-budget", loc, 0,
                f"the dispatch cuts a {name} pass of depth {d}, not an "
                f"instance _build compiles (1..{depths.get(name)})"))
    if torch.device(device).type == "cuda":
        for k in spec.kernels:
            if not obs.get("launches", {}).get(k):
                out.append(Violation(
                    "launch-budget", loc, 0,
                    f"the dispatch launched no {k} on the card (launches "
                    f"{obs.get('launches')}) — the family fell back to its "
                    f"plain version"))
    return out


# --- registry ----------------------------------------------------------------

def default_registry_path() -> Path:
    return Path(__file__).resolve().parent / "digests" / "launches.json"


def load_registry(path) -> Optional[dict]:
    try:
        return json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None


def write_registry(path, enumerated: Dict[str, int]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "version": 1,
        "comment": "committed lane-kernel launch budget — regenerate with "
                   "`heat-tpu-torch audit --update-digests` and review "
                   "the diff (a new launch dimension or a larger key "
                   "space is reviewed with the code)",
        "launch_budget": {"key_dims": list(LAUNCH_KEY_DIMS),
                          "max_launch_keys": enumerated["total"],
                          "enumerated": dict(sorted(enumerated.items()))},
        "compiled": compiled_depths(),
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


# --- the audit entry point ---------------------------------------------------

def audit(device="cuda", registry_path=None, update_digests: bool = False,
          contracts=None, specs: Optional[List[ProgramSpec]] = None
          ) -> Tuple[List[Violation], dict]:
    """Dispatch every registered family on ``device`` (the card unless the
    caller names the CPU; raises without one), apply the selected contract
    families (default: all of ``CONTRACTS``), gate the launch budget
    against the committed registry (or rewrite it with
    ``update_digests``). Returns ``(violations, report)``."""
    import torch

    from ..backends import resolve_device

    dev = resolve_device(device)
    reg_path = Path(registry_path) if registry_path else (
        default_registry_path())
    selected = tuple(contracts) if contracts else tuple(CONTRACTS)
    unknown = [c for c in selected if c not in CONTRACTS]
    if unknown:
        raise ValueError(f"unknown contract families {unknown}; "
                         f"known: {sorted(CONTRACTS)}")
    specs = list(specs) if specs is not None else iter_program_specs()
    out: List[Violation] = []
    families: Dict[str, dict] = {}
    for spec in specs:
        try:
            obs = observe(spec, dev)
        except Exception as e:   # a family that cannot run is a finding
            out.append(Violation(
                "program-dispatch", f"<{spec.name}>", 0,
                f"family failed to build or dispatch: "
                f"{type(e).__name__}: {e}"))
            continue
        families[spec.name] = {"family": spec.family, "dtype": spec.dtype,
                               "kernels": list(spec.kernels),
                               "launches": obs["launches"],
                               "steps": spec.steps,
                               "alloc_bytes": obs["alloc_bytes"]}
        if "program-sync" in selected:
            out.extend(check_sync(spec, obs))
        if "program-aliasing" in selected:
            out.extend(check_aliasing(spec, obs))
        if "program-dtype" in selected:
            out.extend(check_dtype(spec, obs))
        if "launch-budget" in selected:
            out.extend(check_family_launches(spec, obs, dev))
    enum = enumerate_launch_keys() if (
        "launch-budget" in selected or update_digests) else None
    if update_digests:
        write_registry(reg_path, enum)
    registry = load_registry(reg_path)
    if "launch-budget" in selected:
        out.extend(check_launch_budget(registry))
    out.sort(key=lambda v: (v.path, v.line, v.rule, v.message))
    report = {
        "device": str(dev),
        "card": (torch.cuda.get_device_name(dev)
                 if dev.type == "cuda" else None),
        "families": len(specs),
        "dispatched": len(families),
        "contracts": list(selected),
        "registry": str(reg_path),
        "budget": {
            "declared": ((registry or {}).get("launch_budget") or {}
                         ).get("max_launch_keys"),
            "enumerated": enum,
        },
        "programs": families,
        "violations": len(out),
    }
    return out, report
