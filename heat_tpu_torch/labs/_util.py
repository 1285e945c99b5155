"""Shared pieces of the labs: the committed artifact directory, the atomic
JSON writer, the serve lab's request populations, the drain of one wave
through an engine, one solve in the benchmark mode, and the stamp every
artifact carries (platform, card, commit).

The populations are those of the JAX package's serve lab (sides 24/32/48,
two diffusivities, step counts that are chunk multiples), held here as the
port's own copy.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# the committed home of the labs' JSON records from the card, which
# ``python -m heat_tpu_torch perfcheck`` re-validates
ARTIFACTS = Path(__file__).resolve().parent / "artifacts"
# the lab buckets of every serve lab but the steady one
BUCKETS = (32, 48)


def write_atomic(out: Path, obj) -> None:
    """Temp file + rename, so a killed run leaves no truncated JSON."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp")
    tmp.write_text(json.dumps(obj, indent=2))
    os.replace(tmp, out)


def build_requests(count: int, dtype: str = "float64"):
    """The mixed-size population: three grid sides, two diffusivities,
    three step counts (chunk multiples, so no tail chunk), two ICs. It
    forces both lab buckets and admissions mid-flight."""
    from ..config import HeatConfig

    sides = (24, 32, 48)
    return [HeatConfig(n=sides[i % len(sides)], ntime=96 + 16 * (i % 3),
                       dtype=dtype, bc="edges",
                       ic=("hat", "hat_small")[i % 2],
                       nu=(0.05, 0.1)[(i // 3) % 2])
            for i in range(count)]


def build_oversized(dtype: str = "float64"):
    """Two requests bigger than every lab bucket: rejected (with the
    ``--mega-lanes`` hint) where mega-lanes are off, served as mega-lanes
    where they are on. Side 96 divides every balanced mesh of 2, 4 or 8
    shards."""
    from ..config import HeatConfig

    return [HeatConfig(n=96, ntime=32, dtype=dtype, bc="edges", ic="hat"),
            HeatConfig(n=96, ntime=16, dtype=dtype, bc="ghost",
                       ic="uniform")]


def init_device(device, kernels=()) -> float:
    """Set-up before any timed wall: the device's context (a process's
    first CUDA call pays it, whichever wall comes first) and, on the card,
    the libraries of ``kernels`` (``ops/_build``: built once per checkout,
    one ``nvcc`` each, in parallel, then loaded). Returns its seconds."""
    import torch

    t0 = time.perf_counter()
    device = torch.device(device)
    if device.type == "cuda":
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        if kernels:
            from ..ops import _build

            _build.build_all(kernels)
            for name in kernels:
                _build.load(name)
    return time.perf_counter() - t0


def bench_solve(cfg, device, **kw):
    """One solve of ``cfg`` on ``device`` in the benchmark mode (no final
    fetch; ``kw`` as ``backends.solve`` takes them, e.g.
    ``two_point_repeats``), its printing swallowed: (the SolveResult, the
    ``ftcs2d``/``ftcs3d`` launches it made, its warm-up and protocol
    included)."""
    import contextlib
    import io

    from ..backends import solve
    from ..ops import cuda_stencil

    before = dict(cuda_stencil.launches)
    with contextlib.redirect_stdout(io.StringIO()):
        res = solve(cfg, device=device, fetch=False, **kw)
    return res, {k: v - before[k] for k, v in cuda_stencil.launches.items()}


def work(cfgs) -> int:
    """Cell-steps of a population: sum of n^ndim * ntime."""
    return sum(cfg.points * cfg.ntime for cfg in cfgs)


def drain(eng, cfgs, submit=None):
    """Submit ``cfgs`` (through ``submit(eng, i, cfg)`` where given) and
    drain the engine; returns (wall_s, records in submit order)."""
    t0 = time.perf_counter()
    ids = [eng.submit(cfg) if submit is None else submit(eng, i, cfg)
           for i, cfg in enumerate(cfgs)]
    records = eng.results()
    wall = time.perf_counter() - t0
    by_id = {r["id"]: r for r in records}
    return wall, [by_id[i] for i in ids]


def counts(records) -> dict:
    """ok / rejected / failed counts of a wave's records."""
    return {"ok": sum(r["status"] == "ok" for r in records),
            "rejected": sum(r["status"] == "rejected" for r in records),
            "failed": sum(r["status"] not in ("ok", "rejected")
                          for r in records)}


def smi_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    return lines[0] if lines else None


def _commit() -> str | None:
    env = os.environ.get("HEAT_TPU_TORCH_COMMIT")
    if env:
        return env
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def source_sha256() -> str:
    """Digest of the package's sources (Python and CUDA), sorted by path:
    names the code a record was made with where no git checkout is."""
    pkg = REPO / "heat_tpu_torch"
    h = hashlib.sha256()
    for p in sorted(pkg.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh") and "_build" not in p.parts:
            h.update(str(p.relative_to(pkg)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def stamp(device) -> dict:
    """Where a record was made: ``platform`` (``cuda`` or ``cpu``), the
    card (``nvidia-smi``'s name and power limit; None on the CPU), the
    commit (``git rev-parse HEAD``, or ``$HEAT_TPU_TORCH_COMMIT`` where
    the tree has no git) and the sources' digest."""
    import torch

    dev = torch.device(device)
    card = None
    if dev.type == "cuda":
        card = {"name": torch.cuda.get_device_name(dev), "smi": smi_line()}
    return {"platform": dev.type, "card": card, "commit": _commit(),
            "source_sha256": source_sha256(),
            "torch": torch.__version__}
