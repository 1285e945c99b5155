"""What the benchmark takes from the program under test
(``heat_tpu_torch``): its configuration object, built from a cell's
configuration and mix, and its counters. Imported only where a run
drives the program."""

from __future__ import annotations

import dataclasses
from typing import Optional


def heat_config(config: dict, mix: dict, dtype: Optional[str] = None):
    """The program's ``HeatConfig``: the configuration's fields the config
    object has, then the mix's ``program`` options (backend, exchange,
    mesh), then ``dtype`` where a control asks for another precision."""
    from heat_tpu_torch.config import HeatConfig

    # ``ic`` is the benchmark's seeded field, handed over as T0, not the
    # program's preset of that name
    names = {f.name for f in dataclasses.fields(HeatConfig)} - {"ic"}
    kw = {k: v for k, v in config.items() if k in names}
    kw.update(mix.get("program", {}))
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    if dtype is not None:
        kw["dtype"] = dtype
    return HeatConfig(**kw)


def counters(comm=None) -> dict:
    """Kernel launches so far in this process (``cuda_stencil.launches``)
    and, with a communicator, its exchanges."""
    from heat_tpu_torch.ops import cuda_stencil

    out = {f"launches.{k}": int(v) for k, v in cuda_stencil.launches.items()}
    if comm is not None:
        out["exchanges"] = int(comm.stats["exchanges"])
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}
