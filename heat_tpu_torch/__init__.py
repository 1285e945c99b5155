"""heat_tpu_torch — the heat-equation framework on PyTorch and CUDA.

The port of ``heat_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, kept
beside it: the same ``input.dat`` contract, configs, initial conditions,
``.dat`` files and checkpoints, with backends

- ``serial``  numpy oracle
- ``torch``   plain PyTorch step (heat_tpu's ``xla``)
- ``cuda``    hand-written Hopper kernel (heat_tpu's ``pallas``)

Entry points run on the card unless the caller asks for the CPU
(``solve(cfg, device="cpu")``, ``--device cpu``). Nothing here imports JAX
or ``heat_tpu``.

The names below load their modules (and torch) on first use, so a module
that needs no torch, such as ``fleet.placement``, imports without it.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {"SolveResult": "backends", "solve": "backends",
            "VARIANTS": "config", "HeatConfig": "config",
            "parse_input": "config", "variant_config": "config",
            "coords": "grid", "initial_condition": "grid"}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value
