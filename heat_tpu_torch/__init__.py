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
"""

from .backends import SolveResult, solve  # noqa: F401
from .config import VARIANTS, HeatConfig, parse_input, variant_config  # noqa: F401
from .grid import coords, initial_condition  # noqa: F401

__version__ = "0.1.0"
