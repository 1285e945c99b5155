"""Lab benches for the port, run on the card: ``kernel_lab`` checks and times
the candidate stencil bodies (``ops/cuda_lab``) against the shipped kernels,
``tune_on_chip`` runs its stages in one process; the serve labs
(``serve_lab`` … ``serve_cache_lab``), ``lane_kernel_build_check`` and the
fleet labs write the records in ``artifacts/`` that ``python -m
heat_tpu_torch perfcheck`` re-validates; the ports of the measuring labs
of ``benchmarks/`` (``chip_check`` … ``sharded3d_check``, ``run_all``: the
five BASELINE configurations) write theirs beside them."""
