"""Lab benches for the port's kernels, run on the card: ``kernel_lab`` checks
and times the candidate stencil bodies (``ops/cuda_lab``) against the
shipped kernels, ``tune_on_chip`` runs its stages in one session."""
