from .stencil import (  # noqa: F401
    accum_dtype_for,
    ftcs_step_edges,
    ftcs_step_ghost,
    ftcs_step_periodic,
    laplacian_interior,
    pad_with_ghosts,
    run_steps,
)
