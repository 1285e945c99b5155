from .datfiles import (  # noqa: F401
    read_dat,
    write_dat,
    write_int_dat,
    write_soln,
    write_soln_blocks,
    write_soln_sharded,
)
