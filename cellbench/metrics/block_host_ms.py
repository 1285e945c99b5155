"""``block_host_ms`` (backend and pass schedule, the program's ``block``
span on the device trace's clock): the median over rank 0's fused blocks
in the profiled stretch of the host's time in one, in ms: its halo
exchange and its kernels' dispatch (``backends/sharded.py``)."""

from cellbench.metrics.program_idle_ms import median_ms


def read(run):
    return median_ms(run, "block")
