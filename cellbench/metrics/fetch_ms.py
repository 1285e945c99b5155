"""``fetch_ms`` (drive loop, the program's ``fetch`` span on the device
trace's clock): the median over the profiled stretch's solves of rank 0's
``heat.fetch`` span, in ms: the final field gathered and copied to the
host, and its sum where one is asked for."""

from cellbench.metrics.program_idle_ms import median_ms


def read(run):
    return median_ms(run, "fetch")
