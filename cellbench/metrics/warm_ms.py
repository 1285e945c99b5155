"""``warm_ms`` (drive loop, the program's ``warm`` span on the device
trace's clock): the median over the profiled stretch's solves of rank 0's
``heat.warm`` span, in ms: each chunk size's launches once on a copy of
the field, and their sync."""

from cellbench.metrics.program_idle_ms import median_ms


def read(run):
    return median_ms(run, "warm")
