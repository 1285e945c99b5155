"""``upload_ms`` (drive loop, the program's ``upload`` span on the device
trace's clock): the median over the profiled stretch's solves of rank 0's
``heat.upload`` span, in ms: the initial field reaching the card, the
host array's copy to the device and its cast, or the field built there."""

from cellbench.metrics.program_idle_ms import median_ms


def read(run):
    return median_ms(run, "upload")
