"""``solve_overhead_ms`` (drive loop, the benchmark's span around
``backends.solve`` less the program's ``Timing.solve_s``): the upload of
the initial field, ``make_advance``, the warm launches and the final
fetch of one solve; the median over the window's solves."""

import statistics


def read(run):
    rest = [u["wall"] - u["solve_s"] for u in run.units if u["kind"] == "solve"]
    if not rest:
        return None
    return 1e3 * statistics.median(rest)
