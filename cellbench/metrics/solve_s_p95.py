"""``solve_s_p95`` (end to end, host clock): the 95th percentile over
every solve completed in the window of its wall, from the call with the
initial field on the host to the final field on the host."""

import statistics


def read(run):
    walls = [u["wall"] for u in run.units if u["kind"] == "solve"]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=100, method="inclusive")[94]
