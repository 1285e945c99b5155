"""``points_per_s`` (end to end, host clock): every owned grid-point
update the window completed, points times steps of each unit of work
summed over the shards, over the window's wall time. Warm-up passes and
halo margins are not counted."""


def read(run):
    if run.seconds <= 0 or not run.units:
        return None
    return sum(u["k"] * u["points"] for u in run.units) / run.seconds
