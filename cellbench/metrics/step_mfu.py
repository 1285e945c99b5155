"""``step_mfu`` (device, device trace): the algorithm's operations in the
profiled stretch (7 a cell-step over every owned cell-step) over what the
card's f32 peak does in the stretch's length, in percent, over the cards
of a world. It bounds every kernel's roofline share from above whatever
the kernels are named."""

OPS_PER_CELL_STEP = 7


def read(run):
    if run.peak is None:
        return None
    ops = seconds = 0.0
    for rank in run.ranks:
        s = rank["stretch"]
        if not s:
            continue
        ops += OPS_PER_CELL_STEP * s["point_steps"]
        seconds += s["seconds"]
    if seconds <= 0 or not ops:
        return None
    return 100.0 * ops / run.peak["f32_flop_per_s"] / seconds
