"""``ftcs3d_roofline`` (kernels, device trace): the least time the card
could take for the algorithm's work in the profiled stretch over the
device time of the kernels whose name holds ``ftcs3d``, in percent.

The work does not depend on how it is implemented (pass depth, tiling,
margins): 9 operations a cell-step (five adds of the six neighbours, the
product 6*T, the difference, the product by r, the add) over every owned
cell-step, and the owned field read once and written once per unit of
work (a solve). The least time is the larger of the operations over the
f32 peak and the bytes over the HBM peak of the card's row of
``peaks.json``, as ``ftcs2d_roofline`` takes it. Over the cards of a
world: the sums of both sides."""

from cellbench.harness import trace

OPS_PER_CELL_STEP = 9
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def read(run):
    if run.peak is None:
        return None
    least = busy = 0.0
    for rank in run.ranks:
        s = rank["stretch"]
        if not s:
            continue
        ops = OPS_PER_CELL_STEP * s["point_steps"]
        moved = 2 * ITEMSIZE[run.config["dtype"]] * s["unit_points"] * s["units"]
        least += max(ops / run.peak["f32_flop_per_s"],
                     moved / run.peak["hbm_byte_per_s"])
        busy += trace.busy_seconds(trace.kernels(s["device"], "ftcs3d"))
    if busy <= 0:
        return None
    return 100.0 * least / busy
