"""``exchange_ms`` (halo exchange, device trace and the program's
``comm.stats``): device time of the NCCL kernels in the profiled stretch
over the exchanges the communicator counted in it (one exchange: both
axes of one fused block), per card of the world."""

from cellbench.harness import trace


def read(run):
    busy = 0.0
    exchanges = 0
    for rank in run.ranks:
        s = rank["stretch"]
        if not s:
            continue
        busy += trace.busy_seconds(trace.kernels(s["device"], "nccl"))
        exchanges += s["counters"].get("exchanges", 0)
    if not exchanges or busy <= 0:
        return None
    return 1e3 * busy / exchanges
