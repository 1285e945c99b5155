"""``idle_share`` (device, device trace): the share of the profiled
stretch in which no kernel ran on the card (copies and fills count as
idle: the SMs wait); in a world, the card that idled most."""

from cellbench.harness import trace


def read(run):
    shares = [1.0 - trace.union_seconds(trace.kernels(r["stretch"]["device"]))
              / r["stretch"]["seconds"]
              for r in run.ranks
              if r["stretch"] and r["stretch"]["seconds"] > 0]
    return max(shares) if shares else None
