"""``exchange_host_ms`` (halo exchange, the program's ``halo.*`` spans on
the device trace's clock): the median over rank 0's fused blocks in the
profiled stretch of the host's time in the exchange's spans inside one,
in ms: cutting the send slabs (``halo.pack``), enqueueing them
(``halo.post``), waiting for the receives (``halo.finish``) and the ghost
writes (``halo.unpack``), each axis's, counted once where they overlap."""

import statistics

from cellbench.harness import trace
from cellbench.metrics.program_idle_ms import spans

HALO = ("halo.pack", "halo.post", "halo.finish", "halo.unpack")


def read(run):
    s = run.ranks[0]["stretch"]
    if not s:
        return None
    blocks = spans(s["host"], "block")
    halo = [iv for name in HALO for iv in spans(s["host"], name)]
    if not blocks or not halo:
        return None
    per_block = [trace.union_seconds(("", max(a, b0), min(f, b1))
                                     for a, f in halo if a < b1 and f > b0)
                 for b0, b1 in blocks]
    return 1e3 * statistics.median(per_block)
