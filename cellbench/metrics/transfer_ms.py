"""``transfer_ms`` (drive loop, the program's transfer-path spans on the
device trace's clock): the time inside rank 0's four path spans
(``upload.pinned``, ``upload.pageable``, ``fetch.pinned``,
``fetch.pageable``: the copies of a whole field between the host and the
card, without the pool's choice of buffer around them) over the profiled
stretch's solves, in ms a solve. None where the stretch holds none (a
program without these spans)."""

from cellbench.metrics.pageable_share import PAGEABLE, PINNED
from cellbench.metrics.program_idle_ms import spans


def read(run):
    s = run.ranks[0]["stretch"]
    if not s or not s["units"]:
        return None
    found = [iv for name in PINNED + PAGEABLE for iv in spans(s["host"], name)]
    if not found:
        return None
    return 1e3 * sum(f - b for b, f in found) / s["units"]
