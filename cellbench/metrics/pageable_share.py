"""``pageable_share`` (drive loop, the program's transfer-path spans on
the device trace's clock): of the whole-field transfers in rank 0's
profiled stretch, the share that took the pageable path: the
``upload.pageable`` and ``fetch.pageable`` spans over all four path spans
(``upload.pinned``, ``upload.pageable``, ``fetch.pinned``,
``fetch.pageable``), each of which the program opens around the copy
itself, inside its ``upload`` or ``fetch`` span. None where the stretch
holds none (a program without these spans)."""

from cellbench.metrics.program_idle_ms import spans

PINNED = ("upload.pinned", "fetch.pinned")
PAGEABLE = ("upload.pageable", "fetch.pageable")


def read(run):
    s = run.ranks[0]["stretch"]
    if not s:
        return None
    count = {name: len(spans(s["host"], name)) for name in PINNED + PAGEABLE}
    total = sum(count.values())
    if not total:
        return None
    return sum(count[name] for name in PAGEABLE) / total
