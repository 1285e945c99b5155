"""``program_idle_ms`` (drive loop, the program's spans on the device
trace's clock): the profiled stretch's device-idle time (no kernel running;
copies and fills count as idle, as in ``idle_share``) that lies inside
rank 0's ``upload``, ``warm``, ``solve`` and ``fetch`` spans, over the
stretch's units. The rest of the idle lies between the program's spans,
in its caller.

The program marks a span by two zero-width host events in the profiler's
timeline, ``heat.<span>>`` where it begins and ``heat.<span><`` where it
ends (``heat_tpu_torch/runtime/trace.py``). ``spans`` pairs them; the
drive loop's other readers import it."""

import statistics

from cellbench.harness import trace

PROGRAM = ("upload", "warm", "solve", "fetch")


def spans(host, name):
    """``[(start_s, end_s)]`` of span ``name``: its markers among the
    ``host`` operations paired in time order, an unpaired one left out."""
    opening, closing = f"heat.{name}>", f"heat.{name}<"
    out, open_at = [], []
    for n, s, _ in sorted(host, key=lambda e: e[1]):
        if n == opening:
            open_at.append(s)
        elif n == closing and open_at:
            out.append((open_at.pop(), s))
    return out


def median_ms(run, name):
    """The median length of rank 0's ``name`` spans in its stretch, in
    ms, or None where the stretch holds none."""
    s = run.ranks[0]["stretch"]
    lengths = [f - b for b, f in spans(s["host"], name)] if s else []
    return 1e3 * statistics.median(lengths) if lengths else None


def _merged(intervals):
    """The union of ``(start, end)`` intervals as disjoint ones, in order."""
    out = []
    for s, f in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], f)
        else:
            out.append([s, f])
    return out


def read(run):
    s = run.ranks[0]["stretch"]
    if not s or not s["units"]:
        return None
    inside = _merged(iv for name in PROGRAM for iv in spans(s["host"], name))
    if not inside:
        return None
    idle = trace.gaps(trace.kernels(s["device"]), s["seconds"])
    covered, j = 0.0, 0
    for a, b in idle:
        while j < len(inside) and inside[j][1] <= a:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < b:
            covered += min(b, inside[k][1]) - max(a, inside[k][0])
            k += 1
    return 1e3 * covered / s["units"]
