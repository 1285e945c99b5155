"""On the card, one traced run of the 1-card cell: the program's span
markers lie on the device trace's clock, so the card's host-to-device
copies fall inside its ``upload`` spans and its device-to-host copies
inside its ``fetch`` spans; and the markers put no event on the card's
rows, where a reader would count it as device work."""

import pytest

from cellbench.harness import cellrun, spec, trace
from cellbench.metrics.program_idle_ms import spans

pytestmark = pytest.mark.cuda


def _inside(device, prefix, intervals):
    """The share of the device time of the operations named ``prefix...``
    that lies inside ``intervals`` (disjoint)."""
    total = covered = 0.0
    for name, s, f in device:
        if not name.startswith(prefix):
            continue
        total += f - s
        covered += sum(max(0.0, min(f, b) - max(s, a)) for a, b in intervals)
    assert total > 0, f"no {prefix} in the stretch"
    return covered / total


def test_copies_lie_inside_their_spans(card):
    cell = spec.resolve("pycuda_4096.solves")
    ctx = cellrun.Ctx(cell=cell, seed=2 ** 31 + 23, seconds=5.0, trace=True,
                      device=card)
    loop = spec.loop(cell)
    state = loop.setup(ctx)
    trace.warm(card)
    win = loop.window(ctx, state)
    st = win["stretch"]
    s = st["stretch"].summary()
    assert not [n for n, _, _ in s["device"] if n.startswith("heat.")]
    uploads, fetches = spans(s["host"], "upload"), spans(s["host"], "fetch")
    assert len(uploads) == len(fetches) == st["units"]
    assert _inside(s["device"], "Memcpy HtoD", uploads) >= 0.95
    assert _inside(s["device"], "Memcpy DtoH", fetches) >= 0.95
