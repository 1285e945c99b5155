"""Tracing-overhead A/B: the event ring must cost next to nothing (the port
of the JAX package's trace overhead lab).

The serve lab's wave through one engine configuration, three modes that
differ only in tracing (``runtime/trace.py``):

- ``off``: ``trace_buffer=0``, nothing recorded;
- ``flightrec``: the default flight recorder, the ring kept in memory;
- ``full``: the ring plus a ``--trace`` export written at drain.

Gate: full tracing within 2% of tracing off (best of ``--repeats`` walls a
mode, the modes round-robined inside each repeat, after one warm-up wave),
and a non-empty export.

    python -m heat_tpu_torch.labs.trace_overhead_lab [--repeats 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_requests, drain, init_device,
                    stamp, work, write_atomic)


def run_mode(reqs, lanes, chunk, depth, device, trace_buffer,
             trace_path=None):
    from ..serve import Engine, ServeConfig

    eng = Engine(ServeConfig(lanes=lanes, chunk=chunk, buckets=BUCKETS,
                             dispatch_depth=depth, emit_records=False,
                             trace_buffer=trace_buffer,
                             trace=str(trace_path) if trace_path else None),
                 device=device)
    wall, records = drain(eng, reqs)
    ok = sum(r["status"] == "ok" for r in records)
    return wall, ok, len(eng.tracer)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs per mode; the best wall is compared")
    ap.add_argument("--out", default=str(ARTIFACTS / "trace_overhead_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device)
    reqs = build_requests(args.requests)
    cells = work(reqs)
    modes = {}
    with tempfile.TemporaryDirectory(prefix="trace_lab_") as tmp:
        trace_file = Path(tmp) / "full.trace.json"
        # a warm-up wave pays the process's first launches for every mode
        run_mode(reqs, args.lanes, args.chunk, args.depth, device,
                 trace_buffer=0)
        plan = [("off", dict(trace_buffer=0)),
                ("flightrec", dict(trace_buffer=65536)),
                ("full", dict(trace_buffer=65536, trace_path=trace_file))]
        for _ in range(args.repeats):
            for name, kw in plan:
                wall, ok, events = run_mode(reqs, args.lanes, args.chunk,
                                            args.depth, device, **kw)
                m = modes.setdefault(name, {"walls": [], "ok": ok,
                                            "events": events})
                m["walls"].append(round(wall, 3))
                m["ok"] = min(m["ok"], ok)
                m["events"] = max(m["events"], events)
        trace_ok = trace_file.exists() and bool(
            json.loads(trace_file.read_text())["traceEvents"])

    for m in modes.values():
        m["wall_s"] = min(m["walls"])
        m["points_per_s"] = round(cells / m["wall_s"], 1)

    off, frec, full = modes["off"], modes["flightrec"], modes["full"]
    overhead_full = full["wall_s"] / off["wall_s"] - 1.0
    overhead_frec = frec["wall_s"] / off["wall_s"] - 1.0
    rec = {
        "bench": "trace_overhead_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "dispatch_depth": args.depth,
                   "repeats": args.repeats,
                   "buckets": list(BUCKETS), "dtype": "float64"},
        "work_cell_steps": cells,
        "off": off, "flightrec": frec, "full": full,
        "flightrec_overhead_frac": round(overhead_frec, 4),
        "full_overhead_frac": round(overhead_full, 4),
        "full_within_2pct_of_off": overhead_full <= 0.02,
        "trace_export_nonempty": trace_ok,
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (rec["full_within_2pct_of_off"] and trace_ok
              and all(m["ok"] == args.requests for m in modes.values())
              and full["events"] > 0 and off["events"] == 0)
    print(f"trace_overhead_lab: {'OK' if passed else 'FAILED'} — "
          f"off {off['wall_s']:.3f}s vs flight-recorder "
          f"{frec['wall_s']:.3f}s ({100 * overhead_frec:+.2f}%) vs full "
          f"--trace {full['wall_s']:.3f}s ({100 * overhead_full:+.2f}%); "
          f"{full['events']} event(s) recorded per full run on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
