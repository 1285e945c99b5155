"""Two-tier placement lab: mega-lanes co-scheduled with packed lanes (the port
of the JAX package's serve mega lab).

The claim: requests bigger than every bucket complete as mega-lanes over
every shard of the mesh, with no overflow rejection, npz payloads
byte-identical to a solo ``sharded`` solve, and without taxing the packed
tier: the packed lanes' aggregate rate while a mega-lane is resident stays
within 10% of a mega-free drain of the same small population, and within
10% of the committed ``artifacts/serve_lab.json`` engine rate.

The JAX lab fakes an 8-device CPU mesh. The port sets the mega shard
count through the scheduler's ``mega_device_count`` seam instead
(``--virtual 8``): the shards are ``sharded``'s local shards in this
process, and on the card they time-share the one card. Two engines, two
waves each, the second timed (warm on both sides):

- **baseline**: smalls only;
- **mega-resident**: the oversized requests first, then the smalls.

    python -m heat_tpu_torch.labs.serve_mega_lab [--requests 64] [--virtual 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_requests, drain, init_device,
                    stamp, work, write_atomic)

SERVE_LAB = ARTIFACTS / "serve_lab.json"


def _npz_payload(path):
    """(key -> (dtype, shape, bytes)) of one npz: the byte comparison that
    survives zip-member timestamps."""
    import numpy as np

    with np.load(path) as z:
        return {k: (str(z[k].dtype), z[k].shape, z[k].tobytes())
                for k in z.files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64,
                    help="small-request population size (serve_lab's mix)")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--virtual", type=int, default=8,
                    help="shards of the mega mesh (the mega_device_count "
                         "seam)")
    ap.add_argument("--waves", type=int, default=4,
                    help="small-population repeats per timed drain: the "
                         "10%% band is a steady-state claim, so the packed "
                         "work must dwarf the mega tier's admission cost")
    ap.add_argument("--oversized-side", type=int, default=96,
                    help="mega request grid side (> every bucket; must "
                         "divide the mesh axes)")
    ap.add_argument("--oversized-ntimes", default="32,16",
                    help="comma-separated step counts, one mega request "
                         "each")
    ap.add_argument("--out", default=str(ARTIFACTS / "serve_mega_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines and solves run (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..backends import resolve_device, solve
    from ..config import HeatConfig
    from ..serve import Engine, ServeConfig
    from ..serve import scheduler as sch

    device = resolve_device(args.device)
    setup_s = init_device(device)
    smalls = build_requests(args.requests)
    ntimes = [int(t) for t in str(args.oversized_ntimes).split(",") if t]
    big = [HeatConfig(n=args.oversized_side, ntime=t, dtype="float64",
                      bc=("edges", "ghost")[i % 2],
                      ic=("hat", "uniform")[i % 2])
           for i, t in enumerate(ntimes)]
    timed_smalls = smalls * max(1, args.waves)
    small_work = work(timed_smalls)
    mega_work = work(big)

    def make_engine(out_dir):
        # both engines write npz files, so the timed waves pay the same
        # writeback and the ratio isolates co-scheduling
        return Engine(ServeConfig(
            lanes=args.lanes, chunk=args.chunk, buckets=BUCKETS,
            dispatch_depth=args.depth, emit_records=False,
            out_dir=str(out_dir), keep_fields=True), device=device)

    out_root = Path(tempfile.mkdtemp(prefix="serve_mega_lab_"))
    # the mesh: every mega-lane spans --virtual shards of this device
    seam = sch.mega_device_count
    sch.mega_device_count = lambda _device: args.virtual
    try:
        base_eng = make_engine(out_root / "base")
        drain(base_eng, smalls)                       # warm wave
        base_wall, base_recs = drain(base_eng, timed_smalls)
        base_ok = sum(r["status"] == "ok" for r in base_recs)
        base_tput = small_work / base_wall

        mega_eng = make_engine(out_root / "mega")
        drain(mega_eng, big + smalls)                 # warm wave
        compiles_before = mega_eng.mega_compiles
        mega_wall, mixed_recs = drain(mega_eng, big + timed_smalls)
        mega_recs = mixed_recs[:len(big)]
        small_recs = mixed_recs[len(big):]
        mega_tput = small_work / mega_wall
        overflow_rejections = sum(
            1 for r in mixed_recs
            if r["status"] == "rejected"
            and "bucket-overflow" in str(r.get("error")))

        # the timed wave's mega npz payloads against a solo sharded solve
        # of each config on the same shards, through the same writer
        solo_dir = out_root / "solo"
        mega_identical = True
        for i, cfg in enumerate(big):
            T = solve(cfg.with_(backend="sharded"), device=device,
                      virtual_devices=args.virtual).T
            sch._write_result(solo_dir, f"solo-{i}", T, cfg)
            a = _npz_payload(out_root / "mega" / f"{mega_recs[i]['id']}.npz")
            b = _npz_payload(solo_dir / f"solo-{i}.npz")
            mega_identical = mega_identical and a == b
        s = mega_eng.summary()
    finally:
        sch.mega_device_count = seam
        shutil.rmtree(out_root, ignore_errors=True)
    # the co-scheduled packed lanes against the mega-free drain
    packed_identical = all(
        np.array_equal(r["T"], b["T"])
        for r, b in zip(small_recs, base_recs)
        if r["status"] == "ok" and b["status"] == "ok")

    ratio = mega_tput / base_tput if base_tput else None
    vs_serve_lab = None
    if SERVE_LAB.exists() and args.requests == 64:
        committed = json.loads(SERVE_LAB.read_text())
        committed_pts = (committed.get("engine") or {}).get("points_per_s")
        if committed_pts and committed.get("platform") == device.type:
            vs_serve_lab = mega_tput / committed_pts

    rec = {
        "bench": "serve_mega_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "dispatch_depth": args.depth,
                   "devices": args.virtual, "waves": args.waves,
                   "oversized_side": args.oversized_side,
                   "oversized_ntimes": ntimes,
                   "mega_lanes": s.get("mega_lanes"),
                   "mesh": "mega_device_count seam: the shards are local "
                           "shards in one process, time-sharing the "
                           "device"},
        "small_work_cell_steps": small_work,
        "mega_work_cell_steps": mega_work,
        "baseline": {"wall_s": round(base_wall, 3),
                     "packed_points_per_s": round(base_tput, 1),
                     "ok": base_ok},
        "mega_resident": {
            "wall_s": round(mega_wall, 3),
            "packed_points_per_s": round(mega_tput, 1),
            "ok": sum(r["status"] == "ok" for r in mixed_recs),
            "mega_statuses": sorted(r["status"] for r in mega_recs),
            "mega_placements": sorted(str(r.get("placement"))
                                      for r in mega_recs),
            "warm_mega_compiles": s.get("mega_compiles", 0)
                                  - compiles_before,
            "mega_chunks": s.get("mega_chunks"),
            "cost_model_placements": sorted(
                {e.get("placement") for e in s.get("cost_model") or []}),
        },
        "packed_throughput_ratio": round(ratio, 4) if ratio else None,
        "vs_serve_lab_engine": (round(vs_serve_lab, 4)
                                if vs_serve_lab else None),
        "mega_bit_identical": bool(mega_identical),
        "packed_bit_identical": bool(packed_identical),
        "zero_overflow_rejections": overflow_rejections == 0,
        "packed_within_10pct": bool(ratio is not None and ratio >= 0.9),
        "packed_within_10pct_of_serve_lab": (
            bool(vs_serve_lab >= 0.9) if vs_serve_lab is not None
            else None),
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = (rec["mega_bit_identical"]
              and rec["packed_bit_identical"]
              and rec["zero_overflow_rejections"]
              and all(st == "ok"
                      for st in rec["mega_resident"]["mega_statuses"])
              and all(p == "mega"
                      for p in rec["mega_resident"]["mega_placements"])
              and rec["mega_resident"]["warm_mega_compiles"] == 0
              and rec["packed_within_10pct"]
              and rec["packed_within_10pct_of_serve_lab"] is not False)
    print(f"serve_mega_lab: {'OK' if passed else 'FAILED'} — packed "
          f"{mega_tput:.3g} pts/s with a mega-lane resident vs "
          f"{base_tput:.3g} mega-free ({rec['packed_throughput_ratio']}x; "
          f"vs committed serve_lab {rec['vs_serve_lab_engine']}); "
          f"{len(big)} oversized served as mega-lanes over {args.virtual} "
          f"shards (bit-identical={rec['mega_bit_identical']}, "
          f"overflow rejections={overflow_rejections}) on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
