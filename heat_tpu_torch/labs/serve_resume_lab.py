"""Zero-downtime serving A/B: a kill at 50% then ``resume_engine``, against
an uninterrupted drain (the port of the JAX package's serve resume lab).

The serve lab's population runs twice:

- **golden**: one engine drains the wave, an npz per request;
- **killed + resumed**: the same wave with engine checkpoints every 25
  boundaries. The kill is simulated at the generation nearest 50% of the
  wave's boundaries by deleting every newer generation and every result
  file the surviving manifest does not list as done (what a SIGKILL there
  leaves). A second engine resumes from the survivor and drains the rest.

Gates: every npz (done before the cut, or published by the resumed
engine) byte-identical to the golden file, compared as file bytes; per
resumed request, chunks and steps (the usage stamps are cumulative across
both incarnations) equal the golden run's; the survivor accounts for the
whole wave and every resumed request finishes ok. The recovery overhead
is the resume call's own wall.

    python -m heat_tpu_torch.labs.serve_resume_lab [--requests 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

from ._util import (ARTIFACTS, BUCKETS, build_requests, init_device, stamp,
                    write_atomic)

CKPT_INTERVAL = 25   # boundaries between generations


def make_engine(out: Path, ckpt_dir: Path, lanes, chunk, depth, device,
                interval: int = 0):
    from ..serve import Engine, ServeConfig

    return Engine(ServeConfig(
        lanes=lanes, chunk=chunk, buckets=BUCKETS, dispatch_depth=depth,
        emit_records=False, out_dir=str(out), engine_ckpt_interval=interval,
        engine_ckpt_dir=str(ckpt_dir)), device=device)


def run_wave(eng, reqs):
    for i, cfg in enumerate(reqs):
        eng.submit(cfg, request_id=f"r{i:03d}")
    t0 = time.perf_counter()
    records = eng.results()
    return time.perf_counter() - t0, {r["id"]: r for r in records}


def simulate_kill_at_half(ckdir: Path, outdir: Path):
    """Delete every generation newer than the one nearest 50% of the
    wave's boundaries, and every npz the survivor does not list as done."""
    gens = {}
    for p in sorted(ckdir.glob("engine_gen*.json")):
        man = json.loads(p.read_text())
        gens[int(man["generation"])] = man
    final_boundaries = max(m["boundaries"] for m in gens.values())
    cut = min(gens, key=lambda g: abs(gens[g]["boundaries"]
                                      - final_boundaries / 2))
    for p in list(ckdir.glob("engine_gen*")):
        if int(re.search(r"gen(\d+)", p.name).group(1)) > cut:
            p.unlink()
    done = set(gens[cut]["done"])
    for p in list(outdir.glob("*.npz")):
        if p.stem not in done:
            p.unlink()
    return gens[cut], final_boundaries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh one, removed after)")
    ap.add_argument("--out", default=str(ARTIFACTS / "serve_resume_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the engines run (default cuda)")
    args = ap.parse_args(argv)

    from ..backends import resolve_device
    from ..serve.resume import resume_engine

    device = resolve_device(args.device)
    setup_s = init_device(device)
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="resume_lab_"))
    reqs = build_requests(args.requests)
    conf = (args.lanes, args.chunk, args.depth, device)
    try:
        golden_wall, golden = run_wave(
            make_engine(workdir / "golden", workdir / "golden-ckpt", *conf),
            reqs)
        ckdir = workdir / "killed-ckpt"
        killed_wall, _ = run_wave(
            make_engine(workdir / "killed", ckdir, *conf,
                        interval=CKPT_INTERVAL), reqs)
        survivor, final_boundaries = simulate_kill_at_half(
            ckdir, workdir / "killed")

        resumed_eng = make_engine(workdir / "resumed", ckdir, *conf,
                                  interval=CKPT_INTERVAL)
        t0 = time.perf_counter()
        skip = resume_engine(resumed_eng, ckdir)
        recovery_s = time.perf_counter() - t0
        resume_wall, resumed = run_wave(resumed_eng, [])

        all_ids = [f"r{i:03d}" for i in range(args.requests)]
        recovered_all = set(skip) == set(all_ids)
        resumed_ok = all(r["status"] == "ok" for r in resumed.values())

        # file bytes over the merged result set: done before the cut in
        # killed/, the rest published by the resumed engine
        identical = []
        for rid in all_ids:
            a = workdir / "golden" / f"{rid}.npz"
            b = workdir / "killed" / f"{rid}.npz"
            if not b.exists():
                b = workdir / "resumed" / f"{rid}.npz"
            identical.append(b.exists()
                             and a.read_bytes() == b.read_bytes())
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    bit_identical = all(identical)

    # no re-stepped chunk, no step billed twice
    resteps = []
    for rid, r in resumed.items():
        g = golden[rid]
        if (r["usage"]["chunks"] != g["usage"]["chunks"]
                or r["usage"]["steps"] != g["usage"]["steps"]):
            resteps.append({"id": rid,
                            "chunks": [g["usage"]["chunks"],
                                       r["usage"]["chunks"]],
                            "steps": [g["usage"]["steps"],
                                      r["usage"]["steps"]]})
    zero_resteps = not resteps and resumed_ok

    rec = {
        "bench": "serve_resume_lab",
        **stamp(device),
        "setup_s": round(setup_s, 3),
        "config": {"requests": args.requests, "lanes": args.lanes,
                   "chunk": args.chunk, "dispatch_depth": args.depth,
                   "ckpt_interval": CKPT_INTERVAL},
        "golden_wall_s": round(golden_wall, 3),
        "killed_wall_s": round(killed_wall, 3),
        "resume_wall_s": round(resume_wall, 3),
        "recovery_overhead_s": round(recovery_s, 4),
        "cut": {"generation": survivor["generation"],
                "boundaries": survivor["boundaries"],
                "of_total_boundaries": final_boundaries,
                "inflight": len(survivor["inflight"]),
                "queued": len(survivor["queued"]),
                "done": len(survivor["done"])},
        "resumed_requests": len(resumed),
        "resumed_bit_identical": bit_identical,
        "zero_resteps": zero_resteps,
        "restep_witnesses": resteps[:5],
        "resumed_requests_recovered": recovered_all,
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    passed = bit_identical and zero_resteps and recovered_all
    print(f"serve_resume_lab: {'OK' if passed else 'FAILED'} — killed at "
          f"gen {survivor['generation']} (boundary "
          f"{survivor['boundaries']}/{final_boundaries}), "
          f"{len(survivor['inflight'])} in-flight + "
          f"{len(survivor['queued'])} queued resumed in {recovery_s:.3f}s "
          f"overhead; {sum(identical)}/{len(identical)} npz byte-identical "
          f"on {device}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
