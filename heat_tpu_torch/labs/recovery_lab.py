"""Recovery overhead A/B: uninterrupted against crash-at-50% (the port of
the JAX package's recovery lab, ``benchmarks/recovery_lab.py``).

Two identical ``python -m heat_tpu_torch launch -n 2 --max-restarts 2``
sharded f64 solves on a 2x1 mesh, checkpointed every steps/8: one clean,
one with a worker crash injected at the halfway step (``--inject
crash@N/2:proc=1``). It records both walls, the recovery overhead
(absolute and as a fraction), the supervisor's restart records, and
whether the healed world's per-rank ``soln#####.dat`` files equal the
clean world's byte for byte. The two ranks share the device, so their
exchange goes through host memory (``--comm staged``, gloo); on the card
f64 steps with the plain torch step, as the reference's f64 takes XLA's.

    python -m heat_tpu_torch.labs.recovery_lab [--n 64] [--steps 32] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from ._util import ARTIFACTS, REPO, init_device, stamp, write_atomic


def _launch(workdir: Path, n: int, steps: int, ckpt_every: int,
            inject, device: str, timeout_s: int) -> dict:
    (workdir / "input.dat").write_text(f"{n} 0.25 0.05 2.0 {steps} 1\n")
    cmd = [sys.executable, "-m", "heat_tpu_torch", "launch", "-n", "2",
           "--max-restarts", "2", "--", "run", "--backend", "sharded",
           "--device", device, "--dtype", "float64", "--mesh", "2x1",
           "--comm", "staged", "--checkpoint-every", str(ckpt_every),
           "--async-io", "off"]
    if inject:
        cmd += ["--inject", inject]
    env = {**os.environ,
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "HEAT_TPU_RESTART_BACKOFF_S": "0.1"}
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True,
                       text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    restarts = [json.loads(line.split("launch: restart ", 1)[1])
                for line in p.stderr.splitlines()
                if line.startswith("launch: restart ")]
    return {"rc": p.returncode, "wall_s": round(wall, 3),
            "restarts": restarts,
            "stderr_tail": p.stderr[-1500:] if p.returncode else ""}


def _shard_bytes(workdir: Path) -> list:
    return [f.read_bytes() for f in sorted(workdir.glob("soln0*.dat"))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--timeout", type=int, default=600,
                    help="per-run subprocess timeout (s)")
    ap.add_argument("--out", default=str(ARTIFACTS / "recovery_lab.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the worlds run (default cuda)")
    args = ap.parse_args(argv)
    ckpt_every = max(2, args.steps // 8)
    crash_at = max(ckpt_every, args.steps // 2)

    from ..backends import resolve_device

    device = resolve_device(args.device)
    setup_s = init_device(device)
    with tempfile.TemporaryDirectory() as td:
        d_clean, d_chaos = Path(td) / "clean", Path(td) / "chaos"
        d_clean.mkdir()
        d_chaos.mkdir()
        clean = _launch(d_clean, args.n, args.steps, ckpt_every, None,
                        device.type, args.timeout)
        chaos = _launch(d_chaos, args.n, args.steps, ckpt_every,
                        f"crash@{crash_at}:proc=1", device.type, args.timeout)
        files = len(_shard_bytes(d_clean))
        bit_identical = (clean["rc"] == 0 and chaos["rc"] == 0 and files == 2
                         and _shard_bytes(d_clean) == _shard_bytes(d_chaos))

    overhead = (round(chaos["wall_s"] - clean["wall_s"], 3)
                if clean["rc"] == 0 and chaos["rc"] == 0 else None)
    rec = {
        "bench": "recovery_lab", **stamp(device), "setup_s": setup_s,
        "config": {"n": args.n, "steps": args.steps,
                   "checkpoint_every": ckpt_every, "crash_at": crash_at,
                   "processes": 2, "mesh": "2x1", "dtype": "float64",
                   "comm": "staged", "device": device.type},
        "uninterrupted": clean,
        "crash_resume": chaos,
        "recovery_overhead_s": overhead,
        "recovery_overhead_frac": (round(overhead / clean["wall_s"], 3)
                                   if overhead is not None
                                   and clean["wall_s"] > 0 else None),
        "bit_identical_final_field": bit_identical,
    }
    write_atomic(Path(args.out), rec)
    print(json.dumps(rec, indent=2))
    ok = (clean["rc"] == 0 and chaos["rc"] == 0 and bit_identical
          and len(chaos["restarts"]) >= 1)
    print(f"recovery_lab: {'OK' if ok else 'FAILED'} — "
          f"clean {clean['wall_s']}s vs crash-resume {chaos['wall_s']}s "
          f"({len(chaos['restarts'])} restart(s); "
          f"bit-identical={bit_identical})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
