"""Do the serving lane kernels build for Hopper and launch? (the counterpart
of the JAX package's lane-kernel compile check, which compiles the lane
programs ahead of time for a TPU).

Builds ``ops/csrc/lanes2d.cu`` and ``lanes3d.cu`` with ``_build.NVCC_FLAGS``
(``sm_90a``), then, for each of the four serve-relevant variants of the
JAX check (the default 2D bucket at both kernel dtypes, the rollback
chunk, which reads its input stack and writes two fresh ones, a 4-step
tail-sized chunk, and 3D, which a chunk cuts into several passes), loads
every lane of a ``LaneEngine`` with a seeded field and launches one chunk
on the card. A variant compiles when its chunk launches its kernel, every
lane's countdown reaches 0 with its finite bit set, and the stack's bytes
equal the plain lane body's on the same inputs. Registers and spill bytes
of each kernel instance the chunk launches come from ptxas's report in
the build log.

Writes ``artifacts/lane_kernel_build_check.json`` with ``all_compile``;
exits 1 if a variant fails. It needs the card: ``--device cpu`` is refused.

    python -m heat_tpu_torch.labs.lane_kernel_build_check [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

from ._util import ARTIFACTS, stamp, write_atomic

# (tag, ndim, bucket, dtype, bc, lanes, chunk, donate): the JAX check's
# matrix; donate=False is the rollback (keep-input) chunk
VARIANTS = (
    ("2d_f32_ghost_L8_k16", 2, 256, "float32", "ghost", 8, 16, True),
    ("2d_bf16_edges_L8_k16", 2, 256, "bfloat16", "edges", 8, 16, True),
    ("2d_f32_edges_L8_k4_rollback", 2, 48, "float32", "edges", 8, 4, False),
    ("3d_f32_ghost_L4_k16", 3, 64, "float32", "ghost", 4, 16, True),
)
_MANGLED_DTYPE = {"float32": "f", "bfloat16": "13__nv_bfloat16"}


def instances(report, name: str, dtype: str, depths) -> dict:
    """The streamed instances of ``name`` at ``dtype`` and each pass depth
    in ``depths``: {"k=<depth>": {"function", "registers", "spill_stores",
    "spill_loads"}}."""
    out = {}
    for k in sorted(set(depths)):
        pat = re.compile(rf"{name}_stream_kernelI{_MANGLED_DTYPE[dtype]}"
                         rf"Li{k}EE")
        for fn, regs, st, ld in report:
            if pat.search(fn):
                out[f"k={k}"] = {"function": fn, "registers": regs,
                                 "spill_stores": st, "spill_loads": ld}
    return out


def launch_variant(ndim, bucket, dtype, bc, lanes, chunk, donate, device,
                   seed):
    """One chunk of a seeded stack (lane i of side ``bucket - 2i``) through
    the kernels and through the plain lane body; returns (launches by
    kernel, remaining steps and finite bits by lane, whether every lane's
    bytes equal the plain body's)."""
    import numpy as np
    import torch

    from ..ops import cuda_lanes
    from ..serve.engine import BucketKey, LaneEngine

    key = BucketKey(ndim, bucket, dtype, bc)
    sides = [bucket - 2 * lane for lane in range(lanes)]
    r = 0.2 if ndim == 2 else 0.15
    outs = {}
    for kernel in ("cuda", "torch"):
        eng = LaneEngine(key, lanes, chunk, kernel=kernel, device=device,
                         keep_input=not donate)
        rng = np.random.default_rng(seed)
        for lane, n in enumerate(sides):
            field = 1.0 + rng.random((n,) * ndim)
            eng.load_lane(lane, torch.from_numpy(field).to(device), r, chunk,
                          1.0)
        before = dict(cuda_lanes.launches)
        handle = eng.dispatch_chunk()
        boundary = eng.fetch_remaining(handle)
        launched = {k: v - before[k] for k, v in cuda_lanes.launches.items()}
        fields = [eng.extract_lane(lane, n) for lane, n in enumerate(sides)]
        outs[kernel] = (launched, boundary, fields)
    launched, boundary, got = outs["cuda"]
    same = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for a, b in zip(got, outs["torch"][2]))
    return launched, boundary[0].tolist(), boundary[1].tolist(), same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ARTIFACTS
                                         / "lane_kernel_build_check.json"))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default; the check refuses the CPU)")
    args = ap.parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("lane_kernel_build_check builds and launches the "
                         "lane kernels on the card; it has no CPU form")

    from ..backends import resolve_device
    from ..ops import _build, cuda_lanes

    device = resolve_device("cuda")
    builds = {}
    for name in ("lanes2d", "lanes3d"):
        t0 = time.perf_counter()
        try:
            _build.build(name)
            builds[name] = {"built": True,
                            "build_s": round(time.perf_counter() - t0, 3)}
        except RuntimeError as e:
            builds[name] = {"built": False, "error": str(e)[:2000]}
    rec = {"bench": "lane_kernel_build_check", **stamp(device),
           "ts": time.time(), "arch": "sm_90a",
           "nvcc_flags": list(_build.NVCC_FLAGS), "builds": builds,
           "variants": {}}
    ok = all(b["built"] for b in builds.values())
    for i, (tag, ndim, bucket, dtype, bc, lanes, chunk, donate) in \
            enumerate(VARIANTS):
        name = f"lanes{ndim}d"
        if not builds[name]["built"]:
            rec["variants"][tag] = {"compiles": False,
                                    "error": f"{name} did not build"}
            ok = False
            continue
        t0 = time.perf_counter()
        try:
            launched, remaining, finite, same = launch_variant(
                ndim, bucket, dtype, bc, lanes, chunk, donate, device,
                seed=i)
            depths = cuda_lanes.passes(ndim, chunk)
            compiles = (launched[name] == len(depths)
                        and all(v == 0 for v in remaining)
                        and all(v != 0 for v in finite) and same)
            row = {"compiles": compiles,
                   "launch_s": round(time.perf_counter() - t0, 3),
                   "launches": launched[name], "pass_depths": depths,
                   "remaining": remaining, "finite": finite,
                   "bytes_equal_plain": same,
                   "instances": instances(
                       _build.ptxas_report(_build.build_log(name)), name,
                       dtype, depths)}
        except Exception as e:  # noqa: BLE001 — a recorded verdict
            row = {"compiles": False,
                   "error": f"{type(e).__name__}: {str(e)[:300]}"}
        ok = ok and row["compiles"]
        rec["variants"][tag] = row
        print(f"{tag:32s} "
              + (f"{'OK' if row['compiles'] else 'FAILED'} "
                 f"{row['launches']} launch(es) of depths "
                 f"{row['pass_depths']}, bytes equal plain "
                 f"{row['bytes_equal_plain']}, "
                 + ", ".join(f"{k}: {v['registers']} registers, spills "
                             f"{v['spill_stores']}/{v['spill_loads']} B"
                             for k, v in row["instances"].items())
                 if "launches" in row else f"FAILED {row['error']}"),
              flush=True)
    rec["all_compile"] = ok
    write_atomic(Path(args.out), rec)
    print(json.dumps({"all_compile": ok, "out": str(args.out)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
